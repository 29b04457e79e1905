"""Particles: storage, staggered field gather, Boris push (normalized units).

Counterpart of ``repro.pic.particles``.  Momentum u = γv (c = 1); charge q
and mass m in units of the electron's.  Fixed-capacity storage with an
``alive`` mask.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .fields import Fields
from .grid import Grid2D
from .shapes import shape_weights

__all__ = [
    "Particles",
    "gather_fields",
    "boris_push",
    "advance_positions",
    "kinetic_energy",
]


class Particles(NamedTuple):
    """One species' particles (fixed capacity)."""

    z: torch.Tensor  # (N,) position along z
    x: torch.Tensor  # (N,) position along x
    ux: torch.Tensor  # (N,) γ vx
    uy: torch.Tensor
    uz: torch.Tensor
    w: torch.Tensor  # (N,) macro-particle weight
    alive: torch.Tensor  # (N,) bool
    q: torch.Tensor  # 0-d float32 charge (units of e)
    m: torch.Tensor  # 0-d float32 mass (units of m_e)

    @property
    def n(self) -> int:
        return self.z.shape[0]

    def gamma(self) -> torch.Tensor:
        return torch.sqrt(1.0 + self.ux**2 + self.uy**2 + self.uz**2)

    def to(self, device, copy: bool = False) -> "Particles":
        return Particles(*(t.to(device, copy=copy) for t in self))


def _interp_component(
    field: torch.Tensor,
    iz: torch.Tensor,
    wz: torch.Tensor,
    ix: torch.Tensor,
    wx: torch.Tensor,
    order: int,
) -> torch.Tensor:
    """Gather one staggered component at the particles: each particle reads
    its (order+1)² stencil patch with periodic wrap."""
    nz, nx = field.shape
    npts = order + 1
    offs = torch.arange(npts, device=field.device)
    rows = torch.remainder(iz[:, None] + offs[None, :], nz)  # (N, npts)
    cols = torch.remainder(ix[:, None] + offs[None, :], nx)
    flat = rows[:, :, None] * nx + cols[:, None, :]  # (N, npts, npts)
    vals = field.reshape(-1)[flat]
    return torch.einsum("pij,pi,pj->p", vals, wz, wx)


def gather_fields(
    f: Fields, z: torch.Tensor, x: torch.Tensor, grid: Grid2D, order: int = 3
) -> Tuple[torch.Tensor, ...]:
    """Interpolate all six components to particle positions.  The Yee
    components share two weight sets per axis (offset 0 and 1/2):
    ex=(z0,x½), ey=(z0,x0), ez=(z½,x0), bx=(z½,x0), by=(z½,x½), bz=(z0,x½)."""
    iz0, wz0 = shape_weights(z, grid.dz, 0.0, order)
    izh, wzh = shape_weights(z, grid.dz, 0.5, order)
    ix0, wx0 = shape_weights(x, grid.dx, 0.0, order)
    ixh, wxh = shape_weights(x, grid.dx, 0.5, order)
    ex = _interp_component(f.ex, iz0, wz0, ixh, wxh, order)
    ey = _interp_component(f.ey, iz0, wz0, ix0, wx0, order)
    ez = _interp_component(f.ez, izh, wzh, ix0, wx0, order)
    bx = _interp_component(f.bx, izh, wzh, ix0, wx0, order)
    by = _interp_component(f.by, izh, wzh, ixh, wxh, order)
    bz = _interp_component(f.bz, iz0, wz0, ixh, wxh, order)
    return ex, ey, ez, bx, by, bz


def boris_push(p: Particles, e_b, dt: float) -> Particles:
    """Relativistic Boris rotation; dead particles keep their momenta."""
    ex, ey, ez, bx, by, bz = e_b
    qmdt2 = (p.q / p.m) * dt * 0.5

    umx = p.ux + qmdt2 * ex
    umy = p.uy + qmdt2 * ey
    umz = p.uz + qmdt2 * ez

    gamma_m = torch.sqrt(1.0 + umx**2 + umy**2 + umz**2)
    tx, ty, tz = (qmdt2 / gamma_m * b for b in (bx, by, bz))
    t2 = tx**2 + ty**2 + tz**2

    upx = umx + (umy * tz - umz * ty)
    upy = umy + (umz * tx - umx * tz)
    upz = umz + (umx * ty - umy * tx)

    s = 2.0 / (1.0 + t2)
    uplx = umx + s * (upy * tz - upz * ty)
    uply = umy + s * (upz * tx - upx * tz)
    uplz = umz + s * (upx * ty - upy * tx)

    ux = uplx + qmdt2 * ex
    uy = uply + qmdt2 * ey
    uz = uplz + qmdt2 * ez

    keep = p.alive
    return p._replace(
        ux=torch.where(keep, ux, p.ux),
        uy=torch.where(keep, uy, p.uy),
        uz=torch.where(keep, uz, p.uz),
    )


def advance_positions(p: Particles, grid: Grid2D, dt: float) -> Particles:
    """x^{n+1} = x^n + dt * u/γ; kill particles leaving the physical domain."""
    gamma = p.gamma()
    z = p.z + dt * p.uz / gamma
    x = p.x + dt * p.ux / gamma
    inside = (z >= 0.0) & (z < grid.lz) & (x >= 0.0) & (x < grid.lx)
    return p._replace(
        z=torch.where(p.alive, z, p.z),
        x=torch.where(p.alive, x, p.x),
        alive=p.alive & inside,
    )


def kinetic_energy(p: Particles) -> torch.Tensor:
    """Σ w m (γ - 1) over alive particles."""
    e = p.w * p.m * (p.gamma() - 1.0)
    return torch.sum(torch.where(p.alive, e, torch.zeros_like(e)))
