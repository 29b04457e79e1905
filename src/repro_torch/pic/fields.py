"""FDTD Maxwell solver on the 2D Yee grid (normalized units, c = 1).

Counterpart of ``repro.pic.fields``.  Leapfrog:

    B^{n-1/2} -> B^n        (half step, used for the particle push)
    E^n       -> E^{n+1}    (full step, with deposited J^{n+1/2})
    B^n       -> B^{n+1/2}  (half step)

Periodic differences (``torch.roll`` over the last two axes, so a stack of
per-box tiles ``(slots, nz, nx)`` steps like one grid) plus a multiplicative
sponge layer.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from .grid import Grid2D

__all__ = ["Fields", "step_b_half", "step_e", "make_sponge", "apply_sponge", "field_energy"]


class Fields(NamedTuple):
    """All six field components, each of shape (nz, nx)."""

    ex: torch.Tensor
    ey: torch.Tensor
    ez: torch.Tensor
    bx: torch.Tensor
    by: torch.Tensor
    bz: torch.Tensor

    @classmethod
    def zeros(
        cls, grid: Grid2D, device: Union[str, torch.device], dtype=torch.float32
    ) -> "Fields":
        return cls(*(torch.zeros(grid.shape, dtype=dtype, device=device) for _ in range(6)))


def _ddz_fwd(f: torch.Tensor, dz: float) -> torch.Tensor:
    """Forward difference along z: result staggered +1/2 in z."""
    return (torch.roll(f, -1, dims=-2) - f) / dz


def _ddz_bwd(f: torch.Tensor, dz: float) -> torch.Tensor:
    """Backward difference along z: result staggered -1/2 in z."""
    return (f - torch.roll(f, 1, dims=-2)) / dz


def _ddx_fwd(f: torch.Tensor, dx: float) -> torch.Tensor:
    return (torch.roll(f, -1, dims=-1) - f) / dx


def _ddx_bwd(f: torch.Tensor, dx: float) -> torch.Tensor:
    return (f - torch.roll(f, 1, dims=-1)) / dx


def step_b_half(f: Fields, grid: Grid2D) -> Fields:
    """Advance B by dt/2:  ∂B/∂t = -∇xE  (∂/∂y = 0)."""
    hdt = 0.5 * grid.dt
    bx = f.bx + hdt * _ddz_fwd(f.ey, grid.dz)
    by = f.by - hdt * (_ddz_fwd(f.ex, grid.dz) - _ddx_fwd(f.ez, grid.dx))
    bz = f.bz - hdt * _ddx_fwd(f.ey, grid.dx)
    return f._replace(bx=bx, by=by, bz=bz)


def step_e(f: Fields, j, grid: Grid2D) -> Fields:
    """Advance E by dt:  ∂E/∂t = ∇xB - J  (c = 1, ε0 = 1)."""
    dt = grid.dt
    jx, jy, jz = j
    ex = f.ex + dt * (-_ddz_bwd(f.by, grid.dz) - jx)
    ey = f.ey + dt * (_ddz_bwd(f.bx, grid.dz) - _ddx_bwd(f.bz, grid.dx) - jy)
    ez = f.ez + dt * (_ddx_bwd(f.by, grid.dx) - jz)
    return f._replace(ex=ex, ey=ey, ez=ez)


def make_sponge(
    grid: Grid2D,
    width_cells: int = 8,
    strength: float = 0.2,
    device: Optional[Union[str, torch.device]] = None,
) -> torch.Tensor:
    """Multiplicative damping mask: 1 in the interior, decaying toward the
    boundary over ``width_cells`` cells (applied to all components)."""
    if width_cells <= 0:
        return torch.ones(grid.shape, dtype=torch.float32, device=device)
    iz = torch.arange(grid.nz, device=device)
    ix = torch.arange(grid.nx, device=device)
    edge_z = torch.minimum(iz, grid.nz - 1 - iz)
    edge_x = torch.minimum(ix, grid.nx - 1 - ix)
    dist = torch.minimum(edge_z[:, None], edge_x[None, :]).to(torch.float32)
    ramp = torch.clamp(dist / width_cells, 0.0, 1.0)
    return 1.0 - strength * (1.0 - ramp) ** 2


def apply_sponge(f: Fields, sponge: torch.Tensor) -> Fields:
    return Fields(*(c * sponge for c in f))


def field_energy(f: Fields, grid: Grid2D) -> torch.Tensor:
    """Total EM energy  (1/2)∫(E² + B²) dV  in normalized units."""
    dv = grid.dz * grid.dx
    total = sum(torch.sum(c.to(torch.float32) ** 2) for c in f)
    return 0.5 * total * dv
