"""The laser-ion target (arXiv 2104.11385 §3.1), frozen.

A copy of the geometry and distributions that ``laser_ion_problem`` builds,
so that later changes to the program's problem functions do not change what
the benchmark feeds it: a dense disk of radius 0.17·min(lz, lx) centred at
(0.55 lz, 0.5 lx) with an exponential edge over a slope of 0.4 r_core;
``ppc`` particles per occupied cell (density above 1e-6), weight density ·
cell area / ppc; electrons with Gaussian ux and uz of 0.01 mc; ions at rest
at positions drawn afresh in the same cells; the a0 = 25 antenna at
ω0 = ω_pe/√5 focused on the target.  The particles are drawn on the device,
cell by cell in row-major order as ``laser_ion_problem`` orders them.
"""
from __future__ import annotations

import math

import torch

from . import PlainInputs, below, geometry

__all__ = ["draw"]


def density_map(g, device) -> torch.Tensor:
    """Per-cell density (float64), 1 in the core."""
    lz, lx = g.lz, g.lx
    zc, xc = 0.55 * lz, 0.5 * lx
    r_core = 0.17 * min(lz, lx)
    r_slope = 0.4 * r_core
    edge_scale = 0.01 * r_core + 0.05
    zg = (torch.arange(g.nz, device=device, dtype=torch.float64) + 0.5) * g.dz
    xg = (torch.arange(g.nx, device=device, dtype=torch.float64) + 0.5) * g.dx
    rr = torch.sqrt((zg[:, None] - zc) ** 2 + (xg[None, :] - xc) ** 2)
    slope = torch.where(
        rr <= r_core + r_slope, torch.exp(-(rr - r_core) / edge_scale), torch.zeros_like(rr)
    )
    return torch.where(rr <= r_core, torch.ones_like(rr), slope)


def draw(config: dict, gen: torch.Generator, device: torch.device) -> PlainInputs:
    g = geometry(config)
    ppc = int(config["ppc"])
    density = density_map(g, device)
    occupied = torch.nonzero(density > 1e-6)  # row-major, as np.argwhere
    cz = occupied[:, 0].repeat_interleave(ppc).to(torch.float64)
    cx = occupied[:, 1].repeat_interleave(ppc).to(torch.float64)
    n = cz.numel()
    w = (density[occupied[:, 0], occupied[:, 1]] * (g.dz * g.dx) / ppc).repeat_interleave(ppc)

    def uniform() -> torch.Tensor:
        return torch.rand(n, generator=gen, device=device, dtype=torch.float64)

    def positions():
        z = below(((cz + uniform()) * g.dz).to(torch.float32), g.lz)
        x = below(((cx + uniform()) * g.dx).to(torch.float32), g.lx)
        return z, x

    f32 = dict(dtype=torch.float32, device=device)
    w32 = w.to(torch.float32)
    ze, xe = positions()
    ux = torch.randn(n, generator=gen, **f32) * 0.01
    uz = torch.randn(n, generator=gen, **f32) * 0.01
    electrons = dict(z=ze, x=xe, ux=ux, uy=torch.zeros(n, **f32), uz=uz, w=w32, q=-1.0, m=1.0)
    zi, xi = positions()
    zero = torch.zeros(n, **f32)
    ions = dict(
        z=zi, x=xi, ux=zero, uy=zero.clone(), uz=zero.clone(), w=w32.clone(),
        q=1.0, m=float(config["mass_ratio"]),
    )
    laser = dict(
        a0=25.0,
        omega0=1.0 / math.sqrt(5.0),
        waist=0.13 * g.lx,
        duration=10.0 * 0.1 * (g.lz / 52.6),
        t_peak=0.25 * g.lz,
        z_pos=2.0 * g.dz * 4,
        x_center=0.5 * g.lx,
    )
    return PlainInputs(
        geometry=g,
        species=(electrons, ions),
        laser=laser,
        sponge_width=int(config["sponge_width"]),
    )
