"""Current deposition (global reference path) and per-box accounting.

Counterpart of ``repro.pic.deposition``.  Direct order-1/order-3
deposition of J = Σ q w v S(x) onto the staggered Jx/Jy/Jz locations, as a
scatter-add with periodic wrap.

``box_work_counters`` is the exact value the CUDA kernels' in-kernel
counters produce (executed 256-lane chunks, padding included, plus the
box's grid work), so the host formula and the device counters agree
bit-for-bit.  Both accounting functions are sync-free tensor code, so the
interval engine evaluates them inside the device-resident loop.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..kernels.constants import CELL_OPS, DEPOSIT_TILE, GATHER_PUSH_OPS_PER_PARTICLE
from .grid import Grid2D
from .particles import Particles
from .shapes import shape_weights

__all__ = [
    "deposit_current",
    "box_particle_counts",
    "box_work_counters",
    "DEPOSIT_TILE",
    "GATHER_PUSH_OPS_PER_PARTICLE",
]


def _deposit_component(
    iz: torch.Tensor,
    wz: torch.Tensor,
    ix: torch.Tensor,
    wx: torch.Tensor,
    val: torch.Tensor,
    grid: Grid2D,
) -> torch.Tensor:
    """Scatter-add each particle's (order+1)² stencil patch, periodic wrap."""
    npts = wz.shape[1]
    offs = torch.arange(npts, device=val.device)
    rows = torch.remainder(iz[:, None] + offs[None, :], grid.nz)
    cols = torch.remainder(ix[:, None] + offs[None, :], grid.nx)
    flat = rows[:, :, None] * grid.nx + cols[:, None, :]
    patches = val[:, None, None] * wz[:, :, None] * wx[:, None, :]
    out = torch.zeros(grid.n_cells, dtype=patches.dtype, device=val.device)
    out.index_add_(0, flat.reshape(-1), patches.reshape(-1))
    return out.reshape(grid.shape)


def deposit_current(
    p: Particles, grid: Grid2D, order: int = 3
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deposit Jx, Jy, Jz from one species (normalized by the cell volume
    so J has field units).  The three components share two weight sets per
    axis: jx=(z0,x½), jy=(z0,x0), jz=(z½,x0)."""
    gamma = p.gamma()
    inv_vol = 1.0 / (grid.dz * grid.dx)
    qw = p.q * p.w * inv_vol
    coef = torch.where(p.alive, qw, torch.zeros_like(qw)) / gamma
    iz0, wz0 = shape_weights(p.z, grid.dz, 0.0, order)
    izh, wzh = shape_weights(p.z, grid.dz, 0.5, order)
    ix0, wx0 = shape_weights(p.x, grid.dx, 0.0, order)
    ixh, wxh = shape_weights(p.x, grid.dx, 0.5, order)
    jx = _deposit_component(iz0, wz0, ixh, wxh, coef * p.ux, grid)
    jy = _deposit_component(iz0, wz0, ix0, wx0, coef * p.uy, grid)
    jz = _deposit_component(izh, wzh, ix0, wx0, coef * p.uz, grid)
    return jx, jy, jz


def box_particle_counts(p: Particles, grid: Grid2D) -> torch.Tensor:
    """Alive particles per box, float32 shape (n_boxes,)."""
    box_ids = grid.box_of_position(p.z, p.x)
    out = torch.zeros(grid.n_boxes, dtype=torch.float32, device=p.z.device)
    return out.index_add_(0, box_ids, p.alive.to(torch.float32))


def box_work_counters(
    n_particles_per_box: torch.Tensor,
    grid: Grid2D,
    tile: int = DEPOSIT_TILE,
) -> torch.Tensor:
    """Work units the kernels execute per box, float32 (n_boxes,):

        counter_b = ceil(n_b / tile) * tile * OPS_PER_PARTICLE
                  + cells_per_box * CELL_OPS

    A partly filled last chunk costs a whole chunk of lanes.  Exact in
    float32 while the sum stays below 2^24, and with 64²-cell boxes, where
    every term is a multiple of 4096, below 2^36.
    """
    n = torch.as_tensor(n_particles_per_box).to(torch.float32)
    tiles = torch.ceil(n / tile)
    return (
        tiles * tile * GATHER_PUSH_OPS_PER_PARTICLE + grid.cells_per_box * CELL_OPS
    ).to(torch.float32)
