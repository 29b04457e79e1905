"""Plain oracles for the PIC kernels and the shared synthetic population
(counterpart of ``repro.kernels.ref``).

``deposit_local_tiles_ref`` mirrors the deposition kernel's contract on the
binned layout with an explicit 4x4 scatter loop over ``pic.shapes``'s
weights: a code path independent of the kernel and of its plain version
(``kernels.deposition.deposit_local_tiles_plain``).  ``work_counters_ref``
gives the exact counter values the kernels must produce.

``random_particles`` is the synthetic population that kernel checks and
benchmarks build their inputs from.  It draws from a torch generator, so
its values are not the reference's; its contract is: positions uniform
inside ``margin`` of the domain edges, momenta normal with std
``u_scale``, weights uniform on [0.5, 1.5), about 10% of the particles
dead.
"""
from __future__ import annotations

from typing import Union

import torch

from .._device import make_generator
from ..pic.grid import Grid2D
from ..pic.particles import Particles
from ..pic.shapes import shape_weights
from .common import HALO
from .constants import CELL_OPS, DEPOSIT_OPS, DEPOSIT_TILE, PUSH_OPS

__all__ = ["deposit_local_tiles_ref", "work_counters_ref", "random_particles"]


def random_particles(
    n: int,
    grid: Grid2D,
    seed: Union[int, torch.Generator] = 0,
    margin: float = 3.0,
    u_scale: float = 0.5,
    *,
    device=None,
) -> Particles:
    """Reproducible random population on ``grid`` (some particles dead),
    drawn from ``seed`` (a generator, or a seed for one on ``device``,
    default ``"cuda"``)."""
    gen = make_generator(seed, device)
    dev = gen.device

    def uniform(lo: float, hi: float) -> torch.Tensor:
        return torch.empty(n, device=dev).uniform_(lo, hi, generator=gen)

    def normal() -> torch.Tensor:
        return torch.empty(n, device=dev).normal_(0.0, u_scale, generator=gen)

    return Particles(
        z=uniform(margin, grid.lz - margin),
        x=uniform(margin, grid.lx - margin),
        ux=normal(),
        uy=normal(),
        uz=normal(),
        w=uniform(0.5, 1.5),
        alive=uniform(0.0, 1.0) > 0.1,
        q=torch.tensor(-1.0, device=dev),
        m=torch.tensor(1.0, device=dev),
    )


def _component_tiles(sz, sx, val, slot_live, off_z, off_x, bz, bx):
    """Scatter one current component into local tiles, explicit loop."""
    n_boxes, cap = sz.shape
    # local coords are already in cell units, so spacing=1.0
    iz0, wz = shape_weights(sz.reshape(-1), 1.0, off_z, 3)
    ix0, wx = shape_weights(sx.reshape(-1), 1.0, off_x, 3)
    v = torch.where(slot_live.reshape(-1), val.reshape(-1), 0.0)
    box = torch.arange(n_boxes, device=sz.device).repeat_interleave(cap)
    flat = torch.zeros(n_boxes * bz * bx, dtype=val.dtype, device=val.device)
    for k in range(4):
        for l in range(4):
            rows = torch.clamp(iz0 + k, 0, bz - 1)
            cols = torch.clamp(ix0 + l, 0, bx - 1)
            idx = box * (bz * bx) + rows * bx + cols
            flat.index_add_(0, idx, v * wz[:, k] * wx[:, l])
    return flat.reshape(n_boxes, bz, bx)


def deposit_local_tiles_ref(counts, sz, sx, vx, vy, vz, *, grid: Grid2D, tile=DEPOSIT_TILE):
    """Oracle for ``kernels.deposition.deposit_local_tiles``."""
    n_boxes, cap = sz.shape
    bz, bx = grid.box_nz + 2 * HALO, grid.box_nx + 2 * HALO
    slot_live = torch.arange(cap, device=counts.device)[None, :] < counts[:, None]
    jx = _component_tiles(sz, sx, vx, slot_live, 0.0, 0.5, bz, bx)
    jy = _component_tiles(sz, sx, vy, slot_live, 0.0, 0.0, bz, bx)
    jz = _component_tiles(sz, sx, vz, slot_live, 0.5, 0.0, bz, bx)
    cnt = work_counters_ref(counts, grid, tile=tile, which="deposit")
    return jx, jy, jz, cnt


def work_counters_ref(counts, grid: Grid2D, *, tile=DEPOSIT_TILE, which="both"):
    """Exact counter values the kernels must produce."""
    tiles = torch.ceil(counts / tile).to(torch.int32)
    dep = tiles * tile * DEPOSIT_OPS + grid.cells_per_box * CELL_OPS
    push = tiles * tile * PUSH_OPS
    if which == "deposit":
        return dep
    if which == "push":
        return push
    return dep + push
