"""Binned layout and the per-species particle substep through the kernels.

Counterpart of ``repro.kernels.ops``:

  1. bin particles by box into (n_boxes, cap) arrays, with an overflow
     count (:func:`bin_particles`),
  2. extract per-box field tiles with a periodic halo (:func:`field_tiles`),
  3. run the fused gather + push + move kernel on the binned arrays, in
     place,
  4. run the deposition kernel at the moved positions (the 3-cell halo
     catches deposits of particles up to one cell outside their box),
  5. scatter-add the tiles onto the global J grids (:func:`assemble_grid`)
     and un-bin the particles.

Everything here is sync-free tensor code: no ``.item()``, no boolean-mask
indexing, no ``nonzero``, and the index tables reach the device once, when
:func:`device_tables` is first called for a grid (the engine calls it when
it builds the step).  The kernels' in-kernel counters sum to exactly
``pic.deposition.box_work_counters`` per species.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..pic.fields import Fields
from ..pic.grid import Grid2D
from ..pic.particles import Particles
from .common import HALO
from .constants import DEPOSIT_TILE
from .deposition import deposit_local_tiles
from .gather_push import gather_push_move_

__all__ = [
    "bin_particles",
    "pic_substep_body",
    "field_tiles",
    "assemble_grid",
    "device_tables",
    "Binned",
]


@functools.lru_cache(maxsize=32)
def _halo_indices(grid: Grid2D) -> np.ndarray:
    """Flat global indices of each box tile incl. halo, periodic wrap.
    Shape (n_boxes, BZ, BX)."""
    bz_t, bx_t = grid.box_nz + 2 * HALO, grid.box_nx + 2 * HALO
    out = np.empty((grid.n_boxes, bz_t, bx_t), dtype=np.int64)
    for b, (cz, cx) in enumerate(grid.box_coords):
        rows = (cz * grid.box_nz - HALO + np.arange(bz_t)) % grid.nz
        cols = (cx * grid.box_nx - HALO + np.arange(bx_t)) % grid.nx
        out[b] = rows[:, None] * grid.nx + cols[None, :]
    return out


class DeviceTables(NamedTuple):
    halo: torch.Tensor  # (n_boxes, BZ, BX) int64 flat grid index per tile cell
    origin_z: torch.Tensor  # (n_boxes + 1,) f32 box origin in cells; 0 for the spill bin
    origin_x: torch.Tensor
    box_range: torch.Tensor  # (n_boxes + 1,) int64: 0..n_boxes


@functools.lru_cache(maxsize=32)
def _device_tables(grid: Grid2D, device: str) -> DeviceTables:
    zero = np.zeros(1, np.float32)
    oz = np.concatenate([(grid.box_coords[:, 0] * grid.box_nz).astype(np.float32), zero])
    ox = np.concatenate([(grid.box_coords[:, 1] * grid.box_nx).astype(np.float32), zero])
    return DeviceTables(
        halo=torch.from_numpy(_halo_indices(grid)).to(device),
        origin_z=torch.from_numpy(oz).to(device),
        origin_x=torch.from_numpy(ox).to(device),
        box_range=torch.arange(grid.n_boxes + 1, device=device),
    )


def device_tables(grid: Grid2D, device) -> DeviceTables:
    """The grid's static index tables on ``device`` (copied there once)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:  # "cuda" and "cuda:0" share one copy
        dev = torch.device("cuda", torch.cuda.current_device())
    return _device_tables(grid, str(dev))


def field_tiles(f: Fields, grid: Grid2D) -> Tuple[torch.Tensor, ...]:
    """(n_boxes, BZ, BX) halo tiles of all six components."""
    idx = device_tables(grid, f.ex.device).halo
    return tuple(torch.take(c, idx) for c in f)


def assemble_grid(local: torch.Tensor, grid: Grid2D) -> torch.Tensor:
    """Scatter-add (n_boxes, BZ, BX) tiles back onto the global grid (halo
    overlaps accumulate)."""
    idx = device_tables(grid, local.device).halo
    flat = torch.zeros(grid.n_cells, dtype=local.dtype, device=local.device)
    flat.index_add_(0, idx.reshape(-1), local.reshape(-1))
    return flat.reshape(grid.shape)


class Binned(NamedTuple):
    counts: torch.Tensor  # (n_boxes,) i32 — alive particles per box (<= cap)
    sz: torch.Tensor  # (n_boxes, cap) local z (cell units, halo origin)
    sx: torch.Tensor
    ux: torch.Tensor
    uy: torch.Tensor
    uz: torch.Tensor
    w: torch.Tensor
    slot_of_particle: torch.Tensor  # (N,) i64 flat slot per particle (n_boxes*cap = spill)
    valid: torch.Tensor  # (N,) bool — particle was binned (alive and not overflowed)
    n_dropped: torch.Tensor  # 0-d i32 — alive particles lost to overflow


def bin_particles(p: Particles, grid: Grid2D, cap: int) -> Binned:
    """Sort alive particles by box into fixed (n_boxes, cap) bins.  Dead
    particles and those beyond a box's ``cap`` go to one spill slot at flat
    index ``n_boxes * cap``; ``n_dropped`` counts the alive ones lost."""
    n = p.n
    n_boxes = grid.n_boxes
    dev = p.z.device
    tables = device_tables(grid, dev)
    box_ids = grid.box_of_position(p.z, p.x)
    box_ids = torch.where(p.alive, box_ids, n_boxes)  # dead -> overflow bin
    order = torch.argsort(box_ids, stable=True)
    sorted_ids = box_ids[order]
    starts = torch.searchsorted(sorted_ids, tables.box_range)
    ranks = torch.arange(n, device=dev) - starts[sorted_ids]
    ok = (sorted_ids < n_boxes) & (ranks < cap)
    spill = n_boxes * cap
    dest = torch.where(ok, sorted_ids * cap + ranks, spill)

    def scatter(v: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(spill + 1, dtype=v.dtype, device=dev)
        out.scatter_(0, dest, v[order])
        return out[:spill].view(n_boxes, cap)

    # local coordinates: s = pos/spacing - box_origin_cells + HALO
    sz_g = p.z / grid.dz - tables.origin_z[box_ids] + HALO
    sx_g = p.x / grid.dx - tables.origin_x[box_ids] + HALO

    counts_all = starts[1:] - starts[:-1]
    counts = torch.clamp(counts_all, max=cap).to(torch.int32)
    n_dropped = torch.clamp(counts_all - cap, min=0).sum().to(torch.int32)
    slot_of_particle = torch.empty(n, dtype=torch.int64, device=dev).scatter_(0, order, dest)
    valid = torch.empty(n, dtype=torch.bool, device=dev).scatter_(0, order, ok)
    return Binned(
        counts=counts,
        sz=scatter(sz_g),
        sx=scatter(sx_g),
        ux=scatter(p.ux),
        uy=scatter(p.uy),
        uz=scatter(p.uz),
        w=scatter(p.w),
        slot_of_particle=slot_of_particle,
        valid=valid,
        n_dropped=n_dropped,
    )


def pic_substep_body(
    f: Fields,
    p: Particles,
    *,
    grid: Grid2D,
    dt: float,
    cap: int,
    tile: int = DEPOSIT_TILE,
):
    """One species' particle work for one PIC step through the kernels.

    Returns ``(new_particles, (jx, jy, jz), work_counters, counts,
    n_dropped)``: gather(E^n, B^n) → Boris → move → direct order-3
    deposition at the new positions.  The push updates the binned arrays in
    place, and they are released as soon as they are consumed (about 2 GB
    each at the full-size run).
    """
    b = bin_particles(p, grid, cap)
    tiles = field_tiles(f, grid)
    qm = p.q / p.m
    sz, sx, ux, uy, uz = b.sz, b.sx, b.ux, b.uy, b.uz
    cnt_push = gather_push_move_(
        b.counts, sz, sx, ux, uy, uz, tiles, grid=grid, qm=qm, dt=dt, tile=tile
    )
    del tiles
    w = b.w
    b = b._replace(sz=None, sx=None, ux=None, uy=None, uz=None, w=None)

    # deposition values at the new momenta/positions (direct deposition)
    gamma = torch.sqrt(1.0 + ux**2 + uy**2 + uz**2)
    slot_live = torch.arange(cap, device=sz.device)[None, :] < b.counts[:, None]
    qw = p.q * w
    del w
    coef = torch.where(slot_live, qw, torch.zeros_like(qw)) / (gamma * (grid.dz * grid.dx))
    del qw, gamma, slot_live
    jx_t, jy_t, jz_t, cnt_dep = deposit_local_tiles(
        b.counts, sz, sx, coef * ux, coef * uy, coef * uz, grid=grid, tile=tile
    )
    del coef
    jx = assemble_grid(jx_t, grid)
    jy = assemble_grid(jy_t, grid)
    jz = assemble_grid(jz_t, grid)
    del jx_t, jy_t, jz_t
    counters = cnt_push + cnt_dep

    # un-bin: map the binned state back to the original particle order;
    # particles that were not binned keep their state (frozen for a step)
    tables = device_tables(grid, sz.device)
    slot = torch.clamp(b.slot_of_particle, 0, grid.n_boxes * cap - 1)
    slot_box = slot // cap

    def unbin(binned: torch.Tensor, fallback: torch.Tensor) -> torch.Tensor:
        return torch.where(b.valid, binned.reshape(-1)[slot], fallback)

    z_new = unbin(sz, p.z / grid.dz) - HALO + tables.origin_z[slot_box]
    x_new = unbin(sx, p.x / grid.dx) - HALO + tables.origin_x[slot_box]
    del sz, sx
    z_new = z_new * grid.dz
    x_new = x_new * grid.dx
    inside = (z_new >= 0.0) & (z_new < grid.lz) & (x_new >= 0.0) & (x_new < grid.lx)
    new_p = p._replace(
        z=torch.where(b.valid, z_new, p.z),
        x=torch.where(b.valid, x_new, p.x),
        ux=unbin(ux, p.ux),
        uy=unbin(uy, p.uy),
        uz=unbin(uz, p.uz),
        alive=p.alive & torch.where(b.valid, inside, p.alive),
    )
    return new_p, (jx, jy, jz), counters, b.counts, b.n_dropped
