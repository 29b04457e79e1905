"""Box decomposition bookkeeping and the halo geometry of per-box tiles
(counterpart of ``repro.pic.boxes``).

The single-device simulation keeps global field/particle tensors; boxes
exist there as an accounting structure: cost measurement, distribution
mapping, data volumes.  The sharded runtime (``repro_torch.dist``) keeps one
halo-padded tile per box, and the numpy tables below (copies of the
reference's) say which cell goes where: the slice plans of the halo paste
and fold, dense cell maps, per-direction strip tables, the frontier cells
of split-phase stepping, the slot curve and the 9-point neighbourhood.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from .grid import Grid2D

__all__ = [
    "BoxDecomposition",
    "halo_paste_plan",
    "halo_fold_plan",
    "interior_cell_map",
    "padded_cell_map",
    "neighbor_box_table",
    "HALO_DIRS",
    "HaloStripTables",
    "halo_strip_tables",
    "frontier_cell_mask",
    "box_slot_layout",
]

#: the 8 halo-exchange directions, row-major over (dz, dx) in {-1,0,1}^2
#: minus the box itself (the off-centre columns of neighbor_box_table)
HALO_DIRS: Tuple[Tuple[int, int], ...] = tuple(
    (dz, dx) for dz in (-1, 0, 1) for dx in (-1, 0, 1) if (dz, dx) != (0, 0)
)


@dataclass
class BoxDecomposition:
    """Box geometry + data-volume model for a grid."""

    grid: Grid2D
    bytes_per_cell: float = 9 * 4  # 6 field + 3 current components, f32
    bytes_per_particle: float = 7 * 4  # z,x,ux,uy,uz,w,alive

    @property
    def n_boxes(self) -> int:
        return self.grid.n_boxes

    @property
    def coords(self) -> np.ndarray:
        return self.grid.box_coords

    @property
    def neighbors(self) -> List[List[int]]:
        return self.grid.box_neighbors

    def box_slices(self, box_id: int) -> Tuple[slice, slice]:
        """(z, x) slices of ``box_id``'s interior in the global grid."""
        bz, bx = self.coords[box_id]
        g = self.grid
        return (
            slice(bz * g.box_nz, (bz + 1) * g.box_nz),
            slice(bx * g.box_nx, (bx + 1) * g.box_nx),
        )

    def box_bytes(self, n_particles_per_box: np.ndarray) -> np.ndarray:
        """Redistribution payload per box: its cells + its particles."""
        cells = self.grid.cells_per_box * self.bytes_per_cell
        return cells + np.asarray(n_particles_per_box) * self.bytes_per_particle

    def surface_bytes(self) -> np.ndarray:
        """Halo payload per box per step (guard-cell exchange)."""
        return np.full(
            self.n_boxes, self.grid.box_surface_cells * self.bytes_per_cell, dtype=np.float64
        )


# ---------------------------------------------------------------------------
# Halo-exchange slice plans (periodic, 9-point neighbourhood).  Periodicity
# is planned over ring-shifted images of the box coordinates, which also
# covers decompositions where a box is its own wrap-around neighbour.
# ---------------------------------------------------------------------------


def _plan(grid: Grid2D, halo: int, src_halo: int):
    bs_z, bs_x = grid.box_nz, grid.box_nx
    if halo < 1 or halo > min(bs_z, bs_x):
        raise ValueError(
            f"halo must be in [1, min(box_nz, box_nx)] = [1, {min(bs_z, bs_x)}], got {halo}"
        )
    plans = []
    for bz, bx in grid.box_coords:
        t0z, t0x = bz * bs_z - halo, bx * bs_x - halo  # padded-frame origin
        t1z, t1x = t0z + bs_z + 2 * halo, t0x + bs_x + 2 * halo
        entries = []
        for dz in (-1, 0, 1):
            for dx in (-1, 0, 1):
                src = ((bz + dz) % grid.boxes_z) * grid.boxes_x + (bx + dx) % grid.boxes_x
                # image origin of the source tile in the target's unwrapped frame
                i0z = (bz + dz) * bs_z - src_halo
                i0x = (bx + dx) * bs_x - src_halo
                oz0, oz1 = max(t0z, i0z), min(t1z, i0z + bs_z + 2 * src_halo)
                ox0, ox1 = max(t0x, i0x), min(t1x, i0x + bs_x + 2 * src_halo)
                if oz1 <= oz0 or ox1 <= ox0:
                    continue
                entries.append(
                    (
                        int(src),
                        (slice(oz0 - t0z, oz1 - t0z), slice(ox0 - t0x, ox1 - t0x)),
                        (slice(oz0 - i0z, oz1 - i0z), slice(ox0 - i0x, ox1 - i0x)),
                    )
                )
        plans.append(entries)
    return plans


def halo_paste_plan(grid: Grid2D, halo: int):
    """Per box, ``(src_box, target_slices, src_slices)`` assembling its
    ``halo``-padded tile from box interiors; target regions are disjoint
    and cover the padded tile."""
    return _plan(grid, halo, src_halo=0)


def halo_fold_plan(grid: Grid2D, halo: int):
    """Per box, ``(src_box, target_slices, src_slices)`` summing neighbour
    *padded* deposit tiles into its padded frame; targets overlap, so the
    contributions are added."""
    return _plan(grid, halo, src_halo=halo)


def interior_cell_map(grid: Grid2D) -> np.ndarray:
    """int32 ``(n_boxes, box_nz, box_nx)``: the flat global cell
    ``gz * nx + gx`` of each interior cell of each box (covers the grid
    exactly once)."""
    bs_z, bs_x = grid.box_nz, grid.box_nx
    out = np.empty((grid.n_boxes, bs_z, bs_x), np.int32)
    iz = np.arange(bs_z)[:, None]
    ix = np.arange(bs_x)[None, :]
    for b, (bz, bx) in enumerate(grid.box_coords):
        out[b] = (bz * bs_z + iz) * grid.nx + (bx * bs_x + ix)
    return out


def padded_cell_map(grid: Grid2D, halo: int) -> np.ndarray:
    """int32 ``(n_boxes, box_nz + 2*halo, box_nx + 2*halo)``: the
    (periodically wrapped) global cell each padded-tile cell aliases,
    derived from :func:`halo_paste_plan`.  A gather table for the paste and
    a scatter-add table for the fold."""
    bs_z, bs_x = grid.box_nz, grid.box_nx
    pnz, pnx = bs_z + 2 * halo, bs_x + 2 * halo
    out = np.full((grid.n_boxes, pnz, pnx), -1, np.int32)
    for b, entries in enumerate(halo_paste_plan(grid, halo)):
        for src, (tz, tx), (sz, sx) in entries:
            sbz, sbx = grid.box_coords[src]
            gz = sbz * bs_z + np.arange(sz.start, sz.stop)[:, None]
            gx = sbx * bs_x + np.arange(sx.start, sx.stop)[None, :]
            out[b, tz, tx] = gz * grid.nx + gx
    if (out < 0).any():
        raise AssertionError("paste plan must cover the padded tile")
    return out


@dataclass(frozen=True)
class HaloStripTables:
    """Directional strip geometry for the neighbour halo exchange.

    For direction ``j`` (``HALO_DIRS[j]``) box ``b`` receives from
    ``src_box[b, j]`` the paste strip (``paste_src[j]`` flat cells of the
    source's interior tile landing at ``paste_dst[j]`` of ``b``'s padded
    tile) and the fold strip (``fold_src[j]`` cells of the source's padded
    deposit, added at ``fold_dst[j]``).  ``opposite[j]`` is the direction
    of ``(-dz, -dx)``: the box that needs ``b``'s direction-``j`` strip is
    ``src_box[b, opposite[j]]``.
    """

    halo: int
    src_box: np.ndarray  # (n_boxes, 8) int64
    paste_src: Tuple[np.ndarray, ...]  # 8 x (m_j,) int32 into (bnz*bnx)
    paste_dst: Tuple[np.ndarray, ...]  # 8 x (m_j,) int32 into (pnz*pnx)
    fold_src: Tuple[np.ndarray, ...]  # 8 x (f_j,) int32 into (pnz*pnx)
    fold_dst: Tuple[np.ndarray, ...]  # 8 x (f_j,) int32 into (pnz*pnx)
    opposite: Tuple[int, ...] = (7, 6, 5, 4, 3, 2, 1, 0)


def _strip(grid: Grid2D, halo: int, dz: int, dx: int, src_halo: int):
    """(src_flat, dst_flat) for one direction; src indexes a
    ``(bs + 2*src_halo)``-shaped source tile, dst the halo-padded frame."""
    bs_z, bs_x = grid.box_nz, grid.box_nx
    i0z, i0x = dz * bs_z - src_halo, dx * bs_x - src_halo
    oz0, oz1 = max(-halo, i0z), min(bs_z + halo, i0z + bs_z + 2 * src_halo)
    ox0, ox1 = max(-halo, i0x), min(bs_x + halo, i0x + bs_x + 2 * src_halo)
    src_nx = bs_x + 2 * src_halo
    pnx = bs_x + 2 * halo
    sz = np.arange(oz0 - i0z, oz1 - i0z)[:, None]
    sx = np.arange(ox0 - i0x, ox1 - i0x)[None, :]
    tz = np.arange(oz0 + halo, oz1 + halo)[:, None]
    tx = np.arange(ox0 + halo, ox1 + halo)[None, :]
    return (
        (sz * src_nx + sx).ravel().astype(np.int32),
        (tz * pnx + tx).ravel().astype(np.int32),
    )


def halo_strip_tables(grid: Grid2D, halo: int) -> HaloStripTables:
    """Per-direction send/receive cell maps of the neighbour halo exchange
    (the strip form of the slice plans; same validity domain)."""
    if halo < 1 or halo > min(grid.box_nz, grid.box_nx):
        raise ValueError(
            "halo must be in [1, min(box_nz, box_nx)] = "
            f"[1, {min(grid.box_nz, grid.box_nx)}], got {halo}"
        )
    paste_src, paste_dst, fold_src, fold_dst = [], [], [], []
    for dz, dx in HALO_DIRS:
        ps, pd = _strip(grid, halo, dz, dx, src_halo=0)
        fs, fd = _strip(grid, halo, dz, dx, src_halo=halo)
        paste_src.append(ps)
        paste_dst.append(pd)
        fold_src.append(fs)
        fold_dst.append(fd)
    src_box = neighbor_box_table(grid)[:, [0, 1, 2, 3, 5, 6, 7, 8]]
    return HaloStripTables(
        halo=halo,
        src_box=src_box,
        paste_src=tuple(paste_src),
        paste_dst=tuple(paste_dst),
        fold_src=tuple(fold_src),
        fold_dst=tuple(fold_dst),
    )


def frontier_cell_mask(grid: Grid2D, halo: int, shape_order: int = 3) -> np.ndarray:
    """Padded-tile cells whose particles the halo exchange depends on.

    Bool ``(pnz, pnx)`` over the halo-padded tile frame: ``True`` marks
    **frontier** cells, where a particle's post-move cell lets it deposit
    into a cell the fold strips send to a neighbour (so its deposit must be
    done before the strips are sent); ``False`` marks **interior** cells,
    whose deposits cannot touch any sent strip: the split-phase step's
    window.  The union of :func:`halo_strip_tables`' ``fold_src`` cells,
    dilated by the deposit reach of ``shape_order`` (a particle in cell
    ``c`` writes ``[c - r, c + r]`` per axis, ``r = SUPPORT[order] // 2``),
    plus every guard cell.  Boxes too small to hold an interior band give
    an all-True mask: split-phase stepping then degenerates to the
    monolithic step.
    """
    from .shapes import SUPPORT

    if shape_order not in SUPPORT:
        raise ValueError(f"unsupported shape order {shape_order}; expected 1 or 3")
    reach = SUPPORT[shape_order] // 2
    tables = halo_strip_tables(grid, halo)
    pnz, pnx = grid.box_nz + 2 * halo, grid.box_nx + 2 * halo
    sent = np.zeros(pnz * pnx, bool)
    for fs in tables.fold_src:
        sent[fs] = True
    mask = sent.reshape(pnz, pnx).copy()
    # dilate by the reach, axis by axis (a Chebyshev ball)
    for _ in range(reach):
        grown = mask.copy()
        grown[1:, :] |= mask[:-1, :]
        grown[:-1, :] |= mask[1:, :]
        mask = grown
    for _ in range(reach):
        grown = mask.copy()
        grown[:, 1:] |= mask[:, :-1]
        grown[:, :-1] |= mask[:, 1:]
        mask = grown
    # off-interior particles are mid-migration: always frontier
    mask[:halo, :] = True
    mask[-halo:, :] = True
    mask[:, :halo] = True
    mask[:, -halo:] = True
    return mask


def box_slot_layout(grid: Grid2D, order: str = "morton") -> np.ndarray:
    """Slot of each box along a locality-preserving curve, ``(n_boxes,)``:
    ``"morton"`` (Z-order, compact 2-D patches per device) or ``"row"``
    (row-major box ids, slabs)."""
    if order == "row":
        return np.arange(grid.n_boxes, dtype=np.int64)
    if order == "morton":
        from ..core.policies import morton_index

        z = morton_index(grid.box_coords)
        pos = np.empty(grid.n_boxes, dtype=np.int64)
        pos[np.argsort(z, kind="stable")] = np.arange(grid.n_boxes)
        return pos
    raise ValueError(f"unknown slot layout {order!r} (use 'morton' or 'row')")


def neighbor_box_table(grid: Grid2D) -> np.ndarray:
    """Periodic 9-point neighbourhood per box, ``(n_boxes, 9)``, row-major
    over ``(dz, dx)`` in {-1,0,1}^2 (column 4 is the box itself): the boxes
    a particle can reach in one step."""
    out = np.empty((grid.n_boxes, 9), np.int64)
    for b, (bz, bx) in enumerate(grid.box_coords):
        col = 0
        for dz in (-1, 0, 1):
            for dx in (-1, 0, 1):
                out[b, col] = ((bz + dz) % grid.boxes_z) * grid.boxes_x + (
                    (bx + dx) % grid.boxes_x
                )
                col += 1
    return out
