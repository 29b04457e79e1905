"""Order-3 current deposition into per-box halo tiles, with in-kernel work
counters.

Counterpart of ``repro.kernels.deposition`` (the TPU kernel
``_deposition_kernel``).  :func:`deposit_local_tiles` launches the CUDA
kernel ``csrc/deposition.cu`` for CUDA tensors and runs
:func:`deposit_local_tiles_plain`, the same contract in plain PyTorch, for
CPU tensors.  Layout, per box b:

  in : counts (B,) i32 | sz, sx, vx, vy, vz (B, cap) f32
  out: jx, jy, jz (B, BZ, BX) f32 | counter (B,) i32

with BZ = box_nz + 2·HALO, BX = box_nx + 2·HALO unless ``tile_shape``
overrides them.  On the H100 the kernel is bound by its shared-memory
atomics (48 per executed lane); its source note says how the design
spreads them over all SMs.

:func:`deposit_local_tiles_from_momenta` is the form the PIC step runs:
the same kernel computes each executed lane's value q·w·u/γ itself from
the pushed momenta ``ux, uy, uz`` and weights ``w`` (B, cap) f32, so no
elementwise pass runs over the padded lanes; on CPU tensors
:func:`deposit_local_tiles_from_momenta_plain` runs the glue in plain
PyTorch and then :func:`deposit_local_tiles_plain`.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..pic.grid import Grid2D
from ._tensors import SPAN_CHUNKS, check_binned, plain_box_groups, scalar_tensor, span_table
from .common import HALO, cubic_weights
from .constants import CELL_OPS, DEPOSIT_OPS, DEPOSIT_TILE

__all__ = [
    "deposit_local_tiles",
    "deposit_local_tiles_plain",
    "deposition_launcher",
    "deposit_local_tiles_from_momenta",
    "deposit_local_tiles_from_momenta_plain",
    "deposition_from_momenta_launcher",
]


def _geometry(grid: Grid2D, tile_shape, cells_per_box) -> Tuple[int, int, int]:
    if tile_shape is None:
        bz, bx = grid.box_nz + 2 * HALO, grid.box_nx + 2 * HALO
    else:
        bz, bx = (int(v) for v in tile_shape)
    cells = grid.cells_per_box if cells_per_box is None else int(cells_per_box)
    return bz, bx, cells


#: scratch cells past the tiles that dropped stencil points add zero to,
#: spread by lane so the adds do not pile onto one address
_TRASH = 1 << 16


def _stencil_scatter(flat, box_base, trash, iz, wz, ix, wx, v, run, bz, bx):
    """Add (wz_k * v) * wx_l at (iz+k, ix+l) of each lane's box tile for
    lanes in executed chunks; out-of-tile points are dropped."""
    for k in range(4):
        row = iz + k
        zv = wz[..., k] * v
        for l in range(4):
            col = ix + l
            ok = run & (row >= 0) & (row < bz) & (col >= 0) & (col < bx)
            term = zv * wx[..., l]
            idx = torch.where(ok, box_base + row * bx + col, trash)
            term = torch.where(ok, term, torch.zeros_like(term))
            flat.index_add_(0, idx.reshape(-1), term.reshape(-1))


def deposit_local_tiles_plain(
    counts: torch.Tensor,
    sz: torch.Tensor,
    sx: torch.Tensor,
    vx: torch.Tensor,
    vy: torch.Tensor,
    vz: torch.Tensor,
    *,
    grid: Grid2D,
    tile: int = DEPOSIT_TILE,
    tile_shape=None,
    cells_per_box: Optional[int] = None,
):
    """Plain PyTorch version of the kernel's contract (any device)."""
    n_boxes, cap = check_binned(counts, (sz, sx, vx, vy, vz), tile)
    bz, bx, cells = _geometry(grid, tile_shape, cells_per_box)
    chunks = torch.clamp((counts.long() + tile - 1) // tile, 0, cap // tile)
    exec_lanes = chunks * tile
    # lanes past every box's last executed chunk deposit nothing
    n_run = int(exec_lanes.max()) if n_boxes else 0
    lane = torch.arange(n_run, device=sz.device)
    n_tile = n_boxes * bz * bx
    jx, jy, jz = (
        torch.zeros(n_tile + _TRASH, dtype=torch.float32, device=sz.device) for _ in range(3)
    )
    for b in plain_box_groups(n_boxes, n_run):
        g = (b, slice(0, n_run))
        boxes = torch.arange(n_boxes, device=sz.device)[b]
        box_base = (boxes * (bz * bx))[:, None]
        trash = n_tile + (boxes[:, None] * n_run + lane[None, :]) % _TRASH
        run = lane[None, :] < exec_lanes[b][:, None]
        iz0, wz0 = cubic_weights(sz[g])
        iz5, wz5 = cubic_weights(sz[g] - 0.5)
        ix0, wx0 = cubic_weights(sx[g])
        ix5, wx5 = cubic_weights(sx[g] - 0.5)
        _stencil_scatter(jx, box_base, trash, iz0, wz0, ix5, wx5, vx[g], run, bz, bx)
        _stencil_scatter(jy, box_base, trash, iz0, wz0, ix0, wx0, vy[g], run, bz, bx)
        _stencil_scatter(jz, box_base, trash, iz5, wz5, ix0, wx0, vz[g], run, bz, bx)
    cnt = (cells * CELL_OPS + exec_lanes * DEPOSIT_OPS).to(torch.int32)
    shape = (n_boxes, bz, bx)
    return tuple(j[:n_tile].view(shape) for j in (jx, jy, jz)) + (cnt,)


def _cuda_device(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"the deposition kernel runs on cuda tensors, got {t.device}")
    return t.device


def _launcher(kernel: str, counts, arrays, extra, scalars, counted, *, grid, tile, tile_shape,
              cells_per_box, span_chunks):
    """One launch of ``kernel``'s form, prepared: the library's
    ``<kernel>_launch`` takes the counts and the span table, ``arrays``,
    the ``extra`` tensors (None: a null pointer), the zeroed tiles and the
    counters' grid term, the geometry and the persistent grid, ``scalars``
    and the stream.  Each ``launch()`` counts in every entry of ``counted``."""
    from . import _build

    device = _cuda_device(arrays[0])
    n_boxes, cap = check_binned(counts, arrays, tile)
    bz, bx, cells = _geometry(grid, tile_shape, cells_per_box)
    counts32 = counts.to(device=device, dtype=torch.int32).contiguous()
    spans = span_table(counts32, cap, tile, span_chunks)
    jx, jy, jz = (
        torch.zeros((n_boxes, bz, bx), dtype=torch.float32, device=device) for _ in range(3)
    )
    # the counters' grid term; the kernel adds the executed chunks' term
    cnt = torch.full((n_boxes,), cells * CELL_OPS, dtype=torch.int32, device=device)
    fn = getattr(_build.load_library(), f"{kernel}_launch")
    blocks = _build.persistent_blocks(kernel, bz, bx, torch.cuda.current_device())
    args = (
        counts32.data_ptr(), spans.data_ptr(),
        *(a.data_ptr() for a in arrays),
        *(None if t is None else t.data_ptr() for t in extra),
        jx.data_ptr(), jy.data_ptr(), jz.data_ptr(), cnt.data_ptr(),
        n_boxes, cap, tile, bz, bx, span_chunks, blocks, *scalars,
        torch.cuda.current_stream(device).cuda_stream,
    )

    def launch() -> None:
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"deposition kernel launch failed: cudaError {err}")
        for entry in counted:
            entry.launches += 1

    launch.tensors = (counts32, spans, arrays, extra)  # alive while args point at them
    return launch, (jx, jy, jz, cnt)


def deposition_launcher(
    counts: torch.Tensor,
    sz: torch.Tensor,
    sx: torch.Tensor,
    vx: torch.Tensor,
    vy: torch.Tensor,
    vz: torch.Tensor,
    *,
    grid: Grid2D,
    tile: int = DEPOSIT_TILE,
    tile_shape=None,
    cells_per_box: Optional[int] = None,
    span_chunks: int = SPAN_CHUNKS,
) -> Tuple[Callable[[], None], Tuple[torch.Tensor, ...]]:
    """Check CUDA arguments and prepare the kernel's launch: returns
    ``(launch, (jx, jy, jz, cnt))`` with zeroed tiles and the counters'
    grid term.  Each ``launch()`` launches ``csrc/deposition.cu`` once and
    adds into them.  :func:`deposit_local_tiles` calls it once; apart, it
    lets a timing cover the launch alone.  ``span_chunks`` is the span size
    of the work list."""
    return _launcher(
        "deposition", counts, (sz, sx, vx, vy, vz), (), (), (deposit_local_tiles,),
        grid=grid, tile=tile, tile_shape=tile_shape, cells_per_box=cells_per_box,
        span_chunks=span_chunks,
    )


def deposition_from_momenta_launcher(
    counts: torch.Tensor,
    sz: torch.Tensor,
    sx: torch.Tensor,
    ux: torch.Tensor,
    uy: torch.Tensor,
    uz: torch.Tensor,
    w: torch.Tensor,
    *,
    q,
    scale: float,
    volume: float,
    live: Optional[torch.Tensor] = None,
    grid: Grid2D,
    tile: int = DEPOSIT_TILE,
    tile_shape=None,
    cells_per_box: Optional[int] = None,
    span_chunks: int = SPAN_CHUNKS,
) -> Tuple[Callable[[], None], Tuple[torch.Tensor, ...]]:
    """:func:`deposition_launcher` for the momenta form: each ``launch()``
    runs the kernel that computes the lanes' values from ``ux, uy, uz, w``
    (:func:`deposit_local_tiles_from_momenta` says how)."""
    if live is not None and (
        live.shape != sz.shape or live.dtype != torch.bool or not live.is_contiguous()
        or live.device != sz.device
    ):
        raise ValueError(
            f"live must be a contiguous bool {tuple(sz.shape)} mask on {sz.device}, got "
            f"{tuple(live.shape)} {live.dtype} on {live.device}"
        )
    return _launcher(
        "deposition_from_momenta", counts, (sz, sx, ux, uy, uz, w),
        (scalar_tensor(q, sz.device), live), (float(scale), float(volume)),
        (deposit_local_tiles, deposit_local_tiles_from_momenta),
        grid=grid, tile=tile, tile_shape=tile_shape, cells_per_box=cells_per_box,
        span_chunks=span_chunks,
    )


def deposit_local_tiles(
    counts: torch.Tensor,
    sz: torch.Tensor,
    sx: torch.Tensor,
    vx: torch.Tensor,
    vy: torch.Tensor,
    vz: torch.Tensor,
    *,
    grid: Grid2D,
    tile: int = DEPOSIT_TILE,
    tile_shape=None,
    cells_per_box: Optional[int] = None,
):
    """Deposit every box's particles into its (BZ, BX) current tiles.

    ``vx, vy, vz`` are the per-lane current values q·w·v/γ / cell volume
    (zero for padding).  Returns ``(jx, jy, jz)`` tiles and the per-box
    int32 work counters.  ``tile_shape`` overrides the tile extents;
    ``cells_per_box`` overrides the counter's grid-work term so counters
    stay bit-identical to ``box_work_counters`` on padded tiles.

    CUDA tensors launch the kernel: persistent blocks walk the span work
    list (:func:`._tensors.span_table`), each accumulating into its own
    shared tiles and adding them to the zeroed output tiles with atomics
    when its box changes, so J's last bits vary from run to run.  CPU
    tensors run the plain version.
    """
    device = sz.device
    if device.type == "cpu":
        return deposit_local_tiles_plain(
            counts, sz, sx, vx, vy, vz, grid=grid, tile=tile,
            tile_shape=tile_shape, cells_per_box=cells_per_box,
        )
    if device.type != "cuda":
        raise ValueError(f"deposit_local_tiles runs on cuda or cpu tensors, got {device}")
    launch, out = deposition_launcher(
        counts, sz, sx, vx, vy, vz, grid=grid, tile=tile,
        tile_shape=tile_shape, cells_per_box=cells_per_box,
    )
    launch()
    return out


#: launches of the CUDA kernel in this process by either form (the plain
#: versions do not count)
deposit_local_tiles.launches = 0


def deposit_local_tiles_from_momenta_plain(
    counts: torch.Tensor,
    sz: torch.Tensor,
    sx: torch.Tensor,
    ux: torch.Tensor,
    uy: torch.Tensor,
    uz: torch.Tensor,
    w: torch.Tensor,
    *,
    q,
    scale: float,
    volume: float,
    live: Optional[torch.Tensor] = None,
    grid: Grid2D,
    tile: int = DEPOSIT_TILE,
    tile_shape=None,
    cells_per_box: Optional[int] = None,
):
    """Plain PyTorch version of the momenta form (any device): the values
    over every lane, then :func:`deposit_local_tiles_plain`."""
    if live is None:
        live = torch.arange(sz.shape[1], device=sz.device)[None, :] < counts[:, None]
    gamma = torch.sqrt(1.0 + ux**2 + uy**2 + uz**2)
    coef = ((q * w) * scale) / (gamma * volume)
    del gamma
    zero = torch.zeros((), dtype=torch.float32, device=sz.device)
    values = [torch.where(live, coef * u, zero) for u in (ux, uy, uz)]
    del coef
    return deposit_local_tiles_plain(
        counts, sz, sx, *values, grid=grid, tile=tile,
        tile_shape=tile_shape, cells_per_box=cells_per_box,
    )


def deposit_local_tiles_from_momenta(
    counts: torch.Tensor,
    sz: torch.Tensor,
    sx: torch.Tensor,
    ux: torch.Tensor,
    uy: torch.Tensor,
    uz: torch.Tensor,
    w: torch.Tensor,
    *,
    q,
    scale: float,
    volume: float,
    live: Optional[torch.Tensor] = None,
    grid: Grid2D,
    tile: int = DEPOSIT_TILE,
    tile_shape=None,
    cells_per_box: Optional[int] = None,
):
    """:func:`deposit_local_tiles` with each lane's values computed from its
    pushed momenta ``ux, uy, uz`` and weight ``w``, in float32:

        gamma = sqrt(((1 + ux²) + uy²) + uz²)
        coef  = ((q·w)·scale) / (gamma·volume)
        v     = where(live, coef·u, 0)

    ``q`` is the species' charge, a device tensor on the hot path (never
    fetched to the host).  ``live`` is a bool (B, cap) mask, or None for
    ``lane < counts``.  The binned path gives ``scale=1, volume=dz·dx``,
    the slot path ``scale=1/(dz·dx), volume=1``: the glue each ran before,
    operation for operation.  A lane that is not live adds zero whatever
    its momenta or weight hold.  CUDA tensors launch the kernel, which
    evaluates this only for the lanes it executes; CPU tensors run
    :func:`deposit_local_tiles_from_momenta_plain`.
    """
    kw = dict(
        q=q, scale=scale, volume=volume, live=live, grid=grid, tile=tile,
        tile_shape=tile_shape, cells_per_box=cells_per_box,
    )
    device = sz.device
    if device.type == "cpu":
        return deposit_local_tiles_from_momenta_plain(counts, sz, sx, ux, uy, uz, w, **kw)
    if device.type != "cuda":
        raise ValueError(
            f"deposit_local_tiles_from_momenta runs on cuda or cpu tensors, got {device}"
        )
    launch, out = deposition_from_momenta_launcher(counts, sz, sx, ux, uy, uz, w, **kw)
    launch()
    return out


#: launches of the CUDA kernel's momenta form in this process (each also
#: counts in ``deposit_local_tiles.launches``)
deposit_local_tiles_from_momenta.launches = 0
