"""Fused staggered field gather + Boris push + move, per box.

Counterpart of ``repro.kernels.gather_push`` (the TPU kernel
``_gather_push_kernel``).  :func:`gather_push_move_` updates the binned
arrays in place: it launches the CUDA kernel ``csrc/gather_push.cu`` for
CUDA tensors and runs :func:`gather_push_move_plain`, the same contract in
plain PyTorch, for CPU tensors.  :func:`gather_push_move` is the JAX
function's form, on copies.  On the H100 the kernel is bound by its
shared-memory gathers and arithmetic over the executed lanes; its source
note says how the design spreads them over all SMs.  Gather staggering
pairs (z, x):

    ex (0,1/2)  ey (0,0)  ez (1/2,0)  bx (1/2,0)  by (1/2,1/2)  bz (0,1/2)
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from ..pic.grid import Grid2D
from ._tensors import SPAN_CHUNKS, check_binned, plain_box_groups, scalar_tensor, span_table
from .common import HALO, cubic_weights
from .constants import DEPOSIT_TILE, PUSH_OPS

__all__ = ["gather_push_move", "gather_push_move_", "gather_push_move_plain", "gather_push_launcher"]


def _geometry(grid: Grid2D, tile_shape, dt: float):
    if tile_shape is None:
        bz, bx = grid.box_nz + 2 * HALO, grid.box_nx + 2 * HALO
    else:
        bz, bx = (int(v) for v in tile_shape)
    dt = float(dt)
    return bz, bx, dt, dt / grid.dz, dt / grid.dx


def _executed_lanes(counts: torch.Tensor, cap: int, tile: int) -> torch.Tensor:
    """(B,) number of lanes in executed chunks: ceil(count / tile) * tile,
    at most cap (the kernel's chunk loop)."""
    chunks = torch.clamp((counts.long() + tile - 1) // tile, 0, cap // tile)
    return chunks * tile


def _stencil_gather(t, iz, wz, ix, wx, bz, bx):
    """sum_l (sum_k wz_k F[iz+k, ix+l]) wx_l with out-of-tile points dropped.
    ``t`` is (G, bz*bx); the index/weight tensors are (G, L) / (G, L, 4)."""
    acc = torch.zeros_like(wz[..., 0])
    for l in range(4):
        col = ix + l
        col_ok = (col >= 0) & (col < bx)
        zi = torch.zeros_like(acc)
        for k in range(4):
            row = iz + k
            ok = col_ok & (row >= 0) & (row < bz)
            v = torch.gather(t, 1, torch.where(ok, row * bx + col, 0))
            term = wz[..., k] * v
            zi = zi + torch.where(ok, term, torch.zeros_like(term))
        acc = acc + zi * wx[..., l]
    return acc


def gather_push_move_plain(
    counts: torch.Tensor,
    sz: torch.Tensor,
    sx: torch.Tensor,
    ux: torch.Tensor,
    uy: torch.Tensor,
    uz: torch.Tensor,
    field_tiles: Sequence[torch.Tensor],
    *,
    grid: Grid2D,
    qm,
    dt: float,
    tile: int = DEPOSIT_TILE,
    tile_shape=None,
):
    """Plain PyTorch version of the kernel's contract (any device)."""
    n_boxes, cap = check_binned(counts, (sz, sx, ux, uy, uz), tile)
    bz, bx, dt, dt_over_dz, dt_over_dx = _geometry(grid, tile_shape, dt)
    qmdt2 = scalar_tensor(qm, sz.device).reshape(()) * (0.5 * dt)
    exec_lanes = _executed_lanes(counts, cap, tile)
    # lanes past every box's last executed chunk only pass through
    n_run = int(exec_lanes.max()) if n_boxes else 0
    outs = [a.clone() for a in (sz, sx, ux, uy, uz)]
    tiles = [t.reshape(n_boxes, bz * bx) for t in field_tiles]
    lane = torch.arange(n_run, device=sz.device)
    for b in plain_box_groups(n_boxes, n_run):
        g = (b, slice(0, n_run))
        s_z, s_x = sz[g], sx[g]
        iz0, wz0 = cubic_weights(s_z)
        iz5, wz5 = cubic_weights(s_z - 0.5)
        ix0, wx0 = cubic_weights(s_x)
        ix5, wx5 = cubic_weights(s_x - 0.5)
        t_ex, t_ey, t_ez, t_bx, t_by, t_bz = (t[b] for t in tiles)
        ex = _stencil_gather(t_ex, iz0, wz0, ix5, wx5, bz, bx)
        ey = _stencil_gather(t_ey, iz0, wz0, ix0, wx0, bz, bx)
        ez = _stencil_gather(t_ez, iz5, wz5, ix0, wx0, bz, bx)
        bxp = _stencil_gather(t_bx, iz5, wz5, ix0, wx0, bz, bx)
        byp = _stencil_gather(t_by, iz5, wz5, ix5, wx5, bz, bx)
        bzp = _stencil_gather(t_bz, iz0, wz0, ix5, wx5, bz, bx)

        umx = ux[g] + qmdt2 * ex
        umy = uy[g] + qmdt2 * ey
        umz = uz[g] + qmdt2 * ez
        gamma_m = torch.sqrt(1.0 + umx * umx + umy * umy + umz * umz)
        tx = qmdt2 / gamma_m * bxp
        ty = qmdt2 / gamma_m * byp
        tz = qmdt2 / gamma_m * bzp
        t2 = tx * tx + ty * ty + tz * tz
        upx = umx + (umy * tz - umz * ty)
        upy = umy + (umz * tx - umx * tz)
        upz = umz + (umx * ty - umy * tx)
        s = 2.0 / (1.0 + t2)
        ux_n = umx + s * (upy * tz - upz * ty) + qmdt2 * ex
        uy_n = umy + s * (upz * tx - upx * tz) + qmdt2 * ey
        uz_n = umz + s * (upx * ty - upy * tx) + qmdt2 * ez
        gamma = torch.sqrt(1.0 + ux_n * ux_n + uy_n * uy_n + uz_n * uz_n)
        sz_n = s_z + dt_over_dz * uz_n / gamma
        sx_n = s_x + dt_over_dx * ux_n / gamma

        run = lane[None, :] < exec_lanes[b][:, None]
        for out, new, old in zip(outs, (sz_n, sx_n, ux_n, uy_n, uz_n), (s_z, s_x, ux[g], uy[g], uz[g])):
            out[g] = torch.where(run, new, old)
    cnt = (exec_lanes * PUSH_OPS).to(torch.int32)
    return (*outs, cnt)


def gather_push_launcher(
    counts: torch.Tensor,
    arrays: Sequence[torch.Tensor],
    field_tiles: Sequence[torch.Tensor],
    *,
    grid: Grid2D,
    qm,
    dt: float,
    tile: int = DEPOSIT_TILE,
    tile_shape=None,
    span_chunks: int = SPAN_CHUNKS,
) -> Tuple[Callable[[], None], torch.Tensor]:
    """Check CUDA arguments and prepare the kernel's launch on ``arrays``
    (sz, sx, ux, uy, uz): returns ``(launch, cnt)``.  Each ``launch()``
    launches ``csrc/gather_push.cu`` once, pushing the arrays in place and
    adding the executed work to ``cnt`` (zeros until the first launch).
    :func:`gather_push_move_` calls it once; apart, it lets a timing cover
    the launch alone.  ``span_chunks`` is the span size of the work list."""
    from ._build import load_library, persistent_blocks

    arrays = tuple(arrays)
    device = arrays[0].device
    if device.type != "cuda":
        raise ValueError(f"the gather_push kernel runs on cuda tensors, got {device}")
    n_boxes, cap = check_binned(counts, arrays, tile)
    bz, bx, dt, dt_over_dz, dt_over_dx = _geometry(grid, tile_shape, dt)
    tiles = tuple(field_tiles)
    if len(tiles) != 6:
        raise ValueError(f"expected six field tiles, got {len(tiles)}")
    for t in tiles:
        if t.shape != (n_boxes, bz, bx) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"field tiles must be contiguous float32 {(n_boxes, bz, bx)}, got "
                f"{tuple(t.shape)} {t.dtype}"
            )
        if t.device != device:
            raise ValueError("field tiles and particles must share a device")
    counts32 = counts.to(device=device, dtype=torch.int32).contiguous()
    spans = span_table(counts32, cap, tile, span_chunks)
    qm_t = scalar_tensor(qm, device)
    cnt = torch.zeros(n_boxes, dtype=torch.int32, device=device)
    lib = load_library()
    blocks = persistent_blocks("gather_push", bz, bx, torch.cuda.current_device())
    args = (
        counts32.data_ptr(), spans.data_ptr(), qm_t.data_ptr(),
        *(a.data_ptr() for a in arrays),
        *(t.data_ptr() for t in tiles), cnt.data_ptr(),
        n_boxes, cap, tile, bz, bx, span_chunks, blocks,
        float(np.float32(0.5 * dt)), dt_over_dz, dt_over_dx,
        torch.cuda.current_stream(device).cuda_stream,
    )

    def launch() -> None:
        err = lib.gather_push_launch(*args)
        if err != 0:
            raise RuntimeError(f"gather_push kernel launch failed: cudaError {err}")
        gather_push_move.launches += 1

    launch.tensors = (counts32, spans, qm_t, arrays, tiles)  # alive while args point at them
    return launch, cnt


def gather_push_move_(
    counts: torch.Tensor,
    sz: torch.Tensor,
    sx: torch.Tensor,
    ux: torch.Tensor,
    uy: torch.Tensor,
    uz: torch.Tensor,
    field_tiles: Sequence[torch.Tensor],
    *,
    grid: Grid2D,
    qm,
    dt: float,
    tile: int = DEPOSIT_TILE,
    tile_shape=None,
) -> torch.Tensor:
    """Push the binned ``(sz, sx, ux, uy, uz)`` in place and return the
    per-box int32 counters.

    Inputs are the binned layout: ``counts`` (B,) alive particles per box,
    particle arrays (B, cap) in local cell units with the halo as origin,
    and six (B, BZ, BX) field tiles (ex, ey, ez, bx, by, bz).  ``qm`` is the
    species' charge/mass ratio, a device tensor on the hot path (never
    fetched to the host).  ``tile_shape`` overrides (BZ, BX).

    In place, unlike the JAX function, to save memory: the arrays end up
    holding what the JAX function returns, and the lanes of chunks that do
    not run are never touched, so the kernel moves only the executed lanes'
    bytes.  CUDA tensors launch ``csrc/gather_push.cu``: persistent blocks
    walk the span work list (:func:`._tensors.span_table`), loading a box's
    six tiles into shared memory when their box changes.  CPU tensors run
    :func:`gather_push_move_plain` and copy its result into the arrays.
    """
    arrays = (sz, sx, ux, uy, uz)
    device = sz.device
    if device.type == "cpu":
        *outs, cnt = gather_push_move_plain(
            counts, *arrays, field_tiles,
            grid=grid, qm=qm, dt=dt, tile=tile, tile_shape=tile_shape,
        )
        for a, out in zip(arrays, outs):
            a.copy_(out)
        return cnt
    if device.type != "cuda":
        raise ValueError(f"gather_push_move_ runs on cuda or cpu tensors, got {device}")
    launch, cnt = gather_push_launcher(
        counts, arrays, field_tiles, grid=grid, qm=qm, dt=dt, tile=tile, tile_shape=tile_shape
    )
    launch()
    return cnt


def gather_push_move(
    counts: torch.Tensor,
    sz: torch.Tensor,
    sx: torch.Tensor,
    ux: torch.Tensor,
    uy: torch.Tensor,
    uz: torch.Tensor,
    field_tiles: Sequence[torch.Tensor],
    *,
    grid: Grid2D,
    qm,
    dt: float,
    tile: int = DEPOSIT_TILE,
    tile_shape=None,
) -> Tuple[torch.Tensor, ...]:
    """Updated binned ``(sz, sx, ux, uy, uz)`` and per-box int32 counters,
    the JAX function's form: :func:`gather_push_move_` on copies."""
    outs = [a.clone() for a in (sz, sx, ux, uy, uz)]
    cnt = gather_push_move_(
        counts, *outs, field_tiles, grid=grid, qm=qm, dt=dt, tile=tile, tile_shape=tile_shape
    )
    return (*outs, cnt)


#: launches of the CUDA kernel in this process by either form (the plain
#: version does not count)
gather_push_move.launches = 0
