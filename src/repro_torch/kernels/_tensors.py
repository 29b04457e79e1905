"""Argument checks and helpers shared by the kernel wrappers."""
from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import torch

__all__ = ["check_binned", "scalar_tensor", "plain_box_groups", "span_table", "SPAN_CHUNKS"]

#: chunks per span of the CUDA kernels' work list: the wrappers build the
#: table with it and pass it to the kernels (csrc/common.cuh)
SPAN_CHUNKS = 8

#: lanes per group in the plain versions: bounds their temporaries
#: (tens of (boxes, cap) float32 arrays) at full size
_PLAIN_GROUP_LANES = 1 << 24


def check_binned(
    counts: torch.Tensor, arrays: Sequence[torch.Tensor], tile: int
) -> Tuple[int, int]:
    """Validate the binned layout and return ``(n_boxes, cap)``."""
    first = arrays[0]
    if first.dim() != 2:
        raise ValueError(f"binned arrays must be (n_boxes, cap), got {tuple(first.shape)}")
    n_boxes, cap = first.shape
    if tile <= 0 or cap % tile:
        raise ValueError(f"cap ({cap}) must be a multiple of tile ({tile})")
    for a in arrays:
        if a.shape != first.shape or a.dtype != torch.float32 or not a.is_contiguous():
            raise ValueError(
                f"binned arrays must be contiguous float32 {tuple(first.shape)}, got "
                f"{tuple(a.shape)} {a.dtype} contiguous={a.is_contiguous()}"
            )
        if a.device != first.device:
            raise ValueError("binned arrays must share a device")
    if counts.shape != (n_boxes,) or counts.device != first.device:
        raise ValueError(f"counts must be ({n_boxes},) on {first.device}")
    return n_boxes, cap


def scalar_tensor(v, device: torch.device) -> torch.Tensor:
    """A one-element float32 tensor on ``device``.  A tensor already there
    is used as is; a Python number is written by a fill, not copied from the
    host, so it costs no host synchronisation."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32).reshape(1).contiguous()
    return torch.full((1,), float(v), dtype=torch.float32, device=device)


def plain_box_groups(n_boxes: int, cap: int) -> Iterator[slice]:
    """Slices of boxes that the plain versions process together."""
    per = max(1, _PLAIN_GROUP_LANES // max(cap, 1))
    for b0 in range(0, n_boxes, per):
        yield slice(b0, min(n_boxes, b0 + per))


def span_table(
    counts: torch.Tensor, cap: int, tile: int, span_chunks: int = SPAN_CHUNKS
) -> torch.Tensor:
    """The CUDA kernels' span work list: the ``(n_boxes + 1,)`` int32
    exclusive prefix over boxes of ``ceil(chunks / span_chunks)``, where a
    box runs ``chunks = min(ceil(count / tile), cap / tile)`` chunks.  Entry
    ``n_boxes`` is the total.  Built on ``counts``' device without a host
    synchronisation; a kernel given the table is given the same
    ``span_chunks`` (``csrc/common.cuh`` says how the kernels walk it)."""
    if span_chunks < 1:
        raise ValueError(f"span_chunks must be at least 1, got {span_chunks}")
    chunks = torch.clamp((counts.to(torch.int32) + (tile - 1)) // tile, 0, cap // tile)
    spans = (chunks + (span_chunks - 1)) // span_chunks
    table = torch.zeros(counts.shape[0] + 1, dtype=torch.int32, device=counts.device)
    table[1:] = torch.cumsum(spans, 0, dtype=torch.int32)
    return table
