"""Argument checks and helpers shared by the kernel wrappers."""
from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import torch

__all__ = ["check_binned", "scalar_tensor", "plain_box_groups"]

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
