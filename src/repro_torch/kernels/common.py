"""Shared helpers of the PIC kernels (counterpart of ``repro.kernels.common``).

The CUDA kernels evaluate the order-3 weights in ``csrc/common.cuh``;
:func:`cubic_weights` is the same arithmetic on tensors, used by the
kernels' plain PyTorch versions.  It follows the kernel-side formula
(``ax * ax`` and ``0.5 * ax * ax * ax``), not ``pic.shapes``'s ``ax**3``.

The TPU kernels expanded these weights into one-hot "P matrices" so that the
matrix unit could do scatter and gather as dense products.  On Hopper a
particle reads or writes its 16 stencil points directly in shared memory, so
that form is not carried over.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["HALO", "cubic_weights"]

# Halo sizing: a particle leaves its box by < 1 cell per step (CFL < 1);
# with the -1/2 staggered components the order-3 base index reaches
# floor(s - 0.5) - 1 >= -3 at the lower tile edge, so 3 halo cells are needed.
HALO = 3


def _spline(x: torch.Tensor) -> torch.Tensor:
    ax = torch.abs(x)
    inner = 2.0 / 3.0 - ax * ax + 0.5 * ax * ax * ax
    y = 2.0 - ax
    outer = y * y * y / 6.0
    zero = torch.zeros_like(ax)
    return torch.where(ax <= 1.0, inner, torch.where(ax <= 2.0, outer, zero))


def cubic_weights(s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Order-3 base index ``floor(s) - 1`` (int64) and the four weights
    (shape ``s.shape + (4,)``) for positions ``s`` in cell units."""
    i_floor = torch.floor(s)
    frac = s - i_floor
    w = torch.stack(
        [_spline(frac + 1.0), _spline(frac), _spline(1.0 - frac), _spline(2.0 - frac)],
        dim=-1,
    )
    return (i_floor - 1.0).long(), w
