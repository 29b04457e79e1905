"""Particle shape factors (B-spline weights) for gather and deposition.

Counterpart of ``repro.pic.shapes``: order 3 (the paper's) and order 1
(cloud-in-cell).  For spline order n a particle touches n+1 grid points per
dimension.  The arithmetic follows the reference term for term
(``ax**2``, ``ax**3``), so the weights agree to the last bit on the CPU.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["shape_weights", "SUPPORT"]

SUPPORT = {1: 2, 3: 4}


def _linear_weights(frac: torch.Tensor) -> torch.Tensor:
    """Order-1 (CIC): weights at offsets [0, 1] from the base index."""
    return torch.stack([1.0 - frac, frac], dim=-1)


def _cubic_bspline(x: torch.Tensor) -> torch.Tensor:
    """Cubic B-spline S3 evaluated at |x| <= 2."""
    ax = torch.abs(x)
    inner = 2.0 / 3.0 - ax**2 + 0.5 * ax**3
    outer = (2.0 - ax) ** 3 / 6.0
    zero = torch.zeros_like(ax)
    return torch.where(ax <= 1.0, inner, torch.where(ax <= 2.0, outer, zero))


def _cubic_weights(frac: torch.Tensor) -> torch.Tensor:
    """Order-3: weights at offsets [0, 1, 2, 3] from base index floor(s)-1;
    the grid points sit at distances (frac+1, frac, 1-frac, 2-frac)."""
    d = torch.stack([frac + 1.0, frac, 1.0 - frac, 2.0 - frac], dim=-1)
    return _cubic_bspline(d)


def shape_weights(
    pos: torch.Tensor, spacing: float, offset: float, order: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Base grid index (int64, shape (N,)) and weights (shape (N, order+1))
    for particles at physical positions ``pos`` along one axis, for a grid
    quantity staggered by ``offset`` cells."""
    if order not in SUPPORT:
        raise ValueError(f"unsupported shape order {order}; expected 1 or 3")
    s = pos / spacing - offset
    i_floor = torch.floor(s)
    frac = s - i_floor
    if order == 1:
        return i_floor.long(), _linear_weights(frac)
    return (i_floor - 1).long(), _cubic_weights(frac)
