"""Helpers of ``repro.dist.box_runtime`` that the sharded runtime shares.

Only the halo floor and two host-side helpers live here so far.
``BoxRuntime`` itself, the reference's host-driven validation runtime (one
dispatch per box per step), is not ported yet (ROADMAP queue 1).
"""
from __future__ import annotations

import numpy as np

from ..pic.grid import Grid2D

__all__ = ["_MIN_HALO", "_round_up", "_np_box_ids"]

#: particle stencil support: gather and deposit reach at most 3 cells
#: outside a box (order-3 shape + one-step excursion), and the field
#: leapfrog needs 3 valid halo cells — 4 covers both with margin
_MIN_HALO = 4


def _round_up(n: int, quantum: int) -> int:
    return max(quantum, int(-(-n // quantum) * quantum))


def _np_box_ids(z: np.ndarray, x: np.ndarray, grid: Grid2D) -> np.ndarray:
    """NumPy twin of ``Grid2D.box_of_position`` for host-side packing."""
    bz = np.clip((z / (grid.dz * grid.box_nz)).astype(np.int64), 0, grid.boxes_z - 1)
    bx = np.clip((x / (grid.dx * grid.box_nx)).astype(np.int64), 0, grid.boxes_x - 1)
    return bz * grid.boxes_x + bx
