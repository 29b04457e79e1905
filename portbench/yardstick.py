"""The card's peaks and the work the PIC kernels must do, counted from
particles and cells (never from the program's own accounting).

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense,
float32 outside the tensor cores.  Per launch of one species over one step:

  * gather + push + move, in place: 5 floats read and written per executed
    lane, the six field tiles of each occupied box read, the counts read
    and the counters written; 512 float32 operations per executed lane;
  * deposition from the pushed momenta (``deposition_kernel<true>``, the
    form the step runs): 6 floats read per executed lane (z, x, ux, uy,
    uz, w), three current tiles of every box written, counts and
    counters; 324 operations per lane.  The slot path's mask byte is the
    program's layout, not work the step needs, and is not counted.

An executed lane is a particle lane of a started 256-lane chunk: a box of
n alive particles executes ceil(n / 256) · 256 lanes, whatever layout the
program keeps them in.  The operation counts per lane come from the CUDA
sources: four order-3 weight sets (202), six 4x4 gathers (240) and the
Boris push and move (70); three 4x4 scatters (108) and the lane's current
from its momenta (14: gamma's three squares, three adds and square root;
the three products of q·w·scale and gamma·volume and their divide; the
three components coef·u).

The whole step's bound (``step_bound_s``, which the PIC domain hands
``step_mfu`` for each traced step) counts alive particles, not lanes,
and adds the Yee update's field traffic: 6 fields and 3 currents read, 6
fields written, per cell.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = [
    "PEAK_BYTES_PER_S",
    "PEAK_FP32_PER_S",
    "bound_s",
    "gather_push_work",
    "deposition_work",
    "step_bound_s",
    "executed_lanes",
]

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
GATHER_PUSH_FLOPS_PER_LANE = 202 + 240 + 70
DEPOSITION_FLOPS_PER_LANE = 202 + 108 + 14
#: z, x, ux, uy, uz, w
DEPOSITION_BYTES_PER_LANE = 24
CHUNK = 256


def bound_s(n_bytes: float, n_flops: float) -> float:
    """The least time the card could take: bytes or operations, whichever
    bounds."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_flops / PEAK_FP32_PER_S)


def executed_lanes(counts: np.ndarray) -> np.ndarray:
    return np.ceil(np.asarray(counts, np.float64) / CHUNK) * CHUNK


def gather_push_work(counts: np.ndarray, tile_cells: int) -> Tuple[float, float]:
    """(bytes, operations) of one launch over per-box alive ``counts``."""
    counts = np.asarray(counts, np.float64)
    lanes = float(executed_lanes(counts).sum())
    occupied = float(np.count_nonzero(counts))
    n_bytes = 40 * lanes + 24 * tile_cells * occupied + 8 * counts.size
    return n_bytes, lanes * GATHER_PUSH_FLOPS_PER_LANE


def deposition_work(counts: np.ndarray, tile_cells: int) -> Tuple[float, float]:
    counts = np.asarray(counts, np.float64)
    lanes = float(executed_lanes(counts).sum())
    n_bytes = DEPOSITION_BYTES_PER_LANE * lanes + 12 * tile_cells * counts.size + 8 * counts.size
    return n_bytes, lanes * DEPOSITION_FLOPS_PER_LANE


def step_bound_s(alive: float, cells: int) -> float:
    """The physics bound of one whole step: both kernels over ``alive``
    particles (all species) plus the Yee update over ``cells`` cells."""
    push = bound_s(40 * alive, alive * GATHER_PUSH_FLOPS_PER_LANE)
    deposit = bound_s(DEPOSITION_BYTES_PER_LANE * alive, alive * DEPOSITION_FLOPS_PER_LANE)
    fields = bound_s(15 * 4 * cells, 0.0)
    return push + deposit + fields

