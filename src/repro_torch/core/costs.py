"""In-situ cost measurement strategies (paper §2.2).

The port's own numpy copy of ``repro.core.costs`` (the port imports nothing
of the JAX package); the CUDA kernels in ``repro_torch.kernels`` produce the
work counters this module consumes.

The paper implements three GPU-amenable strategies to estimate the compute
work associated with a box:

  * ``Heuristic``      — weighted linear sum of particle and cell counts
                         (user-tuned weights; Summit defaults 0.75/0.25).
  * ``GPU clock``      — in-kernel ``clock()`` accumulation of thread-summed
                         execution time.  TPU adaptation: **work counters**
                         accumulated inside the Pallas kernel (see
                         ``repro.kernels.deposition``); this module consumes
                         the per-box counter values.
  * ``CUPTI``          — kernel activity records via a profiling callback API.
                         TPU adaptation: ``ActivityLedger`` — a callback-style
                         ledger of (name, start, end) activity records fed by
                         host-side dispatch/block_until_ready timestamps and
                         XLA cost-analysis FLOP records.

All strategies produce a ``np.ndarray`` of shape ``(n_boxes,)`` of
non-negative costs; the LoadBalancer is agnostic to the source.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "CostMeasure",
    "HeuristicCost",
    "WorkCounterCost",
    "ActivityRecord",
    "ActivityLedger",
    "ActivityLedgerCost",
    "EMASmoother",
    "normalize_costs",
]


def normalize_costs(costs: np.ndarray) -> np.ndarray:
    """Normalize costs to sum to 1 (scale-free; E is scale invariant anyway)."""
    costs = np.asarray(costs, dtype=np.float64)
    total = costs.sum()
    if total <= 0.0:
        # Degenerate: no measured work anywhere — treat all boxes equally.
        return np.full_like(costs, 1.0 / max(len(costs), 1))
    return costs / total


class CostMeasure:
    """Interface: produce per-box costs for the current LB round."""

    #: True if the strategy needs no user-facing hyperparameters (paper's
    #: key distinction between heuristic and in-situ measurement).
    hyperparameter_free: bool = False

    def measure(self, **observations) -> np.ndarray:  # pragma: no cover - interface
        """Return non-negative per-box costs, shape ``(n_boxes,)``.

        ``observations`` are strategy-specific keyword inputs (counts,
        counters, ledger handles); unknown keys must be ignored so one
        call site can serve every strategy."""
        raise NotImplementedError


@dataclass
class HeuristicCost(CostMeasure):
    """Weighted linear sum of particles and cells per box (paper §2.2).

    ``cost_b = particle_weight * n_particles_b + cell_weight * n_cells_b``

    The paper's Summit-calibrated weights are 0.75/0.25 (FDTD solver,
    third-order shapes); optimal weights vary with hardware and algorithm,
    which is exactly the limitation the in-situ strategies remove.
    """

    particle_weight: float = 0.75
    cell_weight: float = 0.25
    hyperparameter_free: bool = False

    def measure(self, *, n_particles: np.ndarray, n_cells: np.ndarray, **_) -> np.ndarray:
        """Raw weighted sum — deliberately NO per-component normalization.

        The weights are calibrated per-unit-walltime of one particle / one
        cell (as in WarpX), so ``w_p * n_p + w_c * n_c`` is already in
        consistent (arbitrary) time units; rescaling each component by its
        population total would silently change the particle:cell balance
        with the population ratio and hence the LB decisions.  Pinned by
        ``tests/test_core_costs.py::test_heuristic_is_raw_weighted_sum``.
        """
        n_particles = np.asarray(n_particles, dtype=np.float64)
        n_cells = np.asarray(n_cells, dtype=np.float64)
        if n_particles.shape != n_cells.shape:
            raise ValueError(
                f"per-box particle/cell count shapes differ: {n_particles.shape} vs {n_cells.shape}"
            )
        return self.particle_weight * n_particles + self.cell_weight * n_cells


@dataclass
class WorkCounterCost(CostMeasure):
    """TPU-native analogue of the paper's *GPU clock* strategy.

    The Pallas deposition kernel counts, per box, the number of executed
    work units (particle-deposit inner-loop operations).  On a TPU the
    per-lane throughput is deterministic (no warp divergence / occupancy
    noise), so executed-work counts are proportional to device time; the
    counter is therefore an *exact*, hyperparameter-free in-situ measure.

    ``measure`` simply validates and forwards the counters; an optional
    ``per_unit_time`` converts counts to seconds for reporting.
    """

    per_unit_time: float = 1.0
    hyperparameter_free: bool = True

    def measure(self, *, work_counters: np.ndarray, **_) -> np.ndarray:
        """Validate and forward per-box executed-work counters (optionally
        scaled to seconds by ``per_unit_time``)."""
        counters = np.asarray(work_counters, dtype=np.float64)
        if np.any(counters < 0):
            raise ValueError("work counters must be non-negative")
        return counters * self.per_unit_time


@dataclass(frozen=True)
class ActivityRecord:
    """One kernel activity record (mirrors a CUPTI activity record)."""

    name: str
    box: int
    start: float
    end: float

    @property
    def duration(self) -> float:
        return self.end - self.start


class ActivityLedger:
    """Callback-style activity-record collection (paper's CUPTI strategy).

    CUPTI delivers buffers of kernel activity records through registered
    callbacks.  The TPU/JAX adaptation: clients wrap per-box device work in
    :meth:`timed`; completed records are staged into a bounded buffer and, on
    buffer-full (or explicit :meth:`flush`), delivered to registered
    callbacks — reproducing the request/deliver buffer flow of the paper's
    Fig. 2(b).  The measured overhead of this strategy (host sync per box) is
    what reproduces the paper's "CUPTI is ~2x slower" finding.
    """

    def __init__(self, buffer_records: int = 256):
        if buffer_records <= 0:
            raise ValueError("buffer_records must be positive")
        self._buffer_records = buffer_records
        self._buffer: List[ActivityRecord] = []
        self._callbacks: List[Callable[[List[ActivityRecord]], None]] = []
        self._delivered: List[ActivityRecord] = []
        self.n_flushes = 0

    # -- callback registration (CUPTI: cuptiActivityRegisterCallbacks) ------
    def register_callback(self, fn: Callable[[List[ActivityRecord]], None]) -> None:
        """Register a buffer-completed callback; each :meth:`flush` delivers
        the staged records to every registered callback."""
        self._callbacks.append(fn)

    # -- record production ---------------------------------------------------
    def record(self, name: str, box: int, start: float, end: float) -> None:
        """Stage one (kernel, box, start, end) activity record; the buffer
        auto-flushes when ``buffer_records`` records have accumulated."""
        if end < start:
            raise ValueError("activity record with end < start")
        self._buffer.append(ActivityRecord(name, box, start, end))
        if len(self._buffer) >= self._buffer_records:
            self.flush()

    class _Timed:
        def __init__(self, ledger: "ActivityLedger", name: str, box: int):
            self._ledger, self._name, self._box = ledger, name, box

        def __enter__(self):
            self._start = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self._ledger.record(self._name, self._box, self._start, time.perf_counter())
            return False

    def timed(self, name: str, box: int) -> "ActivityLedger._Timed":
        """Context manager measuring one kernel launch for one box."""
        return ActivityLedger._Timed(self, name, box)

    # -- buffer delivery (CUPTI: bufferCompleted callback) --------------------
    def flush(self) -> None:
        """Deliver staged records to the registered callbacks (the CUPTI
        ``bufferCompleted`` moment) and archive them for aggregation."""
        if not self._buffer:
            return
        batch, self._buffer = self._buffer, []
        self.n_flushes += 1
        self._delivered.extend(batch)
        for fn in self._callbacks:
            fn(batch)

    # -- aggregation -----------------------------------------------------------
    def box_durations(self, n_boxes: int, kernel: Optional[str] = None) -> np.ndarray:
        """Sum recorded kernel durations per box (the paper uses the current-
        deposition kernel's duration as the cost proxy)."""
        self.flush()
        out = np.zeros(n_boxes, dtype=np.float64)
        for rec in self._delivered:
            if kernel is not None and rec.name != kernel:
                continue
            if 0 <= rec.box < n_boxes:
                out[rec.box] += rec.duration
        return out

    def reset(self) -> None:
        """Drop all staged and delivered records (start a fresh round)."""
        self._buffer.clear()
        self._delivered.clear()


@dataclass
class ActivityLedgerCost(CostMeasure):
    """Cost measure backed by an :class:`ActivityLedger` (CUPTI analogue)."""

    ledger: ActivityLedger
    kernel: Optional[str] = None
    reset_after_measure: bool = True
    hyperparameter_free: bool = True

    def measure(self, *, n_boxes: int, **_) -> np.ndarray:
        """Per-box summed kernel durations from the ledger (optionally
        clearing it afterwards, so each round measures fresh records)."""
        costs = self.ledger.box_durations(n_boxes, kernel=self.kernel)
        if self.reset_after_measure:
            self.ledger.reset()
        return costs


class EMASmoother:
    """Exponential smoothing of per-box costs across LB rounds.

    Not in the paper (costs there are single-interval sums); smoothing
    suppresses sampling noise in the timer-based strategies and is exposed
    as an option.  ``alpha=1`` reproduces the paper exactly.
    """

    def __init__(self, alpha: float = 1.0):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.alpha = float(alpha)
        self._state: Optional[np.ndarray] = None

    def update(self, costs: np.ndarray) -> np.ndarray:
        """Fold one round's costs into the EMA and return the smoothed
        vector (a shape change resets the state — e.g. after regridding)."""
        costs = np.asarray(costs, dtype=np.float64)
        if self._state is None or self._state.shape != costs.shape:
            self._state = costs.copy()
        else:
            self._state = self.alpha * costs + (1.0 - self.alpha) * self._state
        return self._state.copy()

    def reset(self) -> None:
        """Forget the smoothed state (next update starts fresh)."""
        self._state = None
