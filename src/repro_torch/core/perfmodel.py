"""Strong-scaling performance model for load balancing (paper §4).

The port's own numpy copy of ``repro.core.perfmodel`` (the port imports
nothing of the JAX package).

The paper models walltime as ``t_wall ∝ n_nodes^-x`` (x=1 ideal; WarpX
measures x=0.91 in 2D3V, 0.88 in 3D3V) and derives the maximum speedup
attainable by perfect load balancing from an initial imbalance:

    S = (c_max0 / c_avg0)^x = (1 / E0)^x          (paper Eq. 2)

Load balancing is "strong scaling applied to the slowest device": the
device initially assigned c_max0 ends up with c_avg0, i.e. it is
strong-scaled by the imbalance ratio, discounted by the code's measured
scaling exponent.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

__all__ = [
    "fit_strong_scaling",
    "predicted_max_speedup",
    "fraction_of_predicted",
    "imbalance_summary",
    "StrongScalingModel",
]


def fit_strong_scaling(n_nodes: Sequence[float], walltimes: Sequence[float]) -> Tuple[float, float]:
    """Log-log least-squares fit of ``t_wall = A * n_nodes^-x``.

    Returns ``(x, A)``.  x in [0, 1] for realistic codes (1 = ideal).
    """
    n = np.asarray(n_nodes, dtype=np.float64)
    t = np.asarray(walltimes, dtype=np.float64)
    if n.shape != t.shape or n.ndim != 1 or len(n) < 2:
        raise ValueError("need >= 2 (n_nodes, walltime) samples of equal length")
    if np.any(n <= 0) or np.any(t <= 0):
        raise ValueError("n_nodes and walltimes must be positive")
    slope, intercept = np.polyfit(np.log(n), np.log(t), 1)
    return float(-slope), float(np.exp(intercept))


def predicted_max_speedup(initial_efficiency: float, x: float) -> float:
    """Paper Eq. 2: ``S = (1/E0)^x``."""
    if not 0.0 < initial_efficiency <= 1.0:
        raise ValueError("initial efficiency must be in (0, 1]")
    if x < 0.0:
        raise ValueError("scaling exponent x must be >= 0")
    return float((1.0 / initial_efficiency) ** x)


def fraction_of_predicted(
    measured_speedup: float, initial_efficiency: float, x: float
) -> float:
    """Measured LB speedup as a fraction of the Eq.-2 theoretical maximum
    — the paper's headline 62–88% statistic.

    Degenerate cases are well defined rather than singular: ``E0 = 1``
    (perfectly balanced start) or ``x = 0`` (no strong-scaling headroom)
    both give a predicted maximum of exactly 1, so the fraction equals the
    measured speedup itself — a no-op balancer on a balanced load reports
    ≈1.0, not inf/NaN.
    """
    if measured_speedup <= 0.0:
        raise ValueError("measured speedup must be positive")
    return measured_speedup / predicted_max_speedup(initial_efficiency, x)


def imbalance_summary(max_over_avg: Sequence[float]) -> dict:
    """Per-scenario imbalance character from a run's per-step
    ``c_max/c_avg`` history (``Simulation.history['max_over_avg']``).

    Returns the Eq.-2 inputs and how the imbalance evolved: ``e0``
    (initial efficiency, the paper's prediction basis), ``e_min``/
    ``e_mean`` over the run, and the raw ``imbalance0``/``imbalance_max``
    ratios.  A drifting hotspot shows ``imbalance_max`` well above
    ``imbalance0``; a static gradient holds both ≈ equal; a uniform load
    keeps everything ≈ 1.
    """
    r = np.asarray(max_over_avg, dtype=np.float64)
    if r.ndim != 1 or len(r) == 0:
        raise ValueError("need a non-empty 1-D max/avg history")
    if np.any(r < 1.0 - 1e-9):
        raise ValueError("max/avg ratios must be >= 1")
    r = np.maximum(r, 1.0)
    return {
        "e0": float(1.0 / r[0]),
        "e_min": float(1.0 / r.max()),
        "e_mean": float(np.mean(1.0 / r)),
        "imbalance0": float(r[0]),
        "imbalance_max": float(r.max()),
    }


@dataclass(frozen=True)
class StrongScalingModel:
    """Fitted model ``t_wall = A * n_nodes^-x`` with the paper's Eq.-2 helper."""

    x: float
    A: float

    @classmethod
    def fit(cls, n_nodes: Sequence[float], walltimes: Sequence[float]) -> "StrongScalingModel":
        x, A = fit_strong_scaling(n_nodes, walltimes)
        return cls(x=x, A=A)

    def walltime(self, n_nodes: float) -> float:
        return self.A * float(n_nodes) ** (-self.x)

    def max_speedup(self, initial_efficiency: float) -> float:
        return predicted_max_speedup(initial_efficiency, self.x)

    def attained_fraction(self, measured_speedup: float, initial_efficiency: float) -> float:
        """Fraction of the theoretical maximum achieved (paper reports 62-88%)."""
        return measured_speedup / self.max_speedup(initial_efficiency)
