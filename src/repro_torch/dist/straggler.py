"""Straggler detection from in-situ work/time observations (numpy copy of
``repro.dist.straggler``).

The paper measures *work* per box on device; dividing a device's summed
work by the wall time it took yields its observed throughput.  An EWMA of
that throughput, normalized to the fastest device, is a capacity vector the
capacity-aware knapsack (``repro_torch.core.policies.knapsack_partition``)
consumes directly — a slow device gets proportionally less work instead of
stalling every bulk-synchronous step.  This is the heterogeneous-worker
loop of Miller et al. (arXiv:2003.10406), driven by the paper's own cost
counters rather than a separate calibration run.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

__all__ = ["StragglerDetector"]


class StragglerDetector:
    """EWMA throughput tracker producing per-device capacities in (0, 1].

    Parameters
    ----------
    n_devices:  devices observed.
    alpha:      EWMA weight of the newest observation (1.0 = no smoothing).
    threshold:  a device is a straggler when its capacity falls below
                ``threshold`` times the median capacity.
    """

    def __init__(self, n_devices: int, alpha: float = 0.25, threshold: float = 0.7):
        if n_devices <= 0:
            raise ValueError("n_devices must be positive")
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.n_devices = n_devices
        self.alpha = alpha
        self.threshold = threshold
        self._throughput: Optional[np.ndarray] = None

    def update(self, work: np.ndarray, time_taken: np.ndarray) -> np.ndarray:
        """Fold one interval's observations; returns the capacity vector."""
        work = np.asarray(work, np.float64)
        time_taken = np.asarray(time_taken, np.float64)
        if work.shape != (self.n_devices,) or time_taken.shape != (self.n_devices,):
            raise ValueError(f"expected shape ({self.n_devices},) observations")
        throughput = work / np.maximum(time_taken, 1e-30)
        if self._throughput is None:
            self._throughput = throughput
        else:
            self._throughput = (
                (1.0 - self.alpha) * self._throughput + self.alpha * throughput
            )
        return self.capacities()

    def capacities(self) -> np.ndarray:
        """Per-device relative speeds, max-normalized to 1 (all ones before
        the first observation)."""
        if self._throughput is None:
            return np.ones(self.n_devices)
        top = self._throughput.max()
        if top <= 0.0:
            return np.ones(self.n_devices)
        return np.maximum(self._throughput / top, 1e-9)

    def stragglers(self) -> List[int]:
        """Devices currently below ``threshold`` x median capacity."""
        caps = self.capacities()
        cut = self.threshold * float(np.median(caps))
        return [i for i in range(self.n_devices) if caps[i] < cut]
