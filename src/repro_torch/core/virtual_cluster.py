"""Virtual-cluster execution model.

The paper's performance reasoning (Eq. 1/2, Figs. 5-8) is in terms of
per-device summed box costs: a step's walltime is set by the most-loaded
device, redistribution cost is data moved over interconnect, and the cost
gather is a small collective.  ``VirtualCluster`` evaluates exactly this
model, driven by *measured* per-box costs from the real (single-host) PIC
run, so LB algorithm quality can be studied for any device count on one
CPU.  ``tests/test_distributed_pic.py`` cross-validates the model against a
real 8-device run.

Model (all times in seconds):

    t_step   = max_g [ sum_{b in g} cost_b / cap_g ]            (compute)
             + comm_model(mapping)                              (halo exchange)
    t_lb     = gather_cost(n_boxes)                             (every LB call)
             + bytes_moved / bisection_bw   (only on adoption — redistribution,
                                             >=99.7% of LB time per the paper)

The halo-exchange model charges per-box surface bytes; neighbours on the
same device are free, remote neighbours cost bytes/link_bw, serialized per
device (bulk-synchronous).  This is what makes SFC locality measurable.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["VirtualCluster", "StepRecord"]


@dataclass(frozen=True)
class StepRecord:
    step: int
    compute_time: float
    comm_time: float
    lb_time: float
    efficiency: float


@dataclass
class VirtualCluster:
    """Evaluate the paper's walltime model for ``n_devices`` virtual devices.

    Parameters
    ----------
    n_devices:      virtual device count.
    link_bw:        per-link interconnect bandwidth, bytes/s (ICI ~50e9).
    bisection_bw:   aggregate bandwidth for redistribution traffic, bytes/s.
    gather_cost_per_box: cost-gather time per box (allgather of one float —
                    tiny; the paper measures <=2.3% of walltime at interval=1).
    capacities:     per-device speeds (1.0 nominal).
    """

    n_devices: int
    link_bw: float = 50e9
    bisection_bw: float = 200e9
    gather_cost_per_box: float = 2e-9
    capacities: Optional[np.ndarray] = None

    records: List[StepRecord] = field(default_factory=list)

    def _caps(self) -> np.ndarray:
        if self.capacities is None:
            return np.ones(self.n_devices)
        return np.asarray(self.capacities, dtype=np.float64)

    # ------------------------------------------------------------------
    def compute_time(self, costs: np.ndarray, mapping: np.ndarray) -> float:
        loads = np.zeros(self.n_devices)
        np.add.at(loads, np.asarray(mapping), np.asarray(costs, dtype=np.float64))
        loads = loads / self._caps()
        return float(np.max(loads)) if len(loads) else 0.0

    def comm_time(
        self,
        mapping: np.ndarray,
        neighbors: Optional[Sequence[Sequence[int]]] = None,
        surface_bytes: Optional[np.ndarray] = None,
    ) -> float:
        """Halo-exchange time: per device, sum of surface bytes sent to boxes
        owned by *other* devices, divided by link bandwidth; max over devices."""
        if neighbors is None or surface_bytes is None:
            return 0.0
        mapping = np.asarray(mapping)
        out_bytes = np.zeros(self.n_devices)
        for b, nbrs in enumerate(neighbors):
            for nb in nbrs:
                if mapping[b] != mapping[nb]:
                    out_bytes[mapping[b]] += surface_bytes[b]
        return float(np.max(out_bytes) / self.link_bw) if len(out_bytes) else 0.0

    def lb_time(self, n_boxes: int, bytes_moved: float) -> float:
        gather = self.gather_cost_per_box * n_boxes * np.log2(max(self.n_devices, 2))
        redistribute = bytes_moved / self.bisection_bw
        return float(gather + redistribute)

    # ------------------------------------------------------------------
    def record_step(
        self,
        step: int,
        costs: np.ndarray,
        mapping: np.ndarray,
        *,
        neighbors: Optional[Sequence[Sequence[int]]] = None,
        surface_bytes: Optional[np.ndarray] = None,
        lb_bytes_moved: float = 0.0,
        lb_called: bool = False,
    ) -> StepRecord:
        return self.record_interval(
            step,
            np.asarray(costs, dtype=np.float64)[None, :],
            mapping,
            neighbors=neighbors,
            surface_bytes=surface_bytes,
            lb_bytes_moved=lb_bytes_moved,
            lb_called=lb_called,
        )[0]

    def record_interval(
        self,
        start_step: int,
        costs: np.ndarray,
        mapping: np.ndarray,
        *,
        neighbors: Optional[Sequence[Sequence[int]]] = None,
        surface_bytes: Optional[np.ndarray] = None,
        lb_bytes_moved: float = 0.0,
        lb_called: bool = False,
    ) -> List[StepRecord]:
        """Replay a whole LB round of steps in bulk.

        ``costs`` has shape ``(n_steps, n_boxes)`` — the per-step true-cost
        history fetched from the device in one sync (see
        ``repro.pic.engine``).  The mapping is constant within a round (it
        only changes at round boundaries), so halo-comm time is evaluated
        once and per-step loads come from a single vectorized scatter; the
        LB charge (gather + redistribution) lands on the round's first step.
        Appends and returns one :class:`StepRecord` per step, identical to
        calling :meth:`record_step` step by step.
        """
        costs = np.asarray(costs, dtype=np.float64)
        if costs.ndim != 2:
            raise ValueError(f"costs must be (n_steps, n_boxes), got {costs.shape}")
        mapping = np.asarray(mapping)
        n_steps, n_boxes = costs.shape
        onehot = (mapping[:, None] == np.arange(self.n_devices)[None, :]).astype(
            np.float64
        )
        loads = (costs @ onehot) / self._caps()[None, :]  # (n_steps, n_devices)
        comp = loads.max(axis=1)
        mean = loads.mean(axis=1)
        comm = self.comm_time(mapping, neighbors, surface_bytes)
        recs = []
        for i in range(n_steps):
            lbt = self.lb_time(n_boxes, lb_bytes_moved) if (lb_called and i == 0) else 0.0
            mx = float(comp[i])
            eff = float(mean[i]) / mx if mx > 0 else 1.0
            recs.append(StepRecord(int(start_step) + i, mx, comm, lbt, eff))
        self.records.extend(recs)
        return recs

    # -- aggregates ------------------------------------------------------
    @property
    def walltime(self) -> float:
        return sum(r.compute_time + r.comm_time + r.lb_time for r in self.records)

    @property
    def lb_overhead_fraction(self) -> float:
        w = self.walltime
        return sum(r.lb_time for r in self.records) / w if w > 0 else 0.0

    @property
    def mean_efficiency(self) -> float:
        if not self.records:
            return 1.0
        return float(np.mean([r.efficiency for r in self.records]))

    def reset(self) -> None:
        self.records.clear()
