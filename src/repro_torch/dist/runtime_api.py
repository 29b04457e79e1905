"""The contract every balanced runtime implements (counterpart of
``repro.dist.runtime_api``).

:class:`BalancedRuntime` is the workload-agnostic core of the paper's
technique: *slots* (work items; PIC boxes here) whose costs are measured in
situ, a commit path (``apply_mapping``) that re-commits state under an
adopted distribution mapping, a capacity API, the straggler loop, the
interval-pipeline flag, and snapshot/restore.  :class:`DistributedPICRuntime`
adds the PIC diagnostics.  ``repro_torch.dist.ShardedRuntime`` satisfies
both; ``tests/test_torch_sharded.py`` checks it.

Pipelines: ``"sync"`` fetches each round's counter history before issuing
the next; ``"async"`` (``repro_torch.pic.engine.IntervalPipeline`` at depth
2) issues round *k+1* before fetching round *k*, so an adoption lands one
interval later.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Protocol, runtime_checkable

import numpy as np

from ..core import LoadBalancer
from ..pic.engine import ENGINE_BACKENDS, validate_engine_backend
from .straggler import StragglerDetector

__all__ = [
    "BalancedRuntime",
    "DistributedPICRuntime",
    "StragglerLoop",
    "device_work",
    "validate_pipeline",
    "validate_engine_backend",
    "snapshot_balancer",
    "restore_balancer",
    "PIPELINES",
    "ENGINE_BACKENDS",
]

#: the two interval-pipeline modes every runtime must accept
PIPELINES = ("sync", "async")


def validate_pipeline(pipeline: str) -> str:
    """Validate a ``pipeline=`` flag value against :data:`PIPELINES`."""
    if pipeline not in PIPELINES:
        raise ValueError(f"pipeline must be one of {PIPELINES}, got {pipeline!r}")
    return pipeline


@runtime_checkable
class BalancedRuntime(Protocol):
    """The workload-agnostic balancer contract: slots with in-situ costs, a
    commit path for adopted mappings, capacities, the straggler loop, the
    interval pipeline, and snapshot/restore."""

    balancer: LoadBalancer
    pipeline: str

    def step(self) -> dict:
        """Advance one step and return its scalar diagnostics."""
        ...

    def run(self, n_steps: int) -> None:
        """Advance ``n_steps`` steps."""
        ...

    def flush(self) -> None:
        """Drain in-flight interval work; a no-op under ``"sync"``."""
        ...

    def apply_mapping(self, new_mapping) -> None:
        """Adopt an externally decided mapping and re-commit state."""
        ...

    def update_capacities(self, capacities) -> None:
        """Feed a per-device capacity vector into the knapsack and force the
        next LB round to rebalance against it."""
        ...

    def attach_straggler_detector(self, detector: StragglerDetector, time_fn=None) -> None:
        """Close the straggler loop."""
        ...

    def n_slots(self) -> int:
        """Number of balancer work items (slots) the runtime places."""
        ...

    def slot_costs(self) -> Optional[np.ndarray]:
        """Smoothed per-slot cost vector as of the last LB round, or None."""
        ...

    def snapshot(self) -> dict:
        """Recoverable state as numpy leaves, device-count independent."""
        ...

    def restore(self, snap: dict) -> None:
        """Adopt a :meth:`snapshot`, possibly of another device count."""
        ...


@runtime_checkable
class DistributedPICRuntime(BalancedRuntime, Protocol):
    """:class:`BalancedRuntime` plus the PIC diagnostics."""

    def total_alive(self) -> int:
        """Alive particles across all boxes and species."""
        ...

    def box_counts(self) -> np.ndarray:
        """Alive particles per box, shape ``(n_boxes,)``."""
        ...

    def devices_in_use(self) -> List[int]:
        """Distinct logical devices holding box state."""
        ...


def device_work(work_per_box: np.ndarray, mapping: np.ndarray, n_devices: int) -> np.ndarray:
    """Sum per-box executed-work counters onto their owner devices."""
    out = np.zeros(n_devices, np.float64)
    np.add.at(out, np.asarray(mapping), np.asarray(work_per_box, np.float64))
    return out


def snapshot_balancer(balancer: LoadBalancer) -> dict:
    """Checkpointable balancer state: the capacity vector (when a straggler
    loop fed one) and the smoothed per-box costs (after the first round)."""
    out = {}
    if balancer.capacities is not None:
        out["capacities"] = np.asarray(balancer.capacities, np.float64).copy()
    state = balancer._smoother._state
    if state is not None:
        out["cost_ema"] = np.asarray(state, np.float64).copy()
    return out


def restore_balancer(balancer: LoadBalancer, snap: dict, *, n_boxes: int) -> None:
    """Restore :func:`snapshot_balancer` state into a balancer that may
    govern another device count: capacities only when the length matches,
    smoothed costs always; non-finite values are dropped, and the live
    smoothed state is reset first."""
    balancer._smoother._state = None
    caps = snap.get("capacities")
    if caps is not None:
        caps = np.asarray(caps, np.float64)
        if caps.shape == (balancer.n_devices,) and np.isfinite(caps).all() and (caps > 0).all():
            balancer.set_capacities(caps)
    ema = snap.get("cost_ema")
    if ema is not None:
        ema = np.asarray(ema, np.float64)
        if ema.shape == (n_boxes,) and np.isfinite(ema).all():
            balancer._smoother._state = ema.copy()


class StragglerLoop:
    """Wires a :class:`StragglerDetector` into a :class:`LoadBalancer`: each
    LB interval's per-device (work, time) observation updates the capacity
    vector the knapsack sees, and the improvement gate is bypassed only when
    the straggler set changes."""

    def __init__(self, detector: StragglerDetector, balancer: LoadBalancer):
        if detector.n_devices != balancer.n_devices:
            raise ValueError(
                f"detector tracks {detector.n_devices} devices but the "
                f"balancer has {balancer.n_devices}"
            )
        self.detector = detector
        self.balancer = balancer
        self._last_stragglers: frozenset = frozenset()

    def observe(self, work_per_device: np.ndarray, times_per_device: np.ndarray) -> np.ndarray:
        """Fold one interval's observations; returns the capacity vector."""
        caps = self.detector.update(work_per_device, times_per_device)
        self.balancer.set_capacities(caps)
        stragglers = frozenset(self.detector.stragglers())
        if stragglers != self._last_stragglers:
            self.balancer.force_rebalance()
        self._last_stragglers = stragglers
        return caps


class _StragglerMixin:
    """Shared ``attach_straggler_detector``: the runtime calls
    ``_observe_straggler(work_per_box, mapping)`` at each LB round, before
    offering costs to the balancer."""

    _straggler_loop: Optional[StragglerLoop] = None
    _straggler_time_fn: Optional[Callable] = None
    _straggler_t0: float = 0.0

    def attach_straggler_detector(
        self,
        detector: StragglerDetector,
        time_fn: Optional[Callable[["_StragglerMixin", float], np.ndarray]] = None,
    ) -> None:
        """Enable the straggler loop.  ``time_fn(runtime, elapsed)`` may
        return per-device interval times (seconds); by default the wall time
        since the previous LB round is charged to every device."""
        self._straggler_loop = StragglerLoop(detector, self.balancer)
        self._straggler_time_fn = time_fn
        self._straggler_t0 = time.perf_counter()

    def _observe_straggler(
        self, work_per_box: np.ndarray, mapping: Optional[np.ndarray] = None
    ) -> None:
        if self._straggler_loop is None:
            return
        now = time.perf_counter()
        elapsed = max(now - self._straggler_t0, 1e-9)
        self._straggler_t0 = now
        n = self.balancer.n_devices
        if self._straggler_time_fn is not None:
            times = np.asarray(self._straggler_time_fn(self, elapsed), np.float64)
        else:
            times = np.full(n, elapsed)
        if mapping is None:
            mapping = self.balancer.mapping
        self._straggler_loop.observe(device_work(work_per_box, mapping, n), times)
