"""The dynamic load balancing loop (paper Lis. 2.1 + Eq. 1).

``LoadBalancer`` is model-agnostic: clients feed it per-box costs measured
in situ (see ``repro.core.costs``) every ``interval`` steps; it proposes a
new distribution mapping under the configured policy and *adopts* it only if
the proposed load-balance efficiency exceeds the current one by the
``improvement_threshold`` (paper default 10%).  Adoption is the expensive
event (data redistribution is >= 99.7% of LB time in the paper), so the
gate is the central optimization.

On a multi-host SPMD system the decision must be identical on every host;
``LoadBalancer`` is deterministic given identical cost inputs, which replaces
the paper's root-rank + broadcast with a replicated decision (see DESIGN.md
§2 — this removes the bcast without changing semantics).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np

from .costs import EMASmoother
from .policies import (
    device_loads,
    knapsack_partition,
    round_robin_mapping,
    sfc_partition,
)

__all__ = ["efficiency", "LoadBalancer", "LBEvent", "make_policy"]


def efficiency(
    costs,
    mapping,
    n_devices: int,
    capacities: Optional[np.ndarray] = None,
) -> float:
    """Load balance efficiency  E = c_avg / c_max  (paper Eq. 1).

    ``E`` is in [0, 1]; 1 means perfectly balanced.  With per-device
    ``capacities`` the loads are effective loads (cost / capacity), which
    generalizes Eq. 1 to heterogeneous devices (capacities=None reproduces
    the paper exactly).
    """
    loads = device_loads(costs, mapping, n_devices, capacities)
    cmax = float(np.max(loads)) if len(loads) else 0.0
    if cmax <= 0.0:
        return 1.0  # no work anywhere: trivially balanced
    return float(np.mean(loads)) / cmax


def make_policy(name: str) -> Callable[..., np.ndarray]:
    """Resolve a policy name ('knapsack' | 'sfc') to a partition function."""
    if name == "knapsack":
        return knapsack_partition
    if name == "sfc":
        return sfc_partition
    raise ValueError(f"unknown policy {name!r}; expected 'knapsack' or 'sfc'")


@dataclass(frozen=True)
class LBEvent:
    """Record of one invocation of the LB routine (for analysis/benchmarks)."""

    step: int
    current_efficiency: float
    proposed_efficiency: float
    adopted: bool
    boxes_moved: int
    bytes_moved: float


@dataclass
class LoadBalancer:
    """Dynamic load balancer (paper Lis. 2.1).

    Parameters
    ----------
    n_devices:        number of devices (MPI ranks / GPUs / TPU chips).
    policy:           'knapsack' or 'sfc'.
    interval:         call the LB routine every `interval` steps (paper: 10).
    improvement_threshold:
                      required relative efficiency improvement for adoption
                      (paper: 0.10, i.e. propEff > 1.1 * currEff).
    capacities:       optional per-device speeds (straggler mitigation).
    ema_alpha:        cost smoothing across rounds (1.0 = paper behaviour).
    max_boxes_per_device:
                      knapsack cap as multiple of average (AMReX: 1.5).
    """

    n_devices: int
    policy: str = "knapsack"
    interval: int = 10
    improvement_threshold: float = 0.10
    capacities: Optional[np.ndarray] = None
    ema_alpha: float = 1.0
    max_boxes_per_device: Optional[float] = 1.5
    static: bool = False  # static LB: balance once at the first opportunity

    mapping: Optional[np.ndarray] = None
    events: List[LBEvent] = field(default_factory=list)
    _smoother: EMASmoother = field(default_factory=lambda: EMASmoother(1.0), repr=False)
    _balanced_once: bool = field(default=False, repr=False)
    _force_next: bool = field(default=False, repr=False)

    def __post_init__(self):
        if self.interval <= 0:
            raise ValueError("interval must be positive")
        if self.improvement_threshold < 0:
            raise ValueError("improvement_threshold must be non-negative")
        self._smoother = EMASmoother(self.ema_alpha)
        make_policy(self.policy)  # validate eagerly

    # ------------------------------------------------------------------
    def ensure_mapping(self, n_boxes: int) -> np.ndarray:
        """Initial (cost-oblivious) mapping: round robin, as AMReX does
        before any cost information exists."""
        if self.mapping is None or len(self.mapping) != n_boxes:
            self.mapping = round_robin_mapping(n_boxes, self.n_devices)
        return self.mapping

    def should_run(self, step: int) -> bool:
        """True when the LB routine is due at ``step``: every ``interval``
        steps, always after :meth:`force_rebalance`/:meth:`resize`, and at
        most once ever when ``static``."""
        if self._force_next:
            return True
        if self.static and self._balanced_once:
            return False
        return step % self.interval == 0

    def propose(self, costs: np.ndarray, box_coords: Optional[np.ndarray] = None) -> np.ndarray:
        """Compute a proposed mapping under the configured policy."""
        if self.policy == "knapsack":
            return knapsack_partition(
                costs,
                self.n_devices,
                capacities=self.capacities,
                max_boxes_per_device=self.max_boxes_per_device,
            )
        if box_coords is None:
            raise ValueError("sfc policy requires box_coords")
        return sfc_partition(costs, self.n_devices, box_coords=box_coords)

    def step(
        self,
        step: int,
        costs: np.ndarray,
        *,
        box_coords: Optional[np.ndarray] = None,
        box_bytes: Optional[np.ndarray] = None,
    ) -> Optional[np.ndarray]:
        """One invocation of the LB routine at time `step` (paper Lis. 2.1).

        Returns the *new mapping* if adopted, else None.  The caller performs
        the actual data redistribution on adoption (as WarpX's
        ``updateDistributionMapping`` does).
        """
        costs = np.asarray(costs, dtype=np.float64)
        mapping = self.ensure_mapping(len(costs))
        if not self.should_run(step):
            return None
        smoothed = self._smoother.update(costs)

        curr_eff = efficiency(smoothed, mapping, self.n_devices, self.capacities)
        proposed = self.propose(smoothed, box_coords)
        prop_eff = efficiency(smoothed, proposed, self.n_devices, self.capacities)

        # After an elastic resize the gate's premise (mapping was chosen for
        # this device set) is void: adopt any strict improvement once.
        if self._force_next:
            adopt = prop_eff >= curr_eff
            self._force_next = False
        else:
            adopt = prop_eff > (1.0 + self.improvement_threshold) * curr_eff
        moved = int(np.sum(proposed != mapping)) if adopt else 0
        if box_bytes is None:
            bytes_moved = 0.0
        else:
            bb = np.asarray(box_bytes, dtype=np.float64)
            bytes_moved = float(np.sum(bb[proposed != mapping])) if adopt else 0.0
        self.events.append(
            LBEvent(step, curr_eff, prop_eff, adopt, moved, bytes_moved)
        )
        if adopt:
            self.mapping = proposed
            self._balanced_once = True
            return proposed
        return None

    # ------------------------------------------------------------------
    @property
    def smoothed_costs(self) -> Optional[np.ndarray]:
        """The EWMA-smoothed per-item cost vector as of the last LB round
        (the in-situ signal the knapsack actually saw), or ``None`` before
        the first round.  This is the workload-agnostic per-slot cost
        surface of ``repro.dist.runtime_api.BalancedRuntime`` — per-box
        work counters for the PIC runtimes, per-expert dispatched-slot
        counts for ``repro.serve.ExpertRuntime``."""
        state = self._smoother._state
        return None if state is None else np.asarray(state, np.float64).copy()

    def force_rebalance(self) -> None:
        """Run the LB routine at the next opportunity and adopt any strict
        improvement, bypassing the threshold gate once.  Used after events
        that void the gate's premise without changing ``n_devices`` — e.g.
        a capacity-vector update from the straggler detector (``resize``
        already implies this for elastic device-set changes)."""
        self._force_next = True

    def set_capacities(self, capacities: Optional[np.ndarray]) -> None:
        """Update per-device capacities (straggler mitigation hook)."""
        if capacities is not None:
            capacities = np.asarray(capacities, dtype=np.float64)
            if capacities.shape != (self.n_devices,) or np.any(capacities <= 0):
                raise ValueError("capacities must be positive, shape (n_devices,)")
        self.capacities = capacities

    def resize(self, n_devices: int) -> None:
        """Elastic resize: device set changed (failure or scale-up/down).

        The existing mapping becomes invalid; the next ``step`` call will
        rebalance onto the new device set.  Entries pointing at removed
        devices are folded back round-robin so the system stays runnable
        between failure and the next LB round.
        """
        if n_devices <= 0:
            raise ValueError("n_devices must be positive")
        old = self.n_devices
        self.n_devices = n_devices
        if self.capacities is not None and len(self.capacities) != n_devices:
            self.capacities = None
        if self.mapping is not None and n_devices < old:
            bad = self.mapping >= n_devices
            self.mapping = self.mapping.copy()
            self.mapping[bad] = np.arange(int(bad.sum())) % n_devices
        self._balanced_once = False  # allow static LB to re-balance after resize
        self._force_next = True  # next LB round bypasses the improvement gate

    # -- analysis helpers ------------------------------------------------
    @property
    def adoption_rate(self) -> float:
        if not self.events:
            return 0.0
        return sum(e.adopted for e in self.events) / len(self.events)

    def efficiency_history(self) -> np.ndarray:
        """(step, achieved efficiency) pairs after each LB invocation."""
        return np.array(
            [
                (e.step, e.proposed_efficiency if e.adopted else e.current_efficiency)
                for e in self.events
            ]
        )
