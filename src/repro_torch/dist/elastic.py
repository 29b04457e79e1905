"""Elastic device-set handling: fail or add devices mid-run (copy of
``repro.dist.elastic`` over the port's ``core``).

``DeviceSet`` tracks which devices are alive; ``ElasticRunner`` drives a
``LoadBalancer`` against a changing device set: on failure or scale-up it
relabels the distribution mapping onto the surviving slots, resizes the
balancer (which voids the adoption gate's premise, so the next LB round
bypasses the improvement threshold once) and keeps an efficiency history
so recovery is observable.  The event log is plain dicts.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core import LoadBalancer, efficiency

__all__ = ["DeviceSet", "ElasticRunner"]


class DeviceSet:
    """Alive-device bookkeeping with a last-device guard."""

    def __init__(self, n_devices: int):
        if n_devices <= 0:
            raise ValueError("n_devices must be positive")
        self._alive: List[int] = list(range(n_devices))
        self._next_id = n_devices

    @property
    def n_alive(self) -> int:
        return len(self._alive)

    @property
    def alive(self) -> List[int]:
        return list(self._alive)

    def fail(self, device_id: int) -> None:
        """Mark ``device_id`` failed.  Refuses to lose the last device —
        an empty device set is unrecoverable, the caller must checkpoint
        and abort instead."""
        if len(self._alive) <= 1:
            raise RuntimeError("cannot fail the last remaining device")
        if device_id not in self._alive:
            raise ValueError(f"device {device_id} is not alive")
        self._alive.remove(device_id)

    def add(self) -> int:
        """Provision a fresh device; returns its id."""
        new_id = self._next_id
        self._next_id += 1
        self._alive.append(new_id)
        return new_id


class ElasticRunner:
    """Drive a LoadBalancer across device failures and scale-ups.

    LB *slots* (0..n-1, what the mapping points at) are distinct from
    physical device ids: on failure the last slot is relabelled into the
    freed one so the mapping stays dense, mirroring how an MPI communicator
    shrink renumbers ranks.
    """

    def __init__(
        self,
        n_devices: int,
        n_boxes: int,
        interval: int = 10,
        *,
        policy: str = "knapsack",
        improvement_threshold: float = 0.10,
        max_boxes_per_device: Optional[float] = 1.5,
        box_coords: Optional[np.ndarray] = None,
    ):
        if policy == "sfc" and box_coords is None:
            raise ValueError(
                "policy='sfc' partitions along a space-filling curve and "
                "needs box_coords (shape (n_boxes, 2)) at construction"
            )
        self.devices = DeviceSet(n_devices)
        self.slot_ids: List[int] = list(range(n_devices))  # slot -> physical id
        self.box_coords = box_coords
        self.lb = LoadBalancer(
            n_devices=n_devices,
            policy=policy,
            interval=interval,
            improvement_threshold=improvement_threshold,
            max_boxes_per_device=max_boxes_per_device,
        )
        self.lb.ensure_mapping(n_boxes)
        self.efficiency_history: List[float] = []
        self.events: List[Dict] = []

    # ------------------------------------------------------------------
    def step(self, step: int, costs: np.ndarray) -> Optional[np.ndarray]:
        """One simulation step: offer costs to the LB (it decides whether
        this step is an LB round) and record the achieved efficiency."""
        adopted = self.lb.step(step, costs, box_coords=self.box_coords)
        eff = efficiency(costs, self.lb.mapping, self.lb.n_devices, self.lb.capacities)
        self.efficiency_history.append(eff)
        if adopted is not None:
            self.events.append(
                {"step": int(step), "kind": "adopt", "efficiency": round(eff, 4)}
            )
        return adopted

    # ------------------------------------------------------------------
    def fail_device(self, slot: int) -> None:
        """A device died: shrink the balancer onto the surviving slots.
        Boxes stranded on the dead slot are folded back round-robin by
        ``LoadBalancer.resize`` and the next LB round bypasses the gate.
        Failing the *last* device is rejected (``DeviceSet``'s guard): the
        error propagates and a ``terminal`` event is logged so the abort
        is visible in the same event stream as ``fail``/``adopt``."""
        n = self.lb.n_devices
        if not 0 <= slot < n:
            raise ValueError(f"slot must be in [0, {n}), got {slot}")
        try:
            self.devices.fail(self.slot_ids[slot])  # raises on the last device
        except RuntimeError as e:
            self.events.append(
                {"step": None, "kind": "terminal", "slot": int(slot),
                 "n_devices": self.lb.n_devices, "error": str(e)}
            )
            raise
        last = n - 1
        if slot != last and self.lb.mapping is not None:
            m = self.lb.mapping.copy()
            was_slot, was_last = m == slot, m == last
            m[was_slot] = last  # stranded boxes -> the index resize folds
            m[was_last] = slot  # surviving last slot takes the freed label
            self.lb.mapping = m
        self.slot_ids[slot] = self.slot_ids[last]
        self.slot_ids.pop()
        self.lb.resize(n - 1)
        self.events.append({"step": None, "kind": "fail", "slot": int(slot),
                            "n_devices": self.lb.n_devices})

    def add_device(self) -> int:
        """Scale up by one device; the next LB round spills work onto it
        (gate bypassed via ``resize``)."""
        new_id = self.devices.add()
        self.slot_ids.append(new_id)
        self.lb.resize(self.lb.n_devices + 1)
        self.events.append({"step": None, "kind": "add",
                            "n_devices": self.lb.n_devices})
        return new_id
