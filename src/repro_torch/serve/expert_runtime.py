"""MoE expert serving runtime: the paper's DLB loop with experts as slots
(counterpart of ``repro.serve.expert_runtime``).

:class:`ExpertRuntime` is the serving implementation of
``repro_torch.dist.runtime_api.BalancedRuntime``, the PIC runtimes' loop
with every PIC noun swapped for a serving noun:

  ===================  ==============================================
  PIC runtimes         ExpertRuntime
  ===================  ==============================================
  box                  expert (one balancer slot per expert)
  deposition counters  dispatched capacity-buffer slots per expert
                       (``moe`` stats ``slots_filled``, the in-situ
                       work counter; ``tokens_per_expert`` is the
                       heuristic alternative)
  adoption = moving    adoption = permuting the stacked expert weights
  box state            so each device's contiguous expert block holds
                       the experts the knapsack assigned to it
                       (``repro_torch.models.moe.apply_expert_permutation``)
  ===================  ==============================================

Slots are **expert identities**, not positions: the balancer's mapping and
EWMA cost state are indexed by original expert id.  The physical layout is
tracked separately (``slot_expert[pos]`` = expert id at position ``pos``)
and re-derived from an adopted mapping by :func:`permutation_for_mapping`.
The router's columns move with the weight stacks, so an adoption changes
placement only: the served function is kept to float32 rounding.

Requires ``n_experts % n_devices == 0`` and runs the knapsack with
``max_boxes_per_device=1.0``, which keeps exactly ``E/D`` experts per
device.  ``n_devices`` is the modelled expert-parallel group: the stacks
live on one torch device.

Host synchronisation: on a CUDA device each step (the batch's upload
through pinned memory, the forward, the counters' accumulation, the
counter fetch's start and an adoption's permutation) runs under
``torch.cuda.set_sync_debug_mode("error")``.  The one wait per interval is
the harvest of its counters (``host_syncs``).  ``pipeline="sync"`` harvests
at the boundary that closes an interval and balances at once;
``pipeline="async"`` starts the counters' copy there and harvests it at the
*next* boundary, one interval stale, decoded with the layout it was
measured under.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import map_tensors, resolve_device, sync_free_region, to_device
from ..convert import params_from
from ..core import LoadBalancer
from ..dist.runtime_api import (
    _StragglerMixin,
    device_work,
    restore_balancer,
    snapshot_balancer,
    validate_pipeline,
)
from ..models.moe import apply_expert_permutation, moe
from ..pic.engine import _start_fetch

__all__ = ["ExpertRuntime", "permutation_for_mapping", "COST_SOURCES"]

#: the two per-expert cost signals (paper Sec. 4: in-situ vs heuristic)
COST_SOURCES = ("work_counter", "heuristic")

_STAT_KEY = {"work_counter": "slots_filled", "heuristic": "tokens_per_expert"}


def permutation_for_mapping(
    slot_expert: np.ndarray, mapping: np.ndarray, n_devices: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Turn an adopted expert→device ``mapping`` into the physical layout
    change that realizes it.

    ``slot_expert`` is the current layout (``slot_expert[pos]`` = original
    expert id held at weight-stack position ``pos``).  The new layout puts
    experts in device-major order, stable by expert id within a device.
    Returns ``(perm, new_slot_expert)`` where ``perm`` is the argument for
    ``apply_expert_permutation`` on the *current* params.  Raises if the
    mapping does not give every device exactly ``E / n_devices`` experts.
    """
    slot_expert = np.asarray(slot_expert, np.int64)
    mapping = np.asarray(mapping, np.int64)
    n = len(mapping)
    if n % n_devices != 0:
        raise ValueError(f"{n} experts not divisible by {n_devices} devices")
    counts = np.bincount(mapping, minlength=n_devices)
    if not np.all(counts == n // n_devices):
        raise ValueError(
            f"mapping must give every device exactly {n // n_devices} "
            f"experts, got counts {counts.tolist()}"
        )
    new_slot_expert = np.argsort(mapping, kind="stable")
    pos_new = np.empty(n, np.int64)
    pos_new[new_slot_expert] = np.arange(n)
    perm = pos_new[slot_expert]
    return perm, new_slot_expert


class ExpertRuntime(_StragglerMixin):
    """Serving-side balanced runtime: experts as slots, routed work as the
    in-situ cost, adoption as an expert permutation (see module docstring).

    Parameters
    ----------
    params, cfg:
        MoE block parameters (``repro_torch.models.moe.init_moe``, or a
        reference tree through ``repro_torch.convert.params_from``) and the
        ``ModelConfig`` they were built for; moved to ``device``.
    traffic:
        a ``repro_torch.serve.TrafficGenerator`` supplying one batch per step.
    n_devices:
        modelled expert-parallel group size; must divide ``cfg.n_experts``.
    cost_source:
        ``"work_counter"`` (dispatched capacity-buffer slots, the in-situ
        signal) or ``"heuristic"`` (router-intent token counts).
    lb_enabled:
        ``False`` = never balance; the interval loads are still recorded.
    static:
        balance once at the first boundary, then freeze.
    device:
        where the params and the forward live (default ``"cuda"``).
    """

    def __init__(
        self,
        params: dict,
        cfg,
        traffic,
        *,
        n_devices: int,
        lb_interval: int = 10,
        improvement_threshold: float = 0.10,
        cost_source: str = "work_counter",
        lb_enabled: bool = True,
        static: bool = False,
        ema_alpha: float = 1.0,
        pipeline: str = "sync",
        device=None,
    ):
        E = cfg.n_experts
        if E <= 0:
            raise ValueError("cfg.n_experts must be positive")
        if E % n_devices != 0:
            raise ValueError(
                f"n_experts={E} must be divisible by n_devices={n_devices}"
            )
        if cost_source not in COST_SOURCES:
            raise ValueError(
                f"cost_source must be one of {COST_SOURCES}, got {cost_source!r}"
            )
        self.device = resolve_device(device)
        self.params = map_tensors(lambda t: t.to(self.device), params)
        self.cfg = cfg
        self.traffic = traffic
        self.n_devices = n_devices
        self.cost_source = cost_source
        self.lb_enabled = lb_enabled
        self.pipeline = validate_pipeline(pipeline)
        self.balancer = LoadBalancer(
            n_devices,
            policy="knapsack",
            interval=lb_interval,
            improvement_threshold=improvement_threshold,
            ema_alpha=ema_alpha,
            max_boxes_per_device=1.0,  # count-preserving: exact E/D blocks
            static=static,
        )
        # Initial physical layout: expert e at position e -> device-major
        # blocks; the balancer mapping must describe the same placement.
        self._slot_expert = np.arange(E, dtype=np.int64)
        self.balancer.mapping = np.arange(E, dtype=np.int64) // (E // n_devices)

        self._acc = torch.zeros(E, dtype=torch.float32, device=self.device)
        # (host copy, its events, mapping_used, slot_expert_used, step): a
        # deferred measurement carries the mapping AND physical layout it
        # accumulated under; an adoption at the boundary between changes both.
        self._pending: Optional[Tuple] = None
        self.step_idx = 0
        self.tokens_served = 0
        self.host_syncs = 0
        self.lb_adoptions = 0
        self.interval_loads: List[np.ndarray] = []
        self.interval_costs: List[np.ndarray] = []
        self.efficiency_trace: List[Tuple[int, float]] = []

    @property
    def _strict(self) -> bool:
        return self.device.type == "cuda"

    # -- the step loop --------------------------------------------------
    def step(self) -> Dict[str, float]:
        """Serve one traffic batch (running the LB routine when due) and
        return this step's scalar diagnostics."""
        x_host = self.traffic.batch(self.step_idx)
        with sync_free_region(self._strict), torch.no_grad():
            _out, stats = moe(self.params, self.cfg, to_device(x_host, self.device))
            # per-position counters accumulate on the device
            self._acc += stats[_STAT_KEY[self.cost_source]]
        self.tokens_served += int(x_host.shape[0]) * int(x_host.shape[1])

        # Measurement happens on the interval cadence even when the
        # balancer itself is frozen (static-after-balance, lb_enabled=False):
        # the efficiency trace covers every interval in every mode.
        due = (
            self.balancer.should_run(self.step_idx)
            or self.step_idx % self.balancer.interval == 0
        )
        adopted = False
        if due:
            with sync_free_region(self._strict):
                host, events = _start_fetch(self._acc)
                self._acc = torch.zeros_like(self._acc)
            measurement = (
                host,
                events,
                self.balancer.mapping.copy(),
                self._slot_expert.copy(),
                self.step_idx,
            )
            if self.pipeline == "async":
                adopted = self._resolve_pending()
                self._pending = measurement
            else:
                adopted = self._lb_round(*measurement)
        self.step_idx += 1
        return {
            "step": float(self.step_idx),
            "tokens": float(x_host.shape[0] * x_host.shape[1]),
            "adopted": adopted,
        }

    def run(self, n_steps: int) -> None:
        """Serve ``n_steps`` traffic batches (LB rounds run when due)."""
        for _ in range(n_steps):
            self.step()

    def flush(self) -> None:
        """Resolve any deferred LB round (``pipeline="async"``) so every
        measured interval has fed the balancer; no-op under ``"sync"``."""
        self._resolve_pending()

    # -- the LB round ---------------------------------------------------
    def _harvest(self, host: torch.Tensor, events, slot_expert_used: np.ndarray) -> np.ndarray:
        """ONE device→host sync: wait for the counters' copy, then decode
        position counters into per-expert costs with the layout they
        accumulated under."""
        for ev in events:
            ev.synchronize()
        by_position = host.numpy().astype(np.float64)
        self.host_syncs += 1
        by_expert = np.zeros_like(by_position)
        by_expert[np.asarray(slot_expert_used)] = by_position
        return by_expert

    def _lb_round(
        self,
        host: torch.Tensor,
        events,
        mapping_used: np.ndarray,
        slot_expert_used: np.ndarray,
        measured_step: int,
    ) -> bool:
        costs = self._harvest(host, events, slot_expert_used)
        loads = device_work(costs, mapping_used, self.n_devices)
        cmax = float(loads.max()) if loads.size else 0.0
        eff = 1.0 if cmax <= 0.0 else float(loads.mean()) / cmax
        self.interval_loads.append(loads)
        self.interval_costs.append(costs.copy())
        self.efficiency_trace.append((measured_step, eff))
        if not self.lb_enabled:
            return False
        self._observe_straggler(costs, mapping_used)
        new_mapping = self.balancer.step(measured_step, costs)
        if new_mapping is None:
            return False
        self._realize(new_mapping)
        return True

    def _resolve_pending(self) -> bool:
        if self._pending is None:
            return False
        pending, self._pending = self._pending, None
        return self._lb_round(*pending)

    def _realize(self, mapping: np.ndarray, *, count: bool = True) -> None:
        """Commit an adopted expert→device mapping: permute the stacked
        expert weights (and router columns) into device-major blocks,
        without a host synchronisation.  ``count=False`` (the restore path)
        keeps ``lb_adoptions`` a count of live adoptions."""
        perm, new_slot_expert = permutation_for_mapping(
            self._slot_expert, mapping, self.n_devices
        )
        if not np.array_equal(perm, np.arange(len(perm))):
            with sync_free_region(self._strict):
                self.params = apply_expert_permutation(self.params, perm)
        self._slot_expert = new_slot_expert
        if count:
            self.lb_adoptions += 1

    # -- BalancedRuntime surface ---------------------------------------
    def n_slots(self) -> int:
        """Balancer work items this runtime places: one slot per expert."""
        return self.cfg.n_experts

    def slot_costs(self) -> Optional[np.ndarray]:
        """Smoothed per-expert in-situ costs as of the last LB round
        (expert-id order); ``None`` before it."""
        return self.balancer.smoothed_costs

    def apply_mapping(self, new_mapping) -> None:
        """Adopt an externally-decided expert→device mapping and permute
        the expert weights to realize it (the balancer's commit path)."""
        new_mapping = np.asarray(new_mapping, np.int64)
        if new_mapping.shape != (self.cfg.n_experts,):
            raise ValueError(
                f"mapping must have shape ({self.cfg.n_experts},)"
            )
        if new_mapping.min() < 0 or new_mapping.max() >= self.n_devices:
            raise ValueError("mapping names a device outside this runtime")
        self._realize(new_mapping)
        self.balancer.mapping = new_mapping.copy()

    def update_capacities(self, capacities) -> None:
        """Feed a per-device capacity vector into the knapsack and force
        the next LB round to rebalance against it."""
        self.balancer.set_capacities(
            None if capacities is None else np.asarray(capacities, np.float64)
        )
        self.balancer.force_rebalance()

    # -- snapshot / restore --------------------------------------------
    def snapshot(self) -> dict:
        """Device-count-independent state at the last committed boundary:
        params permuted back to **expert-major** order as CPU tensors
        (bfloat16 stays bfloat16, so no ``ml_dtypes`` is needed to restore
        it), the committed expert→device mapping, step/token counters, and
        the balancer EWMA state.  Flushes first: an async round in flight
        is never captured."""
        self.flush()
        params = self.params
        if not np.array_equal(self._slot_expert, np.arange(len(self._slot_expert))):
            params = apply_expert_permutation(params, self._slot_expert)
        return {
            "params": map_tensors(lambda t: t.detach().cpu(), params),
            "mapping": self.balancer.mapping.copy(),
            "step": self.step_idx,
            "tokens_served": self.tokens_served,
            "balancer": snapshot_balancer(self.balancer),
        }

    def restore(self, snap: dict) -> None:
        """Adopt a :meth:`snapshot`, possibly taken on a different device
        count (its params may also be a reference snapshot's numpy leaves).
        Expert-major params are reloaded, the balancer EWMA state restored,
        and the experts re-knapsacked onto *this* runtime's device set from
        the restored smoothed costs; when no costs survived (or balancing is
        disabled) the snapshot's committed mapping is realized instead,
        falling back to round-robin blocks only when it does not fit this
        runtime's device count.  ``lb_adoptions`` is not incremented."""
        E = self.cfg.n_experts
        self.params = params_from(snap["params"], self.device)
        self._slot_expert = np.arange(E, dtype=np.int64)
        self.balancer.mapping = np.arange(E, dtype=np.int64) // (E // self.n_devices)
        restore_balancer(self.balancer, snap.get("balancer", {}), n_boxes=E)
        costs = self.balancer.smoothed_costs
        if costs is not None and self.lb_enabled:
            proposed = self.balancer.propose(costs)
            self._realize(proposed, count=False)
            self.balancer.mapping = proposed
        else:
            committed = np.asarray(snap.get("mapping", ()), np.int64)
            if (
                committed.shape == (E,)
                and committed.min() >= 0
                and committed.max() < self.n_devices
                and np.all(
                    np.bincount(committed, minlength=self.n_devices)
                    == E // self.n_devices
                )
            ):
                self._realize(committed, count=False)
                self.balancer.mapping = committed.copy()
            self.balancer.force_rebalance()
        self.step_idx = int(snap["step"])
        self.tokens_served = int(snap["tokens_served"])
        self._acc = torch.zeros(E, dtype=torch.float32, device=self.device)
        self._pending = None

    # -- diagnostics ----------------------------------------------------
    def expert_placement(self) -> np.ndarray:
        """Current physical layout: ``expert_placement()[pos]`` is the
        original expert id whose weights sit at stack position ``pos``
        (device ``pos // (E/D)``)."""
        return self._slot_expert.copy()

    def mean_efficiency(self) -> float:
        """Mean Eq.-1 efficiency across all measured intervals so far
        (1.0 when nothing has been measured yet)."""
        if not self.efficiency_trace:
            return 1.0
        return float(np.mean([e for _, e in self.efficiency_trace]))

    def modeled_interval_time(self) -> float:
        """Modelled serving walltime: per interval, the max per-device load
        under the mapping that served it (bulk-synchronous EP), summed over
        intervals, in routed-work units."""
        return float(sum(float(l.max()) for l in self.interval_loads))
