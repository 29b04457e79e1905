"""Checkpointed elastic recovery for the interval runtimes (counterpart of
``repro.dist.recovery``).

``RecoveryRunner`` wraps either runtime (``repro_torch.dist.BoxRuntime`` or
``ShardedRuntime``, ``pipeline="sync"`` or ``"async"``) and makes it
crash-safe at LB-interval granularity.  The ladder's tighter-packs rung
needs the sharded runtime's emigrant-pack tables; over a ``BoxRuntime`` it
is skipped, as in the reference.

  * **Interval-consistent checkpointing** — after every ``ckpt_every``-th
    committed interval the runtime's :meth:`snapshot` (which flushes the
    interval pipeline, so an async in-flight round is *never* captured —
    the staleness contract's commit point) is written through
    ``repro_torch.ckpt.CheckpointManager.save_async``: the device→host cut
    is synchronous, the disk write rides a worker thread off the hot path.
  * **Recovery protocol** — a :class:`repro_torch.dist.faults.DeviceLoss`
    shrinks the ``DeviceSet``, rebuilds the runtime on the largest
    *buildable* surviving device count (the sharded runtime needs
    ``n_boxes % n_devices == 0``; an unbuildable count degrades further —
    the "fewer devices" policy), reloads the newest **valid** checkpoint
    template-free (torn writes are skipped with a warning), and
    :meth:`restore`s it — which re-knapsacks the checkpointed per-box
    populations onto the survivors with the adoption gate bypassed,
    capacity-aware and locality-repaired, exactly like an LB round.
  * **Retry/backoff + graceful degradation** — transient faults
    (:class:`TransientFault`, :class:`CorruptState`) retry with
    exponential backoff; consecutive failures climb a degradation ladder:
    retries → tighter emigrant-pack caps (``mig_cap``, memory-pressure
    relief) → drop a device → :class:`RecoveryError` (terminal, also
    raised by the ``DeviceSet`` last-device guard).  Checkpoint *write*
    failures degrade softer still: after ``max_retries`` the run
    continues uncheckpointed with a warning rather than aborting.

Every decision lands in :attr:`RecoveryRunner.events` as plain JSON-ready
dicts (the ``ElasticRunner.events`` convention): ``checkpoint`` /
``fault`` / ``fail`` (with detection wall time) / ``restore`` (restore
wall time, intervals lost, the re-knapsack's device count) / ``degrade``
/ ``ckpt_error`` / ``terminal``.  ``tests/test_torch_recovery.py`` holds
them to the reference's under the same seeded fault schedules.
"""
from __future__ import annotations

import time
import warnings
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from ..ckpt import CheckpointManager, restore_checkpoint
from .elastic import DeviceSet
from .faults import CorruptState, DeviceLoss, Fault, FaultInjector, TransientFault
from .straggler import StragglerDetector

__all__ = ["RecoveryRunner", "RecoveryError"]


class RecoveryError(RuntimeError):
    """Unrecoverable failure: the degradation ladder is exhausted (last
    device lost, no buildable device count, or no valid checkpoint to
    restore)."""


class _Failed:
    """Stands in for a failed runtime while its successor is built: keeps
    the step for the event log, holds no device state."""

    def __init__(self, step_idx: int):
        self.step_idx = step_idx


class RecoveryRunner:
    """Drive a distributed PIC runtime with checkpointing and recovery.

    Parameters
    ----------
    factory:      ``factory(n_devices) -> runtime`` building a fresh
                  runtime of the *same problem* on ``n_devices`` (it may
                  raise for counts it cannot shard onto — the runner
                  probes downward for the largest buildable count).
    n_devices:    the initial device count.
    ckpt_dir:     checkpoint directory (a ``CheckpointManager`` with
                  ``keep`` retained steps is created over it).
    ckpt_every:   checkpoint cadence in LB intervals (default 1: every
                  committed interval boundary).
    max_retries:  transient-fault retries (and checkpoint-write retries)
                  before escalating to the degradation ladder.
    backoff_s:    base of the exponential retry backoff (seconds).
    min_devices:  refuse to degrade below this device count.
    injector:     optional :class:`repro_torch.dist.faults.FaultInjector`
                  consulted once per interval (chaos testing).
    """

    def __init__(
        self,
        factory: Callable[[int], object],
        n_devices: int,
        *,
        ckpt_dir,
        ckpt_every: int = 1,
        keep: int = 3,
        max_retries: int = 2,
        backoff_s: float = 0.05,
        min_devices: int = 1,
        injector: Optional[FaultInjector] = None,
    ):
        if ckpt_every < 1:
            raise ValueError("ckpt_every must be >= 1 (intervals per checkpoint)")
        self.factory = factory
        self.devices = DeviceSet(n_devices)
        self.ckpt = CheckpointManager(Path(ckpt_dir), keep=keep)
        self.ckpt_every = int(ckpt_every)
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.min_devices = int(min_devices)
        self.injector = injector
        #: JSON-ready decision log (checkpoint/fault/fail/restore/degrade/
        #: ckpt_error/terminal events)
        self.events: List[Dict] = []
        self.runtime = factory(n_devices)
        self.n_devices_active = n_devices
        self.lb_interval = max(1, int(self.runtime.balancer.interval))
        self._fails_in_a_row = 0
        self._mig_tightened = False
        self._last_ckpt_step = -1
        self._spike: Optional[Dict] = None
        self._spike_attached = False
        self._checkpoint()  # the step-0 restore point

    # ------------------------------------------------------------------
    # driving
    # ------------------------------------------------------------------
    def run(self, n_steps: int) -> None:
        """Advance ``n_steps`` steps, one LB interval at a time, applying
        scheduled faults, health-checking the harvested counters, and
        checkpointing at the cadence boundaries.  Recoverable failures are
        handled inside; only :class:`RecoveryError` escapes."""
        target = self.runtime.step_idx + int(n_steps)
        while self.runtime.step_idx < target:
            self._one_interval(target)
        if self.runtime.step_idx != self._last_ckpt_step:
            self._checkpoint()
        try:
            self.ckpt.wait()  # the end-of-run cut is durable when run() returns
        except Exception as e:
            self.events.append(
                {"kind": "ckpt_error", "step": int(self.runtime.step_idx),
                 "attempt": self.max_retries, "error": f"{type(e).__name__}: {e}"}
            )
            warnings.warn(f"end-of-run checkpoint failed: {e}")

    def _one_interval(self, target: int) -> None:
        rt = self.runtime
        interval = self.lb_interval
        k = rt.step_idx // interval
        t0 = time.perf_counter()
        try:
            kill: Optional[Fault] = None
            poison: Optional[Fault] = None
            faults = self.injector.take(k) if self.injector is not None else []
            for f in faults:
                fj = f.to_json()
                fj["fault"] = fj.pop("kind")
                self.events.append(
                    {"kind": "fault", "step": int(rt.step_idx), "interval": int(k),
                     **fj}
                )
                if f.kind == "kill_device":
                    kill = f
                elif f.kind == "nan_history":
                    poison = f
                elif f.kind == "straggler_spike":
                    self._arm_spike(f)
                elif f.kind == "worker_exc":
                    self.injector.arm_ckpt_failure(self.ckpt)
                elif f.kind == "torn_ckpt":
                    self._tear_newest()
            chunk = min(target - rt.step_idx, interval - rt.step_idx % interval)
            rt.run(chunk)
            if kill is not None:
                # the device died while the interval executed: its work is
                # lost with it (the restore rolls back past this interval)
                raise DeviceLoss(kill.device)
            if poison is not None:
                self.injector.poison(rt)
            self._health_check()
            due = (rt.step_idx % (interval * self.ckpt_every) == 0) or (
                rt.step_idx >= target
            )
            if due and rt.step_idx != self._last_ckpt_step:
                self._checkpoint()
            self._fails_in_a_row = 0
            self._mig_tightened = False
        except DeviceLoss as e:
            rt = None  # the rebuild must not find the failed runtime still referenced
            self._on_failure(e, t0, lost_slot=e.slot)
        except (TransientFault, CorruptState) as e:
            self._on_failure(e, t0, lost_slot=None)

    def _health_check(self) -> None:
        """Cheap per-interval invariant check on the already-harvested
        host bookkeeping (no flush, no extra device sync): the per-box
        counter history and the balancer's smoothed costs must be finite.
        Runs *before* a checkpoint is cut, so poisoned state is never
        checkpointed."""
        rt = self.runtime
        for attr in ("_alive_by_box", "_counts"):
            arr = getattr(rt, attr, None)
            if arr is not None and not np.isfinite(np.asarray(arr)).all():
                raise CorruptState(f"non-finite counter history in {attr}")
        smoother = getattr(rt.balancer, "_smoother", None)
        if smoother is not None and smoother._state is not None:
            if not np.isfinite(smoother._state).all():
                raise CorruptState("non-finite smoothed cost state")

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------
    def _checkpoint(self) -> None:
        rt = self.runtime
        t0 = time.perf_counter()
        tree = rt.snapshot()  # flushes: a committed, consistent cut
        snap_s = time.perf_counter() - t0
        step = int(rt.step_idx)
        extra = {"n_devices": int(self.n_devices_active)}
        for attempt in range(self.max_retries + 1):
            try:
                self.ckpt.save_async(tree, step=step, extra=extra)
                break
            except Exception as e:  # a prior write's surfaced failure
                self.events.append(
                    {"kind": "ckpt_error", "step": step, "attempt": attempt,
                     "error": f"{type(e).__name__}: {e}"}
                )
                if attempt >= self.max_retries:
                    warnings.warn(
                        f"checkpoint at step {step} abandoned after "
                        f"{self.max_retries} retries: {e}"
                    )
                    return  # degrade: keep running uncheckpointed
                time.sleep(self.backoff_s * (2 ** attempt))
        self._last_ckpt_step = step
        self.events.append(
            {"kind": "checkpoint", "step": step,
             "wall_s": round(time.perf_counter() - t0, 6),
             "snapshot_s": round(snap_s, 6)}
        )

    def _tear_newest(self) -> None:
        try:
            self.ckpt.wait()  # land the in-flight write before tearing it
        except Exception as e:
            self.events.append(
                {"kind": "ckpt_error", "step": int(self.runtime.step_idx),
                 "attempt": 0, "error": f"{type(e).__name__}: {e}"}
            )
        torn = self.injector.tear_checkpoint(self.ckpt.directory)
        if torn is not None:
            self.events.append({"kind": "fault_detail", "torn_step": int(torn)})

    # ------------------------------------------------------------------
    # recovery
    # ------------------------------------------------------------------
    def _on_failure(self, err: BaseException, t0: float, lost_slot: Optional[int]) -> None:
        detect_s = time.perf_counter() - t0
        self._fails_in_a_row += 1
        failed_step = int(self.runtime.step_idx)
        self.events.append(
            {"kind": "fail", "cause": type(err).__name__, "error": str(err),
             "step": failed_step, "slot": lost_slot,
             "n_devices": int(self.n_devices_active),
             "detect_s": round(detect_s, 6)}
        )
        if lost_slot is not None:
            # structural: shrink the device set, rebuild on the survivors
            self._fail_device(lost_slot)
            self._rebuild_and_restore(failed_step)
            self._fails_in_a_row = 0
            return
        # transient/corruption: retry in place with exponential backoff
        if self._fails_in_a_row <= self.max_retries:
            time.sleep(self.backoff_s * (2 ** (self._fails_in_a_row - 1)))
            self._restore_in_place(failed_step)
            return
        # ladder rung 1: restore, then tighten the emigrant packs on the
        # restored runtime (memory-pressure relief) — tightening first
        # would be undone by the restore's own mig-cap rebuild.  Runtimes
        # without the tables (BoxRuntime) skip straight to the next rung.
        if not self._mig_tightened and getattr(self.runtime, "_mig_caps", None):
            self._restore_in_place(failed_step)
            self._tighten_mig()
            return
        # ladder rung 2: drop a device and rebuild smaller
        if self.devices.n_alive > self.min_devices:
            self.events.append(
                {"kind": "degrade", "what": "devices",
                 "from": int(self.devices.n_alive),
                 "to": int(self.devices.n_alive) - 1}
            )
            self._fail_device(self.devices.n_alive - 1)
            self._rebuild_and_restore(failed_step)
            self._fails_in_a_row = 0
            return
        self.events.append(
            {"kind": "terminal", "step": failed_step,
             "error": f"degradation ladder exhausted at {self.devices.n_alive} "
                      f"device(s): {err}"}
        )
        raise RecoveryError(
            f"unrecoverable after {self._fails_in_a_row} consecutive failures "
            f"at {self.devices.n_alive} device(s)"
        ) from err

    def _fail_device(self, slot: int) -> None:
        """Shrink the ``DeviceSet`` by the physical device at ``slot``;
        the last-device guard escalates to a terminal event +
        :class:`RecoveryError`."""
        alive = self.devices.alive
        dead = alive[min(max(int(slot), 0), len(alive) - 1)]
        try:
            self.devices.fail(dead)
        except RuntimeError as e:
            self.events.append(
                {"kind": "terminal", "step": int(self.runtime.step_idx),
                 "error": str(e)}
            )
            raise RecoveryError(str(e)) from e

    def _build_on(self, n_surviving: int):
        """The largest buildable device count ``<= n_surviving``: the
        factory may reject counts it cannot shard onto (the sharded
        runtime's equal-count constraint) — those degrade further."""
        last_err: Optional[BaseException] = None
        for m in range(n_surviving, self.min_devices - 1, -1):
            try:
                rt = self.factory(m)
            except Exception as e:
                last_err = e
                continue
            if m < n_surviving:
                self.events.append(
                    {"kind": "degrade", "what": "devices",
                     "from": int(n_surviving), "to": int(m),
                     "why": "largest buildable count"}
                )
            return rt, m
        self.events.append(
            {"kind": "terminal", "step": int(self.runtime.step_idx),
             "error": f"no buildable device count in "
                      f"[{self.min_devices}, {n_surviving}]"}
        )
        raise RecoveryError(
            f"no buildable device count in [{self.min_devices}, {n_surviving}]"
        ) from last_err

    def _load_latest(self):
        """Newest *valid* checkpoint, template-free (torn steps skipped
        with a warning by ``restore_checkpoint``).  A pending async write
        is drained first; its failure, if any, must not block recovery."""
        try:
            self.ckpt.wait()
        except Exception as e:
            self.events.append(
                {"kind": "ckpt_error", "step": int(self.runtime.step_idx),
                 "attempt": 0, "error": f"{type(e).__name__}: {e}"}
            )
        try:
            return restore_checkpoint(self.ckpt.directory, None)
        except FileNotFoundError as e:
            self.events.append(
                {"kind": "terminal", "step": int(self.runtime.step_idx),
                 "error": f"no valid checkpoint: {e}"}
            )
            raise RecoveryError(f"no valid checkpoint to restore: {e}") from e

    def _rebuild_and_restore(self, failed_step: int) -> None:
        t0 = time.perf_counter()
        # release the failed runtime before building its successor: at full
        # width one runtime holds most of a card's memory
        self.runtime = _Failed(failed_step)
        new_rt, n_used = self._build_on(self.devices.n_alive)
        tree, step = self._load_latest()
        new_rt.restore(tree)
        self.runtime = new_rt
        self.n_devices_active = n_used
        self._last_ckpt_step = step
        if self._spike_attached:
            self._attach_spike_loop()
        self._log_restore(failed_step, step, t0)

    def _restore_in_place(self, failed_step: int) -> None:
        t0 = time.perf_counter()
        tree, step = self._load_latest()
        self.runtime.restore(tree)
        self._last_ckpt_step = step
        self._log_restore(failed_step, step, t0)

    def _log_restore(self, failed_step: int, ckpt_step: int, t0: float) -> None:
        rt = self.runtime
        mapping = np.asarray(rt.balancer.mapping)
        self.events.append(
            {"kind": "restore", "ckpt_step": int(ckpt_step),
             "from_step": int(failed_step),
             "intervals_lost": int(
                 -(-(failed_step - ckpt_step) // self.lb_interval)
             ),
             "n_devices": int(self.n_devices_active),
             "devices_used": int(len(np.unique(mapping))),
             "restore_s": round(time.perf_counter() - t0, 6)}
        )

    # ------------------------------------------------------------------
    # degradation mechanics
    # ------------------------------------------------------------------
    def _tighten_mig(self) -> bool:
        """Halve every adaptive emigrant-pack capacity (floor 16) — the
        "tighter ``mig_cap``" degradation rung, relieving memory pressure
        on runtimes that expose the tables (``ShardedRuntime``).  Returns
        False on runtimes without them (``BoxRuntime`` skips this rung)."""
        caps = getattr(self.runtime, "_mig_caps", None)
        if not caps:
            return False
        for s, table in enumerate(caps):
            caps[s] = {o: max(16, int(c) // 2) for o, c in table.items()}
        self._mig_tightened = True
        self.events.append({"kind": "degrade", "what": "mig_cap", "factor": 0.5})
        return True

    def _arm_spike(self, fault: Fault) -> None:
        """Install the straggler-spike time source: the target device's
        interval wall time is inflated by ``magnitude`` for the next
        ``span`` LB observations — the straggler loop's EWMA capacities
        absorb it without any restore."""
        self._spike = {
            "slot": int(fault.device),
            "magnitude": float(fault.magnitude),
            "left": int(fault.span),
        }
        if not self._spike_attached:
            self._attach_spike_loop()

    def _attach_spike_loop(self) -> None:
        rt = self.runtime
        rt.attach_straggler_detector(
            StragglerDetector(rt.balancer.n_devices), time_fn=self._spike_time_fn
        )
        self._spike_attached = True

    def _spike_time_fn(self, runtime, elapsed: float) -> np.ndarray:
        times = np.full(runtime.balancer.n_devices, elapsed)
        spike = self._spike
        if spike is not None and spike["left"] > 0:
            if 0 <= spike["slot"] < len(times):
                times[spike["slot"]] *= spike["magnitude"]
            spike["left"] -= 1
        return times
