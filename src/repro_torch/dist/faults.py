"""Seeded fault injection for the recovery layer (numpy-only copy of
``repro.dist.faults``; the port keeps its own).

The paper's production context (6144-GPU allocations) fails in a handful
of characteristic ways; this module names them so chaos runs are
*reproducible*: every fault is declared (or drawn from a seeded RNG) on a
:class:`FaultSchedule` keyed by LB-interval index, and
``repro_torch.dist.recovery.RecoveryRunner`` consumes the schedule at its hook
points.  Fault kinds (:data:`FAULT_KINDS`):

``kill_device``
    Device loss at the end of interval *k* — the interval's in-flight
    work is gone with the device; recovery restores the last committed
    checkpoint onto the survivors (raised as :class:`DeviceLoss`).
``worker_exc``
    An exception inside the checkpoint writer thread — exercises the
    record-and-re-raise error surfacing of ``CheckpointManager`` and the
    runner's retry/backoff.
``nan_history``
    Corrupted in-situ counter history (NaN poisoning of the harvested
    per-box counts and the balancer's smoothed costs) — detected by the
    runner's health check as :class:`CorruptState` and repaired by an
    in-place restore.
``straggler_spike``
    One device's interval time inflated by ``magnitude`` for ``span``
    LB observations — absorbed by the straggler loop (capacity-aware
    re-knapsack), no restore needed.
``torn_ckpt``
    The newest on-disk checkpoint truncated in place (simulated torn
    write) — exercises ``restore_checkpoint``'s fall-back-to-valid-step
    path.

Replay semantics: a fault fires on every schedule query at or past its
``interval`` until it has fired ``repeats`` times.  Because recovery
*replays* intervals, a transient fault with ``repeats > 1``
deterministically re-fires on the replay — which is exactly how the
runner's consecutive-failure degradation ladder is tested.

Every firing is logged JSON-ready on :attr:`FaultInjector.fired`, in the
same plain-dict style as ``ElasticRunner.events``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "FAULT_KINDS",
    "Fault",
    "FaultSchedule",
    "FaultInjector",
    "DeviceLoss",
    "TransientFault",
    "CorruptState",
]

#: the injectable failure modes (see the module docstring for semantics)
FAULT_KINDS = ("kill_device", "worker_exc", "nan_history", "straggler_spike", "torn_ckpt")


class DeviceLoss(RuntimeError):
    """An injected (or detected) device loss; carries the lost slot.
    Structural: the runtime must be rebuilt on the survivors and restored
    from the last committed checkpoint."""

    def __init__(self, slot: int, msg: Optional[str] = None):
        super().__init__(msg or f"device slot {slot} lost")
        self.slot = int(slot)


class TransientFault(RuntimeError):
    """A failure expected to clear on retry (worker-thread exception, a
    flaky filesystem) — the recovery runner retries with backoff before
    escalating to the degradation ladder."""


class CorruptState(RuntimeError):
    """Detected non-finite/inconsistent runtime state (NaN counter
    history, poisoned cost EWMA) — repaired by restoring the last
    committed checkpoint into the same runtime."""


@dataclass
class Fault:
    """One scheduled fault: ``kind`` (:data:`FAULT_KINDS`), the first LB
    ``interval`` index at which it may fire, the target ``device`` slot,
    the straggler-spike ``magnitude``/``span``, and how many times it
    fires (``repeats`` — replayed intervals re-fire transient faults)."""

    kind: str
    interval: int
    device: int = 0
    magnitude: float = 8.0
    span: int = 2
    repeats: int = 1
    remaining: int = field(init=False, repr=False)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"kind must be one of {FAULT_KINDS}, got {self.kind!r}")
        if self.interval < 0 or self.repeats < 1:
            raise ValueError("interval must be >= 0 and repeats >= 1")
        self.remaining = int(self.repeats)

    def to_json(self) -> Dict:
        """The fault as a plain JSON-ready dict (for event logs)."""
        return {
            "kind": self.kind,
            "interval": int(self.interval),
            "device": int(self.device),
            "magnitude": float(self.magnitude),
            "span": int(self.span),
            "repeats": int(self.repeats),
        }


class FaultSchedule:
    """A deterministic fault timeline: explicit :class:`Fault` events,
    optionally extended by a seeded random draw (``seed`` + ``rate`` per
    interval over ``n_intervals``, choosing among ``kinds`` and a uniform
    target device) — same seed, same chaos, every run."""

    def __init__(
        self,
        faults: Sequence[Fault] = (),
        *,
        seed: Optional[int] = None,
        n_intervals: int = 0,
        rate: float = 0.0,
        kinds: Sequence[str] = ("kill_device",),
        n_devices: int = 1,
    ):
        self.faults: List[Fault] = list(faults)
        if seed is not None and rate > 0.0:
            rng = np.random.default_rng(seed)
            for k in range(int(n_intervals)):
                if rng.random() < rate:
                    kind = kinds[int(rng.integers(len(kinds)))]
                    self.faults.append(
                        Fault(kind, interval=k, device=int(rng.integers(n_devices)))
                    )

    def take(self, interval: int) -> List[Fault]:
        """Faults firing at ``interval``: every fault with remaining
        firings whose start interval is ``<= interval``.  Each call
        consumes one firing per matching fault (so a replayed interval
        re-fires a multi-repeat fault — the replay semantics the
        degradation-ladder tests rely on)."""
        out = []
        for f in self.faults:
            if f.remaining > 0 and interval >= f.interval:
                f.remaining -= 1
                out.append(f)
        return out

    def to_json(self) -> List[Dict]:
        """The full schedule as JSON-ready dicts."""
        return [f.to_json() for f in self.faults]


class FaultInjector:
    """Applies a :class:`FaultSchedule`'s faults at the recovery runner's
    hook points and logs every firing (JSON-ready, on :attr:`fired`).
    The injector only *implements* the corruption mechanics; *when* each
    fires is the runner's per-interval loop's business."""

    def __init__(self, schedule: FaultSchedule):
        self.schedule = schedule
        #: every fault firing, as ``{"interval": k, **fault.to_json()}``
        self.fired: List[Dict] = []

    def take(self, interval: int) -> List[Fault]:
        """Consume this interval's faults from the schedule, logging each
        firing."""
        faults = self.schedule.take(interval)
        for f in faults:
            self.fired.append({"interval": int(interval), **f.to_json()})
        return faults

    def poison(self, runtime) -> None:
        """Corrupt the runtime's harvested counter history in place: NaN
        the per-box alive counts (``_alive_by_box``/``_counts``) and the
        balancer's smoothed-cost state — what a bad in-situ counter fetch
        would leave behind."""
        for attr in ("_alive_by_box", "_counts"):
            arr = getattr(runtime, attr, None)
            if arr is not None:
                np.asarray(arr)[:] = np.nan
        smoother = getattr(runtime.balancer, "_smoother", None)
        if smoother is not None and smoother._state is not None:
            smoother._state[:] = np.nan

    def arm_ckpt_failure(self, manager, n: int = 1) -> None:
        """Make the manager's next ``n`` checkpoint writes raise inside
        the writer thread (an injected ``OSError``).  The failure follows
        the production surfacing path: recorded by ``save_async``'s
        worker, re-raised at the next ``save``/``save_async``/``wait`` —
        where the recovery runner's retry/backoff catches it."""
        box = {"left": int(n)}

        def on_write(step: int) -> None:
            if box["left"] > 0:
                box["left"] -= 1
                raise OSError(f"injected worker-thread write failure (step {step})")

        manager.on_write = on_write

    def tear_checkpoint(self, directory) -> Optional[int]:
        """Truncate the newest checkpoint's array container in place to
        half its bytes (a simulated torn write that survived the atomic
        rename, e.g. media corruption).  Returns the torn step, or
        ``None`` when there is no checkpoint to tear."""
        from ..ckpt.checkpoint import _ARRAYS, available_steps

        steps = available_steps(directory)
        if not steps:
            return None
        p = Path(directory) / f"step_{steps[-1]:010d}" / _ARRAYS
        data = p.read_bytes()
        p.write_bytes(data[: max(1, len(data) // 2)])
        return int(steps[-1])
