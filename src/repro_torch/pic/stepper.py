"""PIC time stepping: host-side DLB driver over the device-resident engine.

Counterpart of ``repro.pic.stepper``.

  * ``repro_torch.pic.engine`` owns the physics and runs one LB interval on
    the device with its per-step history kept there.
  * ``Simulation`` advances the run one LB round at a time, fetches the
    round's whole history in **one** device->host transfer, measures per-box
    costs with the configured strategy, offers them to the ``LoadBalancer``
    at the round boundary, and replays the round into the
    ``VirtualCluster`` walltime model.

With ``engine_backend="cuda"`` (the default) the balancer is fed from the
CUDA kernels' in-kernel executed-work counters, the paper's in-situ signal.
``SimConfig.strict_syncs`` runs each interval under
``torch.cuda.set_sync_debug_mode("error")``, which turns any host sync
inside the interval into an error: the engine's contract, checked.

Cost strategies: ``heuristic`` (w_p·n_particles + w_c·n_cells per box) and
``work_counter`` (the kernels' executed-work counters).  The
``activity_ledger`` strategy is not ported yet.  ``fused=False`` runs one
step at a time with a fetch per step.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..core import HeuristicCost, LoadBalancer, VirtualCluster, WorkCounterCost
from ..kernels.constants import DEPOSIT_TILE
from .boxes import BoxDecomposition
from .deposition import box_particle_counts, box_work_counters
from .engine import StepOutputs, build_step_body, make_interval_fn, validate_engine_backend
from .fields import Fields, make_sponge
from .grid import Grid2D
from .particles import Particles

__all__ = ["SimConfig", "Simulation"]

_COST_STRATEGIES = ("heuristic", "work_counter")


@dataclass
class SimConfig:
    shape_order: int = 3
    sponge_width: int = 8
    # particle-phase backend: "cuda" (binned CUDA kernels, in-kernel work
    # counters; their plain versions on CPU tensors) or "torch" (global path)
    engine_backend: str = "cuda"
    # per-box bin capacity of the "cuda" backend, rounded up to the kernel
    # chunk; None sizes it at 4x the worst initial box occupancy.  Overflow
    # beyond it is counted in ``dropped_total``
    kernel_cap: Optional[int] = None
    fused: bool = True  # one device-resident interval per LB round (False: per step)
    cost_strategy: str = "work_counter"  # heuristic | work_counter
    heuristic_particle_weight: float = 0.75  # paper's Summit calibration
    heuristic_cell_weight: float = 0.25
    # fail on any host sync inside an interval (CUDA only)
    strict_syncs: bool = False
    # -- load balancing (paper defaults) --
    lb_enabled: bool = True
    lb_policy: str = "knapsack"
    lb_interval: int = 10
    lb_threshold: float = 0.10
    lb_static: bool = False
    n_virtual_devices: int = 8
    ema_alpha: float = 1.0
    max_boxes_per_device: Optional[float] = 1.5
    # -- virtual-cluster calibration (work units -> seconds at 1 Gop/s) --
    ops_per_second: float = 1e9
    virtual_link_bw: float = 8e7


class Simulation:
    """Owns state + the interval engine + the host-side DLB driver.

    State lives on ``device`` (default ``"cuda"``); the problem's species
    are copied there, so the problem survives the run.
    """

    def __init__(self, problem, config: SimConfig = SimConfig(), device=None):
        self.device = resolve_device(device)
        self.grid: Grid2D = problem.grid
        self.config = config
        self.engine_backend = validate_engine_backend(config.engine_backend)
        if config.cost_strategy not in _COST_STRATEGIES:
            raise ValueError(
                f"cost_strategy must be one of {_COST_STRATEGIES} in this port, "
                f"got {config.cost_strategy!r}"
            )
        #: particles that skipped a step because their bin was full
        self.dropped_total = 0
        self.fields = Fields.zeros(self.grid, self.device)
        self.species: Tuple[Particles, ...] = tuple(
            p.to(self.device, copy=True) for p in problem.species
        )
        self.laser = problem.laser
        self.decomp = BoxDecomposition(self.grid)
        self.t = 0.0
        self.step_idx = 0
        #: host copy of the last fetched interval history (StepOutputs of numpy arrays)
        self.last_outputs: Optional[StepOutputs] = None

        self.balancer = LoadBalancer(
            n_devices=config.n_virtual_devices,
            policy=config.lb_policy,
            interval=config.lb_interval,
            improvement_threshold=config.lb_threshold,
            static=config.lb_static,
            ema_alpha=config.ema_alpha,
            max_boxes_per_device=config.max_boxes_per_device,
        )
        self.balancer.ensure_mapping(self.grid.n_boxes)
        self.cluster = VirtualCluster(
            n_devices=config.n_virtual_devices, link_bw=config.virtual_link_bw
        )
        self._heuristic = HeuristicCost(
            particle_weight=config.heuristic_particle_weight,
            cell_weight=config.heuristic_cell_weight,
        )
        self._sponge = make_sponge(self.grid, config.sponge_width, device=self.device)

        kernel_cap = None
        if self.engine_backend == "cuda":
            tile = DEPOSIT_TILE
            if config.kernel_cap is not None:
                kernel_cap = int(max(1, int(np.ceil(config.kernel_cap / tile))) * tile)
            else:
                init_counts = np.zeros(self.grid.n_boxes)
                for p in self.species:
                    init_counts += box_particle_counts(p, self.grid).cpu().numpy()
                kernel_cap = int(max(1, int(np.ceil(init_counts.max() * 4 / tile))) * tile)
        self.kernel_cap = kernel_cap

        self._step_body = build_step_body(
            self.grid,
            device=self.device,
            shape_order=config.shape_order,
            sponge=self._sponge,
            laser=self.laser,
            engine_backend=self.engine_backend,
            kernel_cap=kernel_cap,
        )
        self._interval_fn = make_interval_fn(self._step_body, self.grid)

        self.history: Dict[str, List] = {
            "efficiency": [],
            "lb_steps": [],
            "field_energy": [],
            "kinetic_energy": [],
            "max_over_avg": [],
        }
        self.wall_t0 = time.perf_counter()

    # ------------------------------------------------------------------
    def measure_costs(self, counts: np.ndarray, work: Optional[np.ndarray] = None) -> np.ndarray:
        """Per-box costs under the configured strategy (paper §2.2).
        ``work`` is the counter row already fetched with the history."""
        strategy = self.config.cost_strategy
        if strategy == "heuristic":
            return self._heuristic.measure(
                n_particles=counts,
                n_cells=np.full(self.grid.n_boxes, self.grid.cells_per_box, dtype=np.float64),
            )
        if strategy == "work_counter":
            if work is None:
                work = box_work_counters(torch.as_tensor(counts), self.grid).numpy()
            return WorkCounterCost().measure(work_counters=work)
        raise ValueError(f"unknown cost strategy {strategy!r}")

    # ------------------------------------------------------------------
    def run(self, n_steps: int, progress_every: int = 0) -> Dict[str, List]:
        if self.config.fused:
            self._run_fused(n_steps, progress_every)
        else:
            self._run_per_step(n_steps, progress_every)
        return self.history

    def _run_fused(self, n_steps: int, progress_every: int) -> None:
        """One device-resident chunk per LB round; chunk boundaries stay
        aligned to multiples of ``lb_interval`` across ``run()`` calls."""
        interval = max(1, self.config.lb_interval)
        remaining = n_steps
        while remaining > 0:
            chunk = min(remaining, interval - (self.step_idx % interval))
            self._run_chunk(chunk, progress_every)
            remaining -= chunk

    def _t_now(self) -> torch.Tensor:
        """The current time as a float32 device scalar, written by a fill
        kernel (no host->device copy)."""
        return torch.full((), self.t, dtype=torch.float32, device=self.device)

    @contextlib.contextmanager
    def _interval_region(self):
        """Inside: no host sync allowed when ``strict_syncs`` is set."""
        if not (self.config.strict_syncs and self.device.type == "cuda"):
            yield
            return
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    def _fetch(self, outs: StepOutputs) -> StepOutputs:
        """The interval's single device->host transfer: every history
        tensor is copied asynchronously, then one stream synchronize."""
        if self.device.type != "cuda":
            return StepOutputs(*(t.numpy() for t in outs))
        host = [t.to("cpu", non_blocking=True) for t in outs]
        torch.cuda.current_stream(self.device).synchronize()
        return StepOutputs(*(t.numpy() for t in host))

    def _run_chunk(self, n_steps: int, progress_every: int) -> None:
        """One device-resident interval + the single fetch of its history."""
        t0 = self._t_now()
        with self._interval_region():
            self.fields, self.species, outs = self._interval_fn(
                self.fields, self.species, t0, n_steps
            )
        host = self._fetch(outs)
        self.last_outputs = host
        self._absorb_outputs(
            host.counts, host.work, host.field_energy, host.kinetic_energy,
            progress_every, dropped=host.dropped,
        )

    def _run_per_step(self, n_steps: int, progress_every: int) -> None:
        for _ in range(n_steps):
            self.fields, self.species, out = self._step_body(
                self.fields, self.species, self._t_now()
            )
            host = self._fetch(StepOutputs(*(t[None] for t in out)))  # per-step sync
            self.last_outputs = host
            self._absorb_outputs(
                host.counts, host.work, host.field_energy, host.kinetic_energy,
                progress_every, dropped=host.dropped,
            )

    # -- shared host-side bookkeeping --------------------------------------
    def _absorb_outputs(
        self,
        counts: np.ndarray,
        work: np.ndarray,
        fe: np.ndarray,
        ke: np.ndarray,
        progress_every: int = 0,
        dropped: Optional[np.ndarray] = None,
    ) -> None:
        """Fold one fetched chunk (``(L, ...)`` histories) into the LB loop,
        the walltime model and the run history.  The LB decision, when due,
        consumes row 0: the round-boundary step."""
        cfg = self.config
        if dropped is not None:
            self.dropped_total += int(np.asarray(dropped).sum())
        n_steps = counts.shape[0]
        true_costs = work.astype(np.float64) / cfg.ops_per_second

        lb_called = False
        bytes_moved = 0.0
        if cfg.lb_enabled and self.balancer.should_run(self.step_idx):
            lb_called = True
            measured = self.measure_costs(counts[0], work=work[0])
            new_mapping = self.balancer.step(
                self.step_idx,
                measured,
                box_coords=self.decomp.coords,
                box_bytes=self.decomp.box_bytes(counts[0]),
            )
            if new_mapping is not None:
                bytes_moved = self.balancer.events[-1].bytes_moved
                self.history["lb_steps"].append(self.step_idx)

        recs = self.cluster.record_interval(
            self.step_idx,
            true_costs,
            self.balancer.mapping,
            neighbors=self.decomp.neighbors,
            surface_bytes=self.decomp.surface_bytes(),
            lb_bytes_moved=bytes_moved,
            lb_called=lb_called,
        )
        self.history["efficiency"].extend(r.efficiency for r in recs)

        onehot = (
            np.asarray(self.balancer.mapping)[:, None]
            == np.arange(cfg.n_virtual_devices)[None, :]
        ).astype(np.float64)
        loads = true_costs @ onehot
        self.history["max_over_avg"].extend(
            (loads.max(axis=1) / np.maximum(loads.mean(axis=1), 1e-30)).tolist()
        )
        self.history["field_energy"].extend(float(v) for v in fe)
        self.history["kinetic_energy"].extend(float(v) for v in ke)

        self.t += n_steps * self.grid.dt
        self.step_idx += n_steps
        if progress_every:
            first = self.step_idx - n_steps + 1
            for s in range(first, self.step_idx + 1):
                if s % progress_every == 0:
                    i = s - first
                    print(
                        f"step {s:5d}  E_eff={recs[i].efficiency:.3f} "
                        f"W_field={fe[i]:.3e} K={ke[i]:.3e}"
                    )

    # -- summary metrics ---------------------------------------------------
    @property
    def modeled_walltime(self) -> float:
        return self.cluster.walltime

    @property
    def mean_efficiency(self) -> float:
        return float(np.mean(self.history["efficiency"])) if self.history["efficiency"] else 1.0

    @property
    def host_walltime(self) -> float:
        return time.perf_counter() - self.wall_t0
