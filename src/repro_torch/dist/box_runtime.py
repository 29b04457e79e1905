"""Multi-device box runtime: the paper's distribution mapping made physical
(counterpart of ``repro.dist.box_runtime``).

``BoxRuntime`` is the host-driven validation runtime: each box owns its
field tile and its particles as tensors on one *logical device* (a
``torch.device``; any number may be the same card, as in
``repro_torch.dist.ShardedRuntime``) per the ``LoadBalancer``'s mapping.
One step is:

  1. *Field halo exchange* — every box assembles a ``halo``-padded E/B tile
     from the overlapping strips of its (periodic) neighbours' interiors,
     each strip moved to its own device with ``Tensor.to``
     (``pic.boxes.halo_paste_plan``).
  2. *Particle phase* — ``pic.engine.particle_phase`` (the plain tensor
     path; no kernel runs here, as in the reference) per box on its device,
     in the box-local frame with domain-global coordinates; the per-box
     alive count and its ``box_work_counters`` work stay on the device.
  3. *Current halo fold* — the padded deposit tiles are summed across the
     9-point neighbourhood (``halo_fold_plan``): the exact global current
     on every padded tile.
  4. *Field phase* — ``pic.engine.field_phase`` per padded tile (leapfrog,
     laser profile, sponge); the interior is kept.  With ``halo >= 4`` the
     fields are the global solver's to f32 rounding.
  5. *Particle emigration* — every box's alive particles are pooled (in box
     order) and repacked by position into per-box buffers of a fixed
     capacity; particles that left the domain were killed by the push.
  6. *Load balancing* — every ``lb_interval`` steps the work counters feed
     ``LoadBalancer.step``; on adoption each moved box's tile, particles
     and static tiles move to the new device (``apply_mapping``).

One dispatch per box per step is deliberate and counted in
``host_dispatches``, in the reference's accounting: this runtime checks
the mapping for real, it is not the production path
(``repro_torch.dist.ShardedRuntime`` is).  The emigration repack runs on
the first logical device with tensor ops (a stable sort by box id, then
one scatter per leaf into ``(n_boxes, cap)`` buffers whose rows are the
boxes' buffers), which keeps the reference's particle order without
moving every lane through the host.

``pipeline="async"`` keeps an LB round's work-counter tensors on the
device, starts their copy to the host behind an event, and resolves them
(balancer, adoption) at the next LB round: every adoption lands one
interval late, the staleness contract of ``repro_torch.dist.runtime_api``.
``flush()`` resolves a pending round early.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core import LoadBalancer
from ..launch.mesh import make_box_mesh
from ..pic.boxes import BoxDecomposition, halo_fold_plan, halo_paste_plan
from ..pic.deposition import box_work_counters
from ..pic.engine import _start_fetch, field_phase, particle_phase
from ..pic.fields import Fields, make_sponge
from ..pic.grid import Grid2D
from ..pic.particles import Particles
from ..pic.problem import ProblemSetup
from .runtime_api import (
    _StragglerMixin,
    restore_balancer,
    snapshot_balancer,
    validate_pipeline,
)

__all__ = ["BoxRuntime", "_MIN_HALO", "_round_up", "_np_box_ids"]

#: particle stencil support: gather and deposit reach at most 3 cells
#: outside a box (order-3 shape + one-step excursion), and the field
#: leapfrog needs 3 valid halo cells — 4 covers both with margin
_MIN_HALO = 4

#: particle leaves of the emigration pool and of a snapshot
_PKEYS = ("z", "x", "ux", "uy", "uz", "w")


def _round_up(n: int, quantum: int) -> int:
    return max(quantum, int(-(-n // quantum) * quantum))


def _np_box_ids(z: np.ndarray, x: np.ndarray, grid: Grid2D) -> np.ndarray:
    """NumPy twin of ``Grid2D.box_of_position`` for host-side packing."""
    bz = np.clip((z / (grid.dz * grid.box_nz)).astype(np.int64), 0, grid.boxes_z - 1)
    bx = np.clip((x / (grid.dx * grid.box_nx)).astype(np.int64), 0, grid.boxes_x - 1)
    return bz * grid.boxes_x + bx


class BoxRuntime(_StragglerMixin):
    """Step a ``ProblemSetup`` with per-box state placed on logical devices.

    Parameters
    ----------
    problem:      grid + species + laser (``repro_torch.pic.problem``).
    n_devices:    logical devices to spread boxes over.
    lb_interval:  run the LB routine every this many steps (paper: 10).
    halo:         guard depth of the per-box tiles (>= 4).
    pipeline:     ``"sync"`` (default) fetches the LB round's work counters
                  at the boundary that produced them; ``"async"`` resolves
                  them one interval later (module docstring).
    policy / improvement_threshold / max_boxes_per_device / shape_order /
    sponge_width / capacity_margin / capacity_round: as the reference.
    devices:      the logical devices' torch devices (the first
                  ``n_devices``); by default ``n_devices`` copies of
                  ``device`` (default ``"cuda"``, which raises without one).
    """

    def __init__(
        self,
        problem: ProblemSetup,
        n_devices: int,
        lb_interval: int = 10,
        *,
        halo: int = _MIN_HALO,
        pipeline: str = "sync",
        policy: str = "knapsack",
        improvement_threshold: float = 0.10,
        max_boxes_per_device: Optional[float] = 1.5,
        shape_order: int = 3,
        sponge_width: int = 8,
        capacity_margin: float = 2.0,
        capacity_round: int = 64,
        devices: Optional[Sequence[Union[str, torch.device]]] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        grid = problem.grid
        if halo < _MIN_HALO:
            raise ValueError(f"halo must be >= {_MIN_HALO} (particle stencil support)")
        if min(grid.box_nz, grid.box_nx) < halo:
            raise ValueError(
                f"boxes ({grid.box_nz}x{grid.box_nx}) must be at least halo={halo} wide"
            )
        self.grid = grid
        self.laser = problem.laser
        self.decomp = BoxDecomposition(grid)
        self.devices = list(make_box_mesh(n_devices, devices, device))
        self.halo = halo
        self.pipeline = validate_pipeline(pipeline)
        #: deferred LB round under pipeline="async": (host copy of the work
        #: counters, its events, counts, the mapping they ran under, step)
        self._pending_lb: Optional[Tuple] = None
        self.shape_order = shape_order
        self._capacity_round = capacity_round
        self._capacity_margin = capacity_margin
        self.t = 0.0
        self.step_idx = 0
        #: host operations issued (strip moves, commits, per-box phase
        #: calls): O(boxes) per step, in the reference's accounting
        self.host_dispatches = 0

        self.balancer = LoadBalancer(
            n_devices=n_devices,
            policy=policy,
            interval=lb_interval,
            improvement_threshold=improvement_threshold,
            max_boxes_per_device=max_boxes_per_device,
        )
        self.balancer.ensure_mapping(grid.n_boxes)

        # -- tile geometry -------------------------------------------------
        pnz, pnx = grid.box_nz + 2 * halo, grid.box_nx + 2 * halo
        # one box spanning the whole padded tile: particle_phase's per-box
        # counts then collapse to this box's population
        self.local_grid = Grid2D(
            nz=pnz, nx=pnx, dz=grid.dz, dx=grid.dx, box_nz=pnz, box_nx=pnx, cfl=grid.cfl
        )
        self._paste = halo_paste_plan(grid, halo)
        self._fold = halo_fold_plan(grid, halo)
        # physical origin of each box's padded tile (cell (0,0) of the tile)
        self._origins = np.array(
            [[(bz * grid.box_nz - halo) * grid.dz, (bx * grid.box_nx - halo) * grid.dx]
             for bz, bx in grid.box_coords],
            np.float32,
        )
        self._centers = np.array(
            [[(bz + 0.5) * grid.box_nz * grid.dz, (bx + 0.5) * grid.box_nx * grid.dx]
             for bz, bx in grid.box_coords],
            np.float32,
        )

        # -- static per-box tiles (sponge, laser profile), periodic-padded --
        sponge_g = np.pad(make_sponge(grid, sponge_width).numpy(), halo, mode="wrap")
        if self.laser is not None:
            prof_g = np.pad(self.laser.profile(grid).numpy(), halo, mode="wrap")
        else:
            prof_g = np.zeros_like(sponge_g)
        self._static_host: List[np.ndarray] = []
        for bz, bx in grid.box_coords:
            sz = slice(bz * grid.box_nz, bz * grid.box_nz + pnz)
            sx = slice(bx * grid.box_nx, bx * grid.box_nx + pnx)
            self._static_host.append(np.stack([sponge_g[sz, sx], prof_g[sz, sx]]).astype(np.float32))
        self._static: List[Optional[torch.Tensor]] = [None] * grid.n_boxes
        self._origin_dev: List[Optional[torch.Tensor]] = [None] * grid.n_boxes

        # -- state: field tiles + per-box particle buffers ------------------
        self.field_tiles: List[torch.Tensor] = [
            torch.zeros((6, grid.box_nz, grid.box_nx), dtype=torch.float32)
            for _ in range(grid.n_boxes)
        ]
        self.boxes: List[Tuple[Particles, ...]] = [()] * grid.n_boxes
        self._qm = [(float(p.q), float(p.m)) for p in problem.species]
        self._caps = [0] * len(problem.species)
        self._counts = np.zeros(grid.n_boxes, np.float64)
        self._distribute_initial(problem.species)
        self._place(range(grid.n_boxes))

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------
    def device_of(self, box: int) -> torch.device:
        """The torch device of the logical device owning ``box``."""
        return self.devices[int(self.balancer.mapping[box])]

    def _place(self, boxes) -> None:
        """(Re)commit the listed boxes' state to their mapped devices: the
        redistribution event on adoption, and the initial placement
        (``.to`` onto the tensor's own device is free, so re-placing an
        unmoved box costs nothing; the static tiles upload once)."""
        for b in boxes:
            d = self.device_of(b)
            self.field_tiles[b] = self.field_tiles[b].to(d)
            self.boxes[b] = tuple(p.to(d) for p in self.boxes[b])
            src = self._static_host[b] if self._static[b] is None else self._static[b]
            self._static[b] = torch.as_tensor(src).to(d)
            self._origin_dev[b] = torch.as_tensor(self._origins[b]).to(d)
            self.host_dispatches += 3

    def apply_mapping(self, new_mapping) -> None:
        """Adopt an externally decided mapping: update the balancer and move
        every reassigned box's state to its new device."""
        new = np.asarray(new_mapping, dtype=np.int64)
        if new.shape != (self.grid.n_boxes,) or new.min() < 0 or new.max() >= len(self.devices):
            raise ValueError("mapping must assign every box to a valid device slot")
        old = self.balancer.mapping
        self.balancer.mapping = new
        changed = range(self.grid.n_boxes) if old is None else np.nonzero(new != old)[0]
        self._place(changed)

    # ------------------------------------------------------------------
    # particles: initial split + emigration exchange
    # ------------------------------------------------------------------
    @property
    def _pool_device(self) -> torch.device:
        return self.devices[0]

    def _pack_boxes(self, pooled: List[Dict[str, object]]) -> None:
        """Distribute per-species pools of alive particles (flat arrays or
        tensors, domain positions) into fixed-capacity per-box buffers on
        the owners' devices: each box's particles in its leading lanes in
        pool order, dead padding parked at the box centre with zero
        payload.  Capacities only grow (``capacity_margin`` x the fullest
        box, rounded up to ``capacity_round``)."""
        grid, S = self.grid, self.grid.n_boxes
        dev = self._pool_device
        centers = torch.from_numpy(self._centers).to(dev)
        per_box: List[List[Particles]] = [[] for _ in range(S)]
        total = np.zeros(S, np.float64)
        for s, pool in enumerate(pooled):
            leaves = {k: torch.as_tensor(pool[k], dtype=torch.float32).to(dev) for k in _PKEYS}
            ids = grid.box_of_position(leaves["z"], leaves["x"])
            order = torch.sort(ids, stable=True).indices
            sid = ids[order]
            counts = torch.bincount(ids, minlength=S)
            counts_host = counts.cpu().numpy()
            need = _round_up(
                int(counts_host.max() * self._capacity_margin) if len(counts_host) and ids.numel() else 0,
                self._capacity_round,
            )
            self._caps[s] = max(self._caps[s], need)
            cap = self._caps[s]
            starts = torch.cumsum(counts, 0) - counts
            dst = sid * cap + (torch.arange(sid.numel(), device=dev) - starts[sid])
            bufs = {}
            for k in _PKEYS:
                if k in ("z", "x"):
                    buf = centers[:, 0 if k == "z" else 1, None].expand(S, cap).contiguous()
                else:
                    buf = torch.zeros((S, cap), dtype=torch.float32, device=dev)
                buf.view(-1)[dst] = leaves[k][order]
                bufs[k] = buf
            alive = torch.arange(cap, device=dev)[None, :] < counts[:, None]
            q, m = (torch.tensor(v, dtype=torch.float32, device=dev) for v in self._qm[s])
            for b in range(S):
                per_box[b].append(
                    Particles(*(bufs[k][b] for k in _PKEYS), alive=alive[b], q=q, m=m)
                    .to(self.device_of(b))
                )
            total += counts_host
        self.boxes = [tuple(sp) for sp in per_box]
        self._counts = total
        self.host_dispatches += S * len(pooled)  # one commit per buffer

    def _distribute_initial(self, species: Tuple[Particles, ...]) -> None:
        self._pack_boxes([{k: getattr(p, k)[p.alive] for k in _PKEYS} for p in species])

    def _pool_species(self, boxes: List[Tuple[Particles, ...]]) -> List[Dict[str, torch.Tensor]]:
        """Each species' alive particles across the per-box buffers, in box
        order then lane order, on the pool device: the repack input of the
        emigration exchange, and the particle payload of :meth:`snapshot`
        (box membership follows from position, so the pooled form does not
        depend on the device count)."""
        dev = self._pool_device
        pooled = []
        for s in range(len(self._qm)):
            parts = {k: [] for k in _PKEYS}
            for b in range(self.grid.n_boxes):
                p = boxes[b][s]
                keep = p.alive.nonzero().squeeze(1)
                for k in _PKEYS:
                    parts[k].append(getattr(p, k).index_select(0, keep).to(dev, non_blocking=True))
            pooled.append({k: torch.cat(v) for k, v in parts.items()})
        return pooled

    def _exchange_particles(self, stepped: List[Tuple[Particles, ...]]) -> None:
        """Emigration: pool each species across boxes (particles the push
        killed at the domain edge drop out) and repack by position.  Field
        and static tiles are not touched: they move only on adoption."""
        self._pack_boxes(self._pool_species(stepped))

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------
    def _assemble(self, sources: List[torch.Tensor], plan, box: int, channels: int) -> torch.Tensor:
        """Gather/sum plan strips onto ``box``'s device (the halo exchange)."""
        d = self.device_of(box)
        pnz, pnx = self.local_grid.shape
        out = torch.zeros((channels, pnz, pnx), dtype=torch.float32, device=d)
        self.host_dispatches += 1 + len(plan)
        for src, (tz, tx), (sz, sx) in plan:
            out[:, tz, tx] += sources[src][:, sz, sx].to(d, non_blocking=True)
        return out

    def step(self) -> Dict[str, float]:
        """Advance one PIC step across all boxes; run the LB routine when
        due.  Returns host-side diagnostics for this step."""
        n_boxes, h = self.grid.n_boxes, self.halo
        # 1. field halo exchange -> padded E/B tiles on each owner device
        padded_f = [self._assemble(self.field_tiles, self._paste[b], b, 6) for b in range(n_boxes)]
        # 2. particle phase per box (device-side counts + work counters)
        stepped, j_padded, work_dev = [], [], []
        for b in range(n_boxes):
            o = self._origin_dev[b]
            sp, (jx, jy, jz), counts = particle_phase(
                Fields(*padded_f[b]), self.boxes[b], self.local_grid, self.shape_order,
                domain_grid=self.grid, origin=(o[0], o[1]),
            )
            stepped.append(sp)
            j_padded.append(torch.stack([jx, jy, jz]))
            work_dev.append(box_work_counters(counts, self.grid)[0])
        self.host_dispatches += 2 * n_boxes  # particle + field phase per box
        # 3. current halo fold -> exact global J on each padded tile
        padded_j = [self._assemble(j_padded, self._fold[b], b, 3) for b in range(n_boxes)]
        # 4. field phase per box, keep interiors
        new_tiles = []
        for b in range(n_boxes):
            d = self.device_of(b)
            t = torch.full((), self.t, dtype=torch.float32, device=d)
            f = field_phase(
                Fields(*padded_f[b]), tuple(padded_j[b]), self.local_grid,
                sponge=self._static[b][0], laser=self.laser, t=t,
                laser_profile=self._static[b][1],
            )
            new_tiles.append(torch.stack(f)[:, h:-h, h:-h].contiguous())
        self.field_tiles = new_tiles
        # 5. particle emigration between boxes (and domain-exit kills)
        self._exchange_particles(stepped)

        # 6. LB round: sync fetches and balances at the measuring boundary;
        #    async resolves the PREVIOUS round's counters here (one interval
        #    stale) and leaves this round's copy in flight
        adopted = False
        if self.balancer.should_run(self.step_idx):
            work = torch.stack([w.to(self._pool_device) for w in work_dev])
            if self.pipeline == "async":
                # the mapping before the resolve (which may adopt): these
                # counters accumulated under it
                mapping_used = self.balancer.mapping.copy()
                adopted = self._resolve_pending_lb()
                host, events = _start_fetch(work)
                self._pending_lb = (host, events, self._counts.copy(), mapping_used, self.step_idx)
            else:
                costs = work.cpu().numpy().astype(np.float64)
                adopted = self._lb_round(costs, self._counts, self.step_idx)

        self.step_idx += 1
        self.t += self.grid.dt
        return {"step": self.step_idx, "alive": float(self._counts.sum()), "adopted": adopted}

    def _lb_round(
        self,
        costs: np.ndarray,
        counts: np.ndarray,
        step: int,
        mapping_used: Optional[np.ndarray] = None,
    ) -> bool:
        """One balancer invocation at measurement boundary ``step`` plus the
        adoption's placement; ``mapping_used`` is the mapping the counters
        accumulated under (async: the current one may have adopted since)."""
        self._observe_straggler(costs, mapping_used)
        old = self.balancer.mapping.copy()
        new_mapping = self.balancer.step(
            step,
            costs,
            box_coords=self.decomp.coords,
            box_bytes=self.decomp.box_bytes(counts),
        )
        if new_mapping is None:
            return False
        self._place(np.nonzero(new_mapping != old)[0])
        return True

    def _resolve_pending_lb(self) -> bool:
        """Resolve the deferred LB round: wait for its counters' copy (long
        done: a whole interval ran behind it) and run the balancer on them;
        the adoption lands now, one interval after the measurement."""
        if self._pending_lb is None:
            return False
        host, events, counts, mapping_used, measured_step = self._pending_lb
        self._pending_lb = None
        for ev in events:
            ev.synchronize()
        costs = host.numpy().astype(np.float64)
        return self._lb_round(costs, counts, measured_step, mapping_used)

    def flush(self) -> None:
        """Resolve any deferred LB round (``pipeline="async"``); a no-op
        under ``"sync"``."""
        self._resolve_pending_lb()

    def run(self, n_steps: int) -> None:
        """Advance ``n_steps`` steps (LB rounds run when due)."""
        for _ in range(n_steps):
            self.step()

    # ------------------------------------------------------------------
    # capacity awareness (straggler mitigation hook)
    # ------------------------------------------------------------------
    def update_capacities(self, capacities: Optional[np.ndarray]) -> None:
        """Feed a per-device capacity vector into the knapsack and force
        the next LB round to rebalance against it."""
        self.balancer.set_capacities(capacities)
        self.balancer.force_rebalance()

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def n_slots(self) -> int:
        """Balancer work items this runtime places: one per box."""
        return self.grid.n_boxes

    def slot_costs(self) -> Optional[np.ndarray]:
        """Smoothed per-box work-counter costs as of the last LB round."""
        return self.balancer.smoothed_costs

    def total_alive(self) -> int:
        """Alive particles across all boxes and species."""
        return int(self._counts.sum())

    def box_counts(self) -> np.ndarray:
        """Alive particles per box (all species), from the last exchange."""
        return self._counts.copy()

    def _host_tiles(self) -> np.ndarray:
        return np.stack([t.cpu().numpy() for t in self.field_tiles])

    @property
    def fields(self) -> Fields:
        """The global field state assembled on the host (CPU tensors)."""
        grid = self.grid
        tiles = self._host_tiles()
        out = np.zeros((6, grid.nz, grid.nx), np.float32)
        for b, (bz, bx) in enumerate(grid.box_coords):
            out[:, bz * grid.box_nz:(bz + 1) * grid.box_nz,
                bx * grid.box_nx:(bx + 1) * grid.box_nx] = tiles[b]
        return Fields(*(torch.from_numpy(c.copy()) for c in out))

    def devices_in_use(self) -> List[int]:
        """Distinct logical devices currently holding box state."""
        return sorted({int(d) for d in self.balancer.mapping})

    # ------------------------------------------------------------------
    # recovery surface (see repro_torch.dist.recovery)
    # ------------------------------------------------------------------
    def snapshot(self) -> Dict:
        """Recoverable state at the last committed boundary as numpy leaves
        in box-major layout, the reference's format: stacked interior tiles,
        pooled alive particles per species, per-box counts, time/step, the
        mapping, the device count and the balancer state.  Flushes the
        deferred LB round first, so the cut is a committed one."""
        self.flush()
        snap: Dict = {
            "tiles": self._host_tiles().astype(np.float32),
            "species": [
                {k: v.cpu().numpy() for k, v in sp.items()} for sp in self._pool_species(self.boxes)
            ],
            "counts": self._counts.copy(),
            "t": np.float64(self.t),
            "step_idx": np.int64(self.step_idx),
            "mapping": np.asarray(self.balancer.mapping, np.int64).copy(),
            "n_devices": np.int64(len(self.devices)),
        }
        snap.update(snapshot_balancer(self.balancer))
        return snap

    def restore(self, snap: Dict) -> None:
        """Adopt a :meth:`snapshot`, possibly taken on another device count:
        the checkpointed populations are re-knapsacked onto this runtime's
        devices (gate bypassed, capacity-aware) and the new mapping is
        committed before the state is placed, so the restore is itself a
        redistribution event.  A deferred LB round is dropped unread: its
        counters may be the corrupt state the restore repairs."""
        grid = self.grid
        tiles = np.asarray(snap["tiles"], np.float32)
        if tiles.shape != (grid.n_boxes, 6, grid.box_nz, grid.box_nx):
            raise ValueError(
                f"snapshot tiles {tiles.shape} do not fit this grid "
                f"({grid.n_boxes} boxes of 6x{grid.box_nz}x{grid.box_nx})"
            )
        if len(snap["species"]) != len(self._qm):
            raise ValueError("snapshot species count does not match this problem")
        self._pending_lb = None
        restore_balancer(self.balancer, snap, n_boxes=grid.n_boxes)
        counts = np.nan_to_num(np.asarray(snap["counts"], np.float64), nan=0.0)
        mapping = self.balancer.propose(np.maximum(counts, 0.0), box_coords=self.decomp.coords)
        self.balancer.mapping = np.asarray(mapping, np.int64)
        self.balancer.force_rebalance()
        self.field_tiles = [torch.from_numpy(tiles[b].copy()) for b in range(grid.n_boxes)]
        self._pack_boxes(
            [{k: np.array(sp[k], np.float32) for k in _PKEYS} for sp in snap["species"]]
        )
        self._place(range(grid.n_boxes))
        self.t = float(snap["t"])
        self.step_idx = int(snap["step_idx"])
