"""The sharded production runtime: slot-major box state over a ring of
logical devices, one device-resident loop per LB interval, one fetch.

Counterpart of ``repro.dist.sharded_runtime`` (both pipelines, both
``overlap`` modes).  The reference is single-controller: one ``shard_map``
program over a device mesh, whose collectives are ``ppermute`` hops.  The
port keeps that design with *logical devices*: a ``ShardedRuntime`` holds
one slot stack per logical device, each on its own ``torch.device``
(``repro_torch.launch.make_box_mesh``), and any number of them may be the
same card.  Its collectives (``repro_torch.dist.collectives``) move
per-device tensors with ``Tensor.to(dst, non_blocking=True)``: nothing on
one card, a peer copy between the cards of one node.  So every exchange of
the reference runs on a single GPU, and the CPU tests hold the port to the
reference's own multi-device runs in one process.

State layout — *slot-major*.  Logical device ``d`` owns slots ``[d*bpd,
(d+1)*bpd)``: field interiors ``(bpd, 6, bnz, bnx)`` and, per species, a
dict of ``(bpd, cap)`` tensors (``z, x, ux, uy, uz, w, alive``) whose alive
particles sit in each slot's leading lanes (the alive-prefix invariant the
kernels rely on).  ``slot_box[s]`` names the box in slot ``s``; the
equal-count knapsack keeps every device at ``bpd`` boxes, so an adopted
mapping is a slot permutation.

One step, for every device (``comm="neighbor"``, the default):

  1. *Halo paste* — the guard strips each box needs from its 8 neighbours
     (``pic.boxes.halo_strip_tables``), one payload per ring offset.
  2. *Particle phase* — ``pic.engine.particle_phase_stacked``
     (``engine_backend="torch"``, work from ``box_work_counters``) or
     ``kernels.ops.particle_phase_slots`` (``"cuda"``: both CUDA kernels,
     and the balancer is fed their in-kernel counters).
  3. *Current fold* — the overlapping deposit strips travel the same hops
     and are added into each slot's padded frame.
  4. *Field phase* — ``pic.engine.field_phase_stacked`` (sponge and
     per-box laser profile), interiors kept.
  5. *Emigration* — leavers are packed per destination offset into
     fixed-capacity packs (in flat lane order), ride one hop, and each slot
     merges its stayers (in lane order) with the arrivals addressed to its
     box (by ascending offset, then pack order).  Overflow is counted in
     ``dropped_total``; pack capacities adapt to the observed demand.

``comm="ring"`` is the reference path: interiors, deposits and packs travel
the whole ring (``ring_all_gather``) and every device assembles the global
frame through dense cell maps.

Every pack and merge is a stable compaction by ``cumsum`` and
``searchsorted``/``scatter_`` with static shapes (pack, pair and slot
capacities are host-known), so the interval never synchronises with the
host; with ``strict_syncs`` it runs under ``torch.cuda.set_sync_debug_mode
("error")``.  The host fetches the interval's history once, runs the
balancer, and an adoption re-commits state as a slot permutation, which may
move rows between logical devices.

Two interval pipelines drive the host loop (``pipeline=``), both through
``repro_torch.pic.engine.IntervalPipeline``: ``"sync"`` (depth 1) issues
round *k*, fetches its history, runs the balancer, commits any adoption,
then issues *k+1*; ``"async"`` (depth 2) issues *k+1* under the current
mapping before fetching *k*, so the balancer runs while *k+1* executes and
an adoption permutes *k+1*'s output: a mapping decided from round *k*'s
counters takes effect at round *k+2*.  Histories are read under their
issue-time ``slot_box`` (it rides the pipeline as metadata), so the physics
is that of ``"sync"``; still one device->host sync per interval, now on
that round's event.  ``flush()`` drains the pipeline, and the observability
accessors and ``snapshot()`` flush first.

``overlap=True`` splits each step's particle phase (either ``comm``
mode), as the reference does: advance every particle and deposit only the
*frontier* (particles whose post-move cell can reach a sent fold strip,
``pic.boxes.frontier_cell_mask``), issue the fold strips
(``collectives.neighbor_exchange_start``, or the ring all-gather), deposit
the *interior* (which cannot touch a sent strip) while they travel, and
fold the arrivals in only after it (``neighbor_exchange_done``).  The
physics is the monolithic step's to f32 rounding; the price is a second
masked deposit sweep.  Split-phase masking exists only in the plain tensor
path, so ``engine_backend="cuda"`` with ``overlap=True`` raises, as the
reference's ``"pallas"`` does.  :meth:`ShardedRuntime.interval_trace`
(the counterpart of the reference's ``interval_hlo``) runs one interval
under ``torch.profiler`` with a span around each of those phases, and
:func:`split_phase_order` checks the window on it: the order of issue, not
measured overlap (on one card ``.to()`` between logical devices copies
nothing, so there is nothing to overlap there).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import _trace
from .._device import sync_free_region, to_device
from ..core import LoadBalancer
from ..core.policies import hop_radius, locality_repair
from ..kernels.constants import DEPOSIT_TILE
from ..kernels.ops import particle_phase_slots
from ..launch.mesh import make_box_mesh, slot_home_devices
from ..pic.boxes import (
    BoxDecomposition,
    box_slot_layout,
    frontier_cell_mask,
    halo_strip_tables,
    interior_cell_map,
    padded_cell_map,
)
from ..pic.deposition import box_work_counters
from ..pic.engine import (
    IntervalPipeline,
    field_phase_stacked,
    particle_phase_stacked,
    particle_phase_stacked_frontier,
    particle_phase_stacked_interior,
)
from ..pic.fields import Fields, make_sponge
from ..pic.grid import Grid2D
from ..pic.particles import Particles
from ..pic.problem import ProblemSetup
from .box_runtime import _MIN_HALO, _np_box_ids, _round_up
from .collectives import (
    neighbor_exchange,
    neighbor_exchange_done,
    neighbor_exchange_start,
    neighbor_reduce,
    ring_all_gather,
)
from .runtime_api import (
    _StragglerMixin,
    restore_balancer,
    snapshot_balancer,
    validate_engine_backend,
    validate_pipeline,
)

__all__ = ["ShardedRuntime", "split_phase_order"]

#: particle-buffer float fields travelling through the emigration exchange
_PKEYS = ("z", "x", "ux", "uy", "uz", "w")

#: emigrant-pack capacity floor (adaptive resizing never goes below this)
_MIN_MIG = 16

#: scratch lanes past the slot buffers that a compaction's discarded lanes
#: are written to, spread by lane so the writes do not pile onto one address
_TRASH = 1 << 16

#: per-step history rows: float32 per slot, int32 per slot
_F32_KEYS = ("counts", "work", "field_energy", "kinetic_energy")
_I32_KEYS = ("alive", "dropped")


def _pad_tables(tables) -> np.ndarray:
    """Stack per-direction index arrays into one ``(8, m_max)`` int64 table,
    padded with ``-1`` (receivers route padding to a dump cell)."""
    m = max(len(t) for t in tables)
    out = -np.ones((len(tables), m), np.int64)
    for j, t in enumerate(tables):
        out[j, : len(t)] = t
    return out


def _chunk_pieces(chunk: int, interval: int) -> List[int]:
    """Piece lengths of a chunk: a full LB round is one piece; other chunks
    split into powers of two (the reference's scan lengths, kept so the
    fetch count per ``run`` is the reference's)."""
    if chunk == interval:
        return [chunk]
    pieces = []
    while chunk > 0:
        p = 1 << (chunk.bit_length() - 1)
        pieces.append(p)
        chunk -= p
    return pieces


class ShardedRuntime(_StragglerMixin):
    """Step a ``ProblemSetup`` over ``n_devices`` logical devices, one
    device-resident loop and one history fetch per LB interval.

    Parameters
    ----------
    problem:      grid + species + laser (``repro_torch.pic.problem``); the
                  box count must divide by ``n_devices``.
    n_devices:    logical devices of the ring.
    lb_interval:  steps per LB round (paper: 10).
    halo:         guard depth of the per-slot tiles (>= 4).
    comm:         ``"neighbor"`` (default): guard strips and
                  destination-aware emigrant packs over directional hops;
                  ``"ring"``: the all-gather reference path.
    overlap:      ``False`` (default): the monolithic step.  ``True``:
                  split-phase stepping (module docstring); needs
                  ``engine_backend="torch"``.
    pipeline:     ``"sync"`` (default) or ``"async"`` (double-buffered
                  intervals, adoption one interval late).
    engine_backend: ``"cuda"`` (default) runs ``kernels.ops.
                  particle_phase_slots`` (the CUDA kernels on CUDA tensors,
                  their plain versions on CPU tensors) and feeds the
                  balancer the in-kernel counters; ``"torch"`` runs
                  ``pic.engine.particle_phase_stacked`` and derives the
                  work from ``box_work_counters`` of the alive counts.
    layout:       slot curve of ``comm="neighbor"``: ``"morton"`` or
                  ``"row"`` (``pic.boxes.box_slot_layout``).
    locality_shift: adopted mappings are repaired so no box sits more than
                  this many ring hops from its curve home (neighbour mode).
    mig_cap:      initial per-offset, per-species emigrant-pack capacity
                  (default ``max(16, cap // 8)``); with ``adaptive_mig`` it
                  then tracks the observed demand (grow when the peak
                  exceeds half, shrink after ``mig_patience`` quiet
                  intervals under a quarter).
    policy / improvement_threshold / shape_order / sponge_width /
    capacity_margin / capacity_round: as the reference; the knapsack runs
                  with ``max_boxes_per_device=1.0`` (equal counts).
    devices:      the logical devices' torch devices (the first
                  ``n_devices``); by default ``n_devices`` copies of
                  ``device`` (default ``"cuda"``, which raises without one).
    strict_syncs: run each interval and each adoption's permutation under
                  ``torch.cuda.set_sync_debug_mode("error")``, so any host
                  synchronisation inside them fails; the harvest's event
                  wait is then the interval's only sync.
    """

    def __init__(
        self,
        problem: ProblemSetup,
        n_devices: int,
        lb_interval: int = 10,
        *,
        halo: int = _MIN_HALO,
        comm: str = "neighbor",
        overlap: bool = False,
        pipeline: str = "sync",
        engine_backend: str = "cuda",
        layout: str = "morton",
        locality_shift: int = 1,
        policy: str = "knapsack",
        improvement_threshold: float = 0.10,
        shape_order: int = 3,
        sponge_width: int = 8,
        capacity_margin: float = 2.0,
        capacity_round: int = 64,
        mig_cap: Optional[int] = None,
        adaptive_mig: bool = True,
        mig_patience: int = 3,
        devices: Optional[Sequence[Union[str, torch.device]]] = None,
        device: Optional[Union[str, torch.device]] = None,
        strict_syncs: bool = False,
    ):
        grid = problem.grid
        if halo < _MIN_HALO:
            raise ValueError(f"halo must be >= {_MIN_HALO} (particle stencil support)")
        if min(grid.box_nz, grid.box_nx) < halo:
            raise ValueError(
                f"boxes ({grid.box_nz}x{grid.box_nx}) must be at least halo={halo} wide"
            )
        if grid.n_boxes % n_devices:
            raise ValueError(
                f"{grid.n_boxes} boxes do not split evenly over {n_devices} "
                "devices; the sharded runtime needs equal-count slots"
            )
        if comm not in ("ring", "neighbor"):
            raise ValueError(f"comm must be 'ring' or 'neighbor', got {comm!r}")
        self.grid = grid
        self.laser = problem.laser
        self.decomp = BoxDecomposition(grid)
        self.halo = halo
        self.comm = comm
        self.overlap = bool(overlap)
        self.pipeline = validate_pipeline(pipeline)
        self.engine_backend = validate_engine_backend(engine_backend)
        if self.engine_backend == "cuda" and self.overlap:
            raise ValueError(
                "engine_backend='cuda' does not compose with overlap=True: "
                "split-phase frontier/interior deposit masking exists only in "
                "the plain tensor particle phase (engine_backend='torch')"
            )
        if self.engine_backend == "cuda" and shape_order != 3:
            raise ValueError(
                "engine_backend='cuda' supports shape_order=3 only (the kernels "
                f"implement the order-3 B-spline), got {shape_order}"
            )
        self.layout = layout
        self.locality_shift = int(locality_shift)
        self.shape_order = shape_order
        self.n_devices = n_devices
        self.lb_interval = lb_interval
        self.adaptive_mig = bool(adaptive_mig)
        self.mig_patience = int(mig_patience)
        self.strict_syncs = bool(strict_syncs)
        self.t = 0.0
        self.step_idx = 0
        #: host dispatches (interval loops launched + host->device commits)
        self.host_dispatches = 0
        #: device->host syncs (exactly one per interval piece)
        self.host_syncs = 0
        #: emigrants lost to the capacity bound (should stay 0; see mig_cap)
        self.dropped_total = 0
        #: emigrant-pack resize events (adaptive mig_cap controller)
        self.mig_events: List[Dict] = []
        #: host seconds by part of the interval loop (see pipeline_stats)
        self._host_s = {"dispatch": 0.0, "fetch": 0.0, "balance": 0.0}

        self.mesh = make_box_mesh(n_devices, devices, device)
        self.devices = list(self.mesh)
        #: the card that times the spans over every logical device, where
        #: they all share one
        self._trace_on = self.devices[0] if len(set(self.devices)) == 1 else None
        self._bpd = grid.n_boxes // n_devices

        self.balancer = LoadBalancer(
            n_devices=n_devices,
            policy=policy,
            interval=lb_interval,
            improvement_threshold=improvement_threshold,
            max_boxes_per_device=1.0,  # equal counts: mappings stay slot-permutable
        )
        self.balancer.ensure_mapping(grid.n_boxes)

        # -- geometry tables (numpy; uploaded per device at each commit) --
        pnz, pnx = grid.box_nz + 2 * halo, grid.box_nx + 2 * halo
        self.local_grid = Grid2D(
            nz=pnz, nx=pnx, dz=grid.dz, dx=grid.dx, box_nz=pnz, box_nx=pnx, cfl=grid.cfl
        )
        self._cell_map = padded_cell_map(grid, halo).astype(np.int64)
        self._int_map = interior_cell_map(grid).astype(np.int64)
        self._strips = halo_strip_tables(grid, halo)
        self._origins = np.stack(
            [
                [(bz * grid.box_nz - halo) * grid.dz, (bx * grid.box_nx - halo) * grid.dx]
                for bz, bx in grid.box_coords
            ]
        ).astype(np.float32)
        self._centers = np.stack(
            [
                [(bz + 0.5) * grid.box_nz * grid.dz, (bx + 0.5) * grid.box_nx * grid.dx]
                for bz, bx in grid.box_coords
            ]
        ).astype(np.float32)
        sponge_g = np.pad(make_sponge(grid, sponge_width).numpy(), halo, mode="wrap")
        if self.laser is not None:
            prof_g = np.pad(self.laser.profile(grid).numpy(), halo, mode="wrap")
        else:
            prof_g = np.zeros_like(sponge_g)
        statics = []
        for bz, bx in grid.box_coords:
            sz = slice(bz * grid.box_nz, bz * grid.box_nz + pnz)
            sx = slice(bx * grid.box_nx, bx * grid.box_nx + pnx)
            statics.append(np.stack([sponge_g[sz, sx], prof_g[sz, sx]]))
        self._statics = np.stack(statics).astype(np.float32)  # (n_boxes, 2, pn, pn)
        self._frontier = frontier_cell_mask(grid, halo, shape_order) if self.overlap else None

        # -- locality curve + initial slot assignment + state commit ------
        self._curve = (
            box_slot_layout(grid, layout)
            if comm == "neighbor"
            else np.arange(grid.n_boxes, dtype=np.int64)
        )
        self._home_dev = slot_home_devices(self._curve, n_devices)
        if comm == "neighbor":
            # start from the curve-contiguous mapping: equal counts, and
            # every neighbour hop as short as the curve allows
            self.balancer.mapping = self._home_dev.astype(np.int64).copy()
        self._qm = [(float(p.q), float(p.m)) for p in problem.species]
        self._slot_box = self._slots_from_mapping(self.balancer.mapping)
        self._offsets: Tuple[int, ...] = ()
        self._pair_caps: Dict[int, int] = {}
        self._pairs: List[Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]]] = []
        self._build_comm_plan()
        self._capacity_margin = float(capacity_margin)
        self._capacity_round = int(capacity_round)
        if self.engine_backend == "cuda":
            # the kernels iterate whole DEPOSIT_TILE-lane chunks, so every
            # slot capacity quantizes to the chunk
            self._capacity_round = int(np.lcm(self._capacity_round, DEPOSIT_TILE))
        self._caps: List[int] = []
        self._mig_caps: List[Dict[int, int]] = []
        self._mig_idle: Dict[Tuple[int, int], int] = {}
        tiles, species = self._pack_initial(problem.species, mig_cap)
        self._commit_state(tiles, species)

        self.history: Dict[str, List] = {
            "field_energy": [],
            "kinetic_energy": [],
            "lb_steps": [],
        }
        #: host copy of the last fetched interval history (numpy, slot order)
        self.last_history: Optional[Dict[str, np.ndarray]] = None

    # ------------------------------------------------------------------
    # placement: slots <-> boxes <-> devices
    # ------------------------------------------------------------------
    def _slots_from_mapping(self, mapping: np.ndarray) -> np.ndarray:
        """Initial slot_box: device ``d``'s slots hold its boxes in curve
        order (box-id order for ``comm="ring"``)."""
        slot_box = np.empty(self.grid.n_boxes, np.int64)
        for d in range(self.n_devices):
            boxes = np.where(np.asarray(mapping) == d)[0]
            if len(boxes) != self._bpd:
                raise ValueError("mapping must give every device the same box count")
            boxes = boxes[np.argsort(self._curve[boxes], kind="stable")]
            slot_box[d * self._bpd : (d + 1) * self._bpd] = boxes
        return slot_box

    def device_of(self, box: int) -> torch.device:
        """The torch device of the logical device owning ``box``."""
        return self.devices[int(self.balancer.mapping[box])]

    def devices_in_use(self) -> List[int]:
        """Distinct logical devices currently holding box state."""
        return sorted({int(d) for d in self.balancer.mapping})

    def _slot_of_box(self) -> np.ndarray:
        inv = np.empty(self.grid.n_boxes, np.int64)
        inv[self._slot_box] = np.arange(self.grid.n_boxes)
        return inv

    def _commit_state(self, tiles: np.ndarray, species) -> None:
        """Put slot-major host state on the logical devices (device ``d``
        takes rows ``[d*bpd, (d+1)*bpd)``) and hand the (tiles, species)
        chain to the interval pipeline: depth 1 for ``pipeline="sync"``,
        depth 2 for ``"async"``.  On a restore the pipeline is drained and
        its chain replaced."""
        bpd = self._bpd
        dev_tiles, dev_species = [], []
        for d, dev in enumerate(self.devices):
            rows = slice(d * bpd, (d + 1) * bpd)
            dev_tiles.append(torch.from_numpy(np.ascontiguousarray(tiles[rows])).to(dev))
            dev_species.append(
                tuple(
                    {k: torch.from_numpy(np.ascontiguousarray(v[rows])).to(dev) for k, v in sp.items()}
                    for sp in species
                )
            )
        pipe = getattr(self, "_pipe", None)
        if pipe is not None:
            pipe.drain()
            pipe.reset((dev_tiles, dev_species))
        else:
            self._pipe = IntervalPipeline(
                (dev_tiles, dev_species), depth=1 if self.pipeline == "sync" else 2
            )
        # where the merge's compaction writes the lanes it discards: past
        # the slot buffers, spread over _TRASH cells (per device, per species)
        self._trash = [
            [
                bpd * c + torch.arange(bpd * c, device=dev).view(bpd, c) % _TRASH
                for c in self._caps
            ]
            for dev in self.devices
        ]
        self._commit_slot_tables()
        self.host_dispatches += 1

    @property
    def _tiles(self) -> List[torch.Tensor]:
        """Tail of the pipeline's state chain: per device, the slot-major
        field interiors the next round consumes."""
        return self._pipe.state[0]

    @property
    def _species(self) -> List[Tuple[Dict[str, torch.Tensor], ...]]:
        """Tail of the pipeline's state chain: per device, the slot-major
        particle buffers of each species."""
        return self._pipe.state[1]

    def _commit_slot_tables(self) -> None:
        """Upload each device's tables for the committed ``slot_box`` (they
        change only at an adoption): its slots' boxes, origins, statics and
        centres, the box->slot and box->offset maps the routing needs, and
        the strip index tables of the committed plan."""
        S, n, bpd = self.grid.n_boxes, self.n_devices, self._bpd
        slot_of = self._slot_of_box()
        strips = self._strip_tables(slot_of) if self.comm == "neighbor" else [{}] * n
        self._dev = []
        for d, dev in enumerate(self.devices):
            boxes = self._slot_box[d * bpd : (d + 1) * bpd]
            local_slot = np.full(S, -1, np.int64)
            local_slot[boxes] = np.arange(bpd)
            tab = {
                "box": boxes.astype(np.int32),
                "origins": self._origins[boxes],
                "statics": self._statics[boxes],
                "centers": self._centers[boxes],
                "local_slot": local_slot,
                # ring offset from d to the owner of each box
                "offset_of_box": ((slot_of // bpd - d) % n).astype(np.int32),
                "q": np.array([q for q, _ in self._qm], np.float32),
                "m": np.array([m for _, m in self._qm], np.float32),
                **strips[d],
            }
            if self._frontier is not None:
                tab["frontier"] = self._frontier
            if self.comm == "ring":
                tab["my_cmap"] = self._cell_map[boxes].reshape(-1)
                tab["cmap_all"] = self._cell_map[self._slot_box].reshape(-1)
                tab["imap_all"] = self._int_map[self._slot_box].reshape(-1)
            tensors = {k: to_device(v, dev) for k, v in tab.items()}
            # strip tables cover one channel on the host; expand to all of
            # them on the device (channel-major flat layouts)
            bnsq = self.grid.box_nz * self.grid.box_nx
            pnsq = self.local_grid.nz * self.local_grid.nx
            for key in strips[d]:
                name, way, _ = key.split("_")
                n_chan = 6 if name == "paste" else 3
                stride = bpd * (bnsq if (name, way) == ("paste", "send") else pnsq)
                chan = torch.arange(n_chan, device=dev)[:, None] * stride
                tensors[key] = (chan + tensors[key][None, :]).reshape(-1)
            self._dev.append(tensors)

    def _strip_tables(self, slot_of: np.ndarray) -> List[Dict[str, np.ndarray]]:
        """Per device, the flat gather index ``slot * cells + cell`` of each
        strip cell it sends on each offset (``{name}_send_{o}``) and the flat
        scatter index where each strip cell arriving on each offset lands
        (``{name}_recv_{o}``), for one channel of the paste (from
        interiors) and of the fold (from padded deposits);
        :meth:`_commit_slot_tables` expands them over the channels.  The
        reference pads every strip to the longest direction and routes the
        padding to a dump cell; the pairs and their validity are host-known,
        so here padding is never sent."""
        n, bpd = self.n_devices, self._bpd
        bnsq = self.grid.box_nz * self.grid.box_nx
        pnsq = self.local_grid.nz * self.local_grid.nx
        out: List[Dict[str, np.ndarray]] = [{} for _ in range(n)]
        for name, n_chan, src_len in (("paste", 6, bnsq), ("fold", 3, pnsq)):
            src_tab = _pad_tables(getattr(self._strips, f"{name}_src"))
            dst_tab = _pad_tables(getattr(self._strips, f"{name}_dst"))
            for d in range(n):
                for o, (si, dj, dbox) in self._pairs[d].items():
                    r = (d + o) % n  # the receiver
                    u = slot_of[np.maximum(dbox, 0)] - r * bpd
                    ok = (
                        (dbox >= 0)[:, None]
                        & (dst_tab[dj] >= 0)
                        & (u >= 0)[:, None]
                        & (u < bpd)[:, None]
                    )
                    out[d][f"{name}_send_{o}"] = (si[:, None] * src_len + src_tab[dj])[ok]
                    out[r][f"{name}_recv_{o}"] = (u[:, None] * pnsq + dst_tab[dj])[ok]
        return out

    # ------------------------------------------------------------------
    # the neighbour-exchange plan (host side)
    # ------------------------------------------------------------------
    def _build_comm_plan(self) -> None:
        """Derive the directional exchange plan from the committed
        ``slot_box``: the ring offsets with any (slot, direction) pair on
        them, the per-offset pair capacity (max over devices, so payload
        shapes are uniform), and each device's pairs per offset — the
        reference builds the same pairs inside its program, here they are
        host-known tables.  Offset 0 carries the same-device strips."""
        if self.comm != "neighbor":
            self._offsets, self._pair_caps, self._pairs = (), {}, []
            return
        n, bpd = self.n_devices, self._bpd
        sb = self._slot_box
        slot_of = self._slot_of_box()
        dev_of_box = slot_of // bpd
        send_to = self._strips.src_box[:, list(self._strips.opposite)]  # (S, 8)
        # pairs are enumerated sender-side: slot s (box sb[s]) sends its
        # direction-j strip to the owner of send_to[sb[s], j]
        offs = (dev_of_box[send_to[sb]] - (np.arange(len(sb)) // bpd)[:, None]) % n
        counts = np.zeros((n, n), np.int64)
        np.add.at(counts, ((np.arange(len(sb)) // bpd)[:, None], offs), 1)
        caps = counts.max(axis=0)
        self._offsets = tuple(int(o) for o in np.nonzero(caps)[0])
        self._pair_caps = {int(o): int(caps[o]) for o in self._offsets}
        self._pairs = []
        for d in range(n):
            flat_off = offs[d * bpd : (d + 1) * bpd].reshape(-1)
            flat_dst = send_to[sb[d * bpd : (d + 1) * bpd]].reshape(-1)
            pairs = {}
            for o in self._offsets:
                fl = flat_off == o
                sel = np.argsort(np.where(fl, 0, 1), kind="stable")[: self._pair_caps[o]]
                valid = fl[sel]
                pairs[o] = (sel // 8, sel % 8, np.where(valid, flat_dst[sel], -1))
            self._pairs.append(pairs)

    def hop_radius(self) -> int:
        """Largest ring distance between a box's device and its curve home
        (0 on the initial neighbour-mode mapping)."""
        return hop_radius(self.balancer.mapping, self._home_dev, self.n_devices)

    def comm_stats(self) -> Dict:
        """Per-step cross-device traffic of the committed exchange plan, in
        the reference's accounting (host-side, from the plan's shapes): for
        ``comm="neighbor"`` it counts per pair the paste and fold strips and
        the two int32 routing ids the reference ships with them (the port
        derives those on the receiver), plus the emigrant packs; it is
        O(strip), flat in the box count, where ``comm="ring"`` is
        O(n_boxes · tile)."""
        n, bpd = self.n_devices, self._bpd
        n_sp = len(self._qm)
        pnz = self.grid.box_nz + 2 * self.halo
        pnx = self.grid.box_nx + 2 * self.halo
        if self.comm == "ring":
            interior = bpd * 6 * self.grid.box_nz * self.grid.box_nx
            padded = bpd * 3 * pnz * pnx
            emig = sum(bpd * d[0] * (len(_PKEYS) + 1) for d in self._mig_caps)
            # interiors + deposits + per species (dest tags, field pack)
            hops = (n - 1) * (1 + 1 + 2 * n_sp)
            return {
                "comm": "ring",
                "bytes_per_step": 4 * (n - 1) * (interior + padded + emig),
                "ppermutes_per_step": hops,
                "offsets": tuple(range(1, n)) if n > 1 else (),
            }
        m_max = max(len(t) for t in self._strips.paste_src)
        f_max = max(len(t) for t in self._strips.fold_src)
        cross = [o for o in self._offsets if o % n != 0]
        pair = sum(self._pair_caps[o] * (6 * m_max + 3 * f_max + 2 * 2) for o in cross)
        emig = sum(
            caps.get(o, 0) * (len(_PKEYS) + 1) for caps in self._mig_caps for o in cross
        )
        return {
            "comm": "neighbor",
            "bytes_per_step": 4 * (pair + emig),
            "ppermutes_per_step": len(cross) * (2 + n_sp),
            "offsets": self._offsets,
            "pair_caps": dict(self._pair_caps),
            "hop_radius": self.hop_radius(),
        }

    # ------------------------------------------------------------------
    # adaptive emigrant-pack capacity (observed-demand controller)
    # ------------------------------------------------------------------
    def _mig_keys(self) -> Tuple[int, ...]:
        """Pack keys: directional ring offsets for the neighbour exchange,
        or the single per-slot pack (key 0) for the ring path."""
        return self._offsets if self.comm == "neighbor" else (0,)

    def _init_mig_caps(self, base: int) -> Dict[int, int]:
        return {int(o): int(base) for o in self._mig_keys()}

    def migration_stats(self) -> Dict:
        """Emigrant-pack state: per-species pack capacities (keyed by ring
        offset in neighbour mode), the resize log and the overflow count."""
        self.flush()
        return {
            "comm": self.comm,
            "caps": [dict(d) for d in self._mig_caps],
            "resizes": len(self.mig_events),
            "events": list(self.mig_events),
            "dropped_total": self.dropped_total,
        }

    def _adapt_mig(
        self,
        demand: np.ndarray,
        keys: Optional[Tuple[int, ...]] = None,
        step: Optional[int] = None,
    ) -> None:
        """Resize emigrant packs from one interval's observed demand: per
        (species, slot) on the ring path, per (species, device, offset) on
        the neighbour path, both counted before the capacity bound.  Grow at
        once when the peak exceeds half the pack; shrink after
        ``mig_patience`` quiet intervals (peak under a quarter), never below
        ``_MIN_MIG``."""
        if not self.adaptive_mig:
            return
        if keys is None:
            keys = self._mig_keys()
        if step is None:
            step = self.step_idx
        for s in range(len(self._mig_caps)):
            if self.comm == "neighbor":
                # (n_steps, n_sp, n_devices * n_offsets)
                per = demand[:, s, :].reshape(demand.shape[0], self.n_devices, len(keys))
                peaks = {o: int(per[:, :, i].max()) for i, o in enumerate(keys)}
            else:
                peaks = {0: int(demand[:, s, :].max())}
            for o, peak in peaks.items():
                if o not in self._mig_caps[s]:
                    continue
                cap = self._mig_caps[s][o]
                idle = self._mig_idle.get((s, o), 0)
                new = cap
                if 2 * peak > cap:
                    new, idle = _round_up(max(2 * peak, _MIN_MIG), 8), 0
                elif 4 * peak <= cap and cap > _MIN_MIG:
                    idle += 1
                    if idle >= self.mig_patience:
                        new, idle = max(_MIN_MIG, _round_up(2 * max(peak, 1), 8)), 0
                else:
                    idle = 0
                self._mig_idle[(s, o)] = idle
                if new != cap:
                    self._mig_caps[s][o] = new
                    self.mig_events.append(
                        {"step": step, "species": s, "offset": o, "old": cap, "new": new, "peak": peak}
                    )

    # ------------------------------------------------------------------
    # initial particle packing (slot-major, fixed capacity)
    # ------------------------------------------------------------------
    def _pack_pooled(self, pooled: List[Dict[str, np.ndarray]]) -> List[Dict[str, np.ndarray]]:
        """Bin per-species pooled alive particles (flat host arrays, domain
        positions) into slot-major fixed-capacity buffers under the
        committed ``slot_box``, each slot's particles in its leading lanes.
        Grows ``self._caps`` when a box no longer fits."""
        grid, S = self.grid, self.grid.n_boxes
        box_of_slot = self._slot_box
        slot_of_box = np.empty(S, np.int64)
        slot_of_box[box_of_slot] = np.arange(S)
        self._alive_by_box = np.zeros(S, np.float64)
        packed = []
        for s_idx, pool in enumerate(pooled):
            ids = _np_box_ids(pool["z"], pool["x"], grid)
            order = np.argsort(ids, kind="stable")
            bounds = np.searchsorted(ids[order], np.arange(S + 1))
            counts = np.diff(bounds)
            peak = int(counts.max()) if len(ids) else 0
            need = _round_up(int(peak * self._capacity_margin), self._capacity_round)
            if s_idx >= len(self._caps):
                self._caps.append(need)
            elif peak > self._caps[s_idx]:
                self._caps[s_idx] = max(need, _round_up(peak, self._capacity_round))
            cap = self._caps[s_idx]
            buf = {
                "z": np.empty((S, cap), np.float32),
                "x": np.empty((S, cap), np.float32),
                "ux": np.zeros((S, cap), np.float32),
                "uy": np.zeros((S, cap), np.float32),
                "uz": np.zeros((S, cap), np.float32),
                "w": np.zeros((S, cap), np.float32),
                "alive": np.zeros((S, cap), bool),
            }
            # park dead padding at each slot's box centre (indices stay valid)
            buf["z"][:] = self._centers[box_of_slot, 0][:, None]
            buf["x"][:] = self._centers[box_of_slot, 1][:, None]
            for b in range(S):
                sel = order[bounds[b] : bounds[b + 1]]
                s, n = slot_of_box[b], len(sel)
                for k in _PKEYS:
                    buf[k][s, :n] = pool[k][sel]
                buf["alive"][s, :n] = True
                self._alive_by_box[b] += n
            packed.append(buf)
        return packed

    def _pack_initial(self, species, mig_cap):
        grid, S = self.grid, self.grid.n_boxes
        pooled = []
        for tpl in species:
            keep = tpl.alive.cpu().numpy()
            pooled.append({k: getattr(tpl, k).cpu().numpy()[keep] for k in _PKEYS})
        packed = self._pack_pooled(pooled)
        for cap in self._caps:
            base = int(mig_cap) if mig_cap is not None else max(_MIN_MIG, cap // 8)
            self._mig_caps.append(self._init_mig_caps(base))
        tiles = np.zeros((S, 6, grid.box_nz, grid.box_nx), np.float32)
        return tiles, packed

    # ------------------------------------------------------------------
    # one interval on the devices
    # ------------------------------------------------------------------
    def _particles(self, d: int, sp: Dict[str, torch.Tensor], s: int) -> Particles:
        tab = self._dev[d]
        return Particles(
            z=sp["z"], x=sp["x"], ux=sp["ux"], uy=sp["uy"], uz=sp["uz"], w=sp["w"],
            alive=sp["alive"], q=tab["q"][s], m=tab["m"][s],
        )

    def _halo_paste(self, tiles: List[torch.Tensor]) -> List[torch.Tensor]:
        """Padded ``(bpd, 6, pnz, pnx)`` tiles of every device."""
        bpd, pnz, pnx, h = self._bpd, self.local_grid.nz, self.local_grid.nx, self.halo
        if self.comm == "ring":
            ints_all = ring_all_gather(tiles)  # (S, 6, bnz, bnx) on every device
            padded = []
            for d, tab in enumerate(self._dev):
                g = torch.zeros((6, self.grid.n_cells), dtype=torch.float32, device=ints_all[d].device)
                g.index_copy_(1, tab["imap_all"], ints_all[d].transpose(0, 1).reshape(6, -1))
                padded.append(g[:, tab["my_cmap"]].view(6, bpd, pnz, pnx).transpose(0, 1))
            return padded
        init, payloads = [], []
        for d, tab in enumerate(self._dev):
            src = tiles[d].transpose(0, 1).reshape(-1)  # channel-major (6 * bpd * bnsq)
            acc = torch.zeros((6, bpd, pnz, pnx), dtype=torch.float32, device=src.device)
            acc[:, :, h:-h, h:-h] = tiles[d].transpose(0, 1)
            init.append(acc)
            payloads.append({o: src[tab[f"paste_send_{o}"]] for o in self._offsets})
        accs = neighbor_reduce(init, payloads, self._strip_fold("paste"))
        return [a.transpose(0, 1) for a in accs]

    def _strip_fold(self, name: str):
        def fold(acc, o, vals, d):
            acc.view(-1).index_add_(0, self._dev[d][f"{name}_recv_{o}"], vals)
            return acc

        return fold

    def _current_fold(self, j3: List[torch.Tensor]) -> List[torch.Tensor]:
        """Folded ``(bpd, 3, pnz, pnx)`` currents of every device."""
        bpd, pnz, pnx = self._bpd, self.local_grid.nz, self.local_grid.nx
        if self.comm == "ring":
            j_all = ring_all_gather(j3)  # (S, 3, pn, pn)
            out = []
            for d, tab in enumerate(self._dev):
                g = torch.zeros((3, self.grid.n_cells), dtype=torch.float32, device=j_all[d].device)
                g.index_add_(1, tab["cmap_all"], j_all[d].transpose(0, 1).reshape(3, -1))
                out.append(g[:, tab["my_cmap"]].view(3, bpd, pnz, pnx).transpose(0, 1))
            return out
        init, payloads = [], []
        for d, tab in enumerate(self._dev):
            acc = j3[d].transpose(0, 1).contiguous()  # channel-major (3, bpd, pnz, pnx)
            init.append(acc)
            payloads.append({o: acc.view(-1)[tab[f"fold_send_{o}"]] for o in self._offsets})
        accs = neighbor_reduce(init, payloads, self._strip_fold("fold"))
        return [a.transpose(0, 1) for a in accs]

    def _box_ids(self, p: Particles) -> torch.Tensor:
        """``Grid2D.box_of_position`` in int32 (the same truncation and
        clipping, half the bytes)."""
        g = self.grid
        bz = torch.clamp((p.z / (g.dz * g.box_nz)).to(torch.int32), 0, g.boxes_z - 1)
        bx = torch.clamp((p.x / (g.dx * g.box_nx)).to(torch.int32), 0, g.boxes_x - 1)
        return bz * g.boxes_x + bx

    def _merge(self, d: int, s: int, p: Particles, stay: torch.Tensor, gdest, gpack):
        """Each slot's stayers (in lane order) then the arrivals addressed
        to its box (in arrival order), compacted into its leading lanes;
        overflow beyond ``cap`` is dropped and counted.  Returns ``(out,
        alive, dropped)`` with per-slot ``alive`` and ``dropped``."""
        tab = self._dev[d]
        bpd, cap = stay.shape
        dev = stay.device
        n = bpd * cap
        n_stay = stay.sum(1)
        # stayer j of a row goes to lane j (int32 ranks, one int64 index)
        rank = torch.cumsum(stay, 1, dtype=torch.int32)
        row = torch.arange(bpd, device=dev)[:, None] * cap - 1
        dst_stay = torch.where(stay, rank + row, self._trash[d][s]).reshape(-1)
        del rank
        # arrivals: the local slot of their box (or bpd: not addressed here)
        g = gdest.shape[0]
        u = tab["local_slot"][gdest.clamp(min=0)]
        key = torch.where((gdest >= 0) & (u >= 0), u, bpd)
        order = torch.argsort(key, stable=True)
        skey = key[order]
        starts = torch.searchsorted(skey, torch.arange(bpd + 1, device=dev))
        rank = torch.empty_like(order).scatter_(
            0, order, torch.arange(g, device=dev) - starts[skey]
        )
        n_arr = starts[1:] - starts[:-1]
        ku = key.clamp(max=bpd - 1)
        pos_a = n_stay[ku] + rank
        ok = (key < bpd) & (pos_a < cap)
        dst_arr = torch.where(ok, ku * cap + pos_a, n + torch.arange(g, device=dev) % _TRASH)
        total = n_stay + n_arr
        new_count = total.clamp(max=cap)
        centers = tab["centers"]
        out = {}
        for ki, k in enumerate(_PKEYS):
            # dead lanes: parked at the box centre, zero payload
            buf = torch.empty(n + _TRASH, dtype=torch.float32, device=dev)
            if k in ("z", "x"):
                buf[:n].view(bpd, cap).copy_(centers[:, ki, None].expand(bpd, cap))
            else:
                buf[:n].zero_()
            buf.scatter_(0, dst_stay, getattr(p, k).reshape(-1))
            buf.scatter_(0, dst_arr, gpack[:, ki])
            out[k] = buf[:n].view(bpd, cap)
        out["alive"] = torch.arange(cap, device=dev)[None, :] < new_count[:, None]
        return out, new_count, total - new_count

    def _exchange_neighbor(self, sp2: List[Particles], s: int):
        """Destination-aware directional packs for species ``s`` on every
        device: leavers binned by the ring offset of their destination's
        owner (the first ``mig_cap`` of each offset in flat lane order), one
        hop per offset, arrivals merged into the addressed slots."""
        n = self.n_devices
        offsets = self._offsets
        caps = self._mig_caps[s]
        stays, payloads, dropped_e, demands = [], [], [], []
        for d, p in enumerate(sp2):
            tab = self._dev[d]
            new_box = self._box_ids(p)  # (bpd, cap)
            emig = p.alive & (new_box != tab["box"][:, None])
            stay = p.alive & ~emig
            emig = emig.reshape(-1)
            nb_flat = new_box.reshape(-1)
            # with one device every destination is on offset 0
            e_off = tab["offset_of_box"][nb_flat] if n > 1 else None
            payload, demand, packed = {}, [], 0
            for o in offsets:
                flag = emig if e_off is None else emig & (e_off == o)
                c = torch.cumsum(flag, 0, dtype=torch.int32)
                want = torch.arange(1, caps[o] + 1, dtype=torch.int32, device=c.device)
                sel = torch.searchsorted(c, want).clamp(max=c.shape[0] - 1)
                valid = want <= c[-1]
                pack = torch.stack([getattr(p, k).reshape(-1)[sel] for k in _PKEYS], 1)
                payload[o] = (pack, torch.where(valid, nb_flat[sel], -1))
                demand.append(c[-1])
                packed = packed + c[-1].clamp(max=caps[o])
            stays.append(stay)
            payloads.append(payload)
            dropped_e.append(emig.sum() - packed)
            demands.append(torch.stack(demand).to(torch.int32))
        arrivals = neighbor_exchange(payloads)
        results = []
        for d, p in enumerate(sp2):
            gpack = torch.cat([arrivals[d][o][0] for o in offsets])
            gdest = torch.cat([arrivals[d][o][1] for o in offsets])
            out, alive, dropped_c = self._merge(d, s, p, stays[d], gdest, gpack)
            dropped_c[0] += dropped_e[d]
            results.append((out, alive, dropped_c, demands[d]))
        return results

    def _exchange_ring(self, sp2: List[Particles], s: int):
        """Reference path: every slot's pack (its first ``mig_cap`` leavers
        in lane order) rides the full ring; every slot sees every leaver."""
        mcap = self._mig_caps[s][0]
        stays, edests, epacks, dropped_e, demands = [], [], [], [], []
        for d, p in enumerate(sp2):
            tab = self._dev[d]
            new_box = self._box_ids(p)
            emig = p.alive & (new_box != tab["box"][:, None])
            stay = p.alive & ~emig
            c = torch.cumsum(emig, 1, dtype=torch.int32)  # (bpd, cap)
            want = torch.arange(1, mcap + 1, dtype=torch.int32, device=c.device)
            want = want.expand(c.shape[0], mcap).contiguous()
            sel = torch.searchsorted(c, want).clamp(max=c.shape[1] - 1)
            ev = want <= c[:, -1:]
            edests.append(torch.where(ev, new_box.gather(1, sel), -1).reshape(-1))
            epacks.append(
                torch.stack([getattr(p, k).gather(1, sel) for k in _PKEYS], -1).reshape(-1, len(_PKEYS))
            )
            stays.append(stay)
            demands.append(c[:, -1])
            dropped_e.append(c[:, -1] - ev.sum(1))
        gdest = ring_all_gather(edests)
        gpack = ring_all_gather(epacks)
        results = []
        for d, p in enumerate(sp2):
            out, alive, dropped_c = self._merge(d, s, p, stays[d], gdest[d], gpack[d])
            results.append((out, alive, dropped_c + dropped_e[d], demands[d].to(torch.int32)))
        return results

    def _split_phase_fold(self, sp2, jF, flags) -> List[torch.Tensor]:
        """Split-phase current fold: send the frontier deposits' strips, run
        the interior deposit while they travel, fold the arrivals in after
        it.  Returns the folded ``(bpd, 3, pnz, pnx)`` currents per device."""
        bpd, pnz, pnx = self._bpd, self.local_grid.nz, self.local_grid.nx
        n_dev = self.n_devices

        def interior(d):
            with _trace.span(f"split_phase:interior:d{d}", device=d):
                return particle_phase_stacked_interior(
                    sp2[d], self._dev[d]["origins"], self.local_grid,
                    shape_order=self.shape_order, frontier_flags=flags[d],
                )

        if self.comm == "ring":
            with _trace.span("split_phase:exchange_start"):
                j_all = ring_all_gather(jF)  # (S, 3, pn, pn)
            jI = [interior(d) for d in range(n_dev)]
            with _trace.span("split_phase:exchange_done"):
                pass  # the gathered frontier deposits are read from here on
            out = []
            for d, tab in enumerate(self._dev):
                with _trace.span(f"split_phase:fold:d{d}", device=d):
                    g = torch.zeros((3, self.grid.n_cells), dtype=torch.float32, device=j_all[d].device)
                    g.index_add_(1, tab["cmap_all"], j_all[d].transpose(0, 1).reshape(3, -1))
                    # interior deposits sit >= halo inside their own box,
                    # out of every other frame's view: a local add suffices
                    out.append(g[:, tab["my_cmap"]].view(3, bpd, pnz, pnx).transpose(0, 1) + jI[d])
            return out
        payloads = []
        for d, tab in enumerate(self._dev):
            flat = jF[d].transpose(0, 1).reshape(-1)  # channel-major
            payloads.append({o: flat[tab[f"fold_send_{o}"]] for o in self._offsets})
        with _trace.span("split_phase:exchange_start"):
            handle = neighbor_exchange_start(payloads)
        accs = [(jF[d] + interior(d)).transpose(0, 1).contiguous() for d in range(n_dev)]
        with _trace.span("split_phase:exchange_done"):
            arrivals = neighbor_exchange_done(handle)
        fold = self._strip_fold("fold")
        out = []
        for d, acc in enumerate(accs):
            with _trace.span(f"split_phase:fold:d{d}", device=d):
                for o in sorted(arrivals[d]):
                    acc = fold(acc, o, arrivals[d][o], d)
            out.append(acc.transpose(0, 1))
        return out

    def _step(self, tiles, species, t):
        """One step on every device; returns the new state and the step's
        per-device history rows."""
        with _trace.step(self._trace_on):
            return self._step_body(tiles, species, t)

    def _step_body(self, tiles, species, t):
        n_dev = self.n_devices
        on = self._trace_on
        with _trace.span("pic.halo", on):
            padded = self._halo_paste(tiles)
        sp2, j3, counts, work, flags = [], [], [], [], []
        for d in range(n_dev):
            tab = self._dev[d]
            sp_in = tuple(self._particles(d, sp, s) for s, sp in enumerate(species[d]))
            if self.overlap:
                with _trace.span(f"split_phase:frontier:d{d}", device=d):
                    out_sp, j, c, fl = particle_phase_stacked_frontier(
                        padded[d], sp_in, tab["origins"], self.local_grid,
                        domain_grid=self.grid, shape_order=self.shape_order,
                        frontier_mask=tab["frontier"],
                    )
                flags.append(fl)
                w = box_work_counters(c, self.grid)
            elif self.engine_backend == "cuda":
                out_sp, j, c, w = particle_phase_slots(
                    padded[d], sp_in, tab["origins"], self.local_grid, domain_grid=self.grid,
                    logical_device=d,
                )
            else:
                out_sp, j, c = particle_phase_stacked(
                    padded[d], sp_in, tab["origins"], self.local_grid,
                    domain_grid=self.grid, shape_order=self.shape_order,
                )
                w = box_work_counters(c, self.grid)
            sp2.append(out_sp)
            j3.append(j)
            counts.append(c)
            work.append(w)
        with _trace.span("pic.fold", on):
            jp = self._split_phase_fold(sp2, j3, flags) if self.overlap else self._current_fold(j3)
        new_tiles = [
            field_phase_stacked(
                padded[d], jp[d], self._dev[d]["statics"], t[d], self.local_grid,
                self.halo, laser=self.laser, logical_device=d,
            )
            for d in range(n_dev)
        ]
        new_species = [[] for _ in range(n_dev)]
        alive = [0] * n_dev
        dropped = [0] * n_dev
        demand = [[] for _ in range(n_dev)]
        ke = [0.0] * n_dev
        exchange = self._exchange_ring if self.comm == "ring" else self._exchange_neighbor
        for s in range(len(self._qm)):
            with _trace.span("pic.exchange", on):
                moved = exchange([sp2[d][s] for d in range(n_dev)], s)
            with _trace.span("pic.diag", on):
                for d, (out, alive_s, dropped_s, demand_s) in enumerate(moved):
                    new_species[d].append(out)
                    alive[d] = alive[d] + alive_s
                    dropped[d] = dropped[d] + dropped_s
                    demand[d].append(demand_s)
                    q = self._particles(d, out, s)
                    e = q.w * q.m * (q.gamma() - 1.0)
                    ke[d] = ke[d] + torch.where(q.alive, e, 0.0).sum(1)
        dv = float(np.float32(0.5 * self.grid.dz * self.grid.dx))
        rows = []
        with _trace.span("pic.diag", on):
            for d in range(n_dev):
                fe = torch.sum(new_tiles[d] ** 2, dim=(1, 2, 3)) * dv
                rows.append(
                    (
                        torch.stack([counts[d], work[d], fe, ke[d]]),
                        torch.stack([alive[d], dropped[d]]).to(torch.int32),
                        torch.stack(demand[d]),
                    )
                )
        return new_tiles, [tuple(sp) for sp in new_species], rows

    @property
    def _strict(self) -> bool:
        return self.strict_syncs and any(d.type == "cuda" for d in self.devices)

    def _interval(self, state, n_steps: int, t_start: float):
        """The interval program: ``n_steps`` steps on the devices from
        ``state`` at time ``t_start``; returns the new state and, per
        device, the stacked history ``(f32 (n_steps, 4, bpd), i32 (n_steps,
        2, bpd), demand)``."""
        dt = self.grid.dt
        tiles, species = state
        with sync_free_region(self._strict):
            t0 = [torch.full((), t_start, dtype=torch.float32, device=dev) for dev in self.devices]
            steps = [torch.arange(n_steps, dtype=torch.float32, device=dev) for dev in self.devices]
            hist = [[] for _ in self.devices]
            for i in range(n_steps):
                t = [t0[d] + steps[d][i] * dt for d in range(self.n_devices)]
                tiles, species, rows = self._step(tiles, species, t)
                for d, r in enumerate(rows):
                    hist[d].append(r)
            return (tiles, species), [tuple(torch.stack(leaf) for leaf in zip(*h)) for h in hist]

    @staticmethod
    def _decode(host: List[Tuple[np.ndarray, ...]]) -> Dict[str, np.ndarray]:
        """A harvested history (per device) as slot-ordered arrays."""
        f32 = np.concatenate([h[0] for h in host], axis=2)  # (n_steps, 4, S)
        i32 = np.concatenate([h[1] for h in host], axis=2)
        out = {k: f32[:, i] for i, k in enumerate(_F32_KEYS)}
        out.update({k: i32[:, i] for i, k in enumerate(_I32_KEYS)})
        out["emig_demand"] = np.concatenate([h[2] for h in host], axis=2)
        return out

    # ------------------------------------------------------------------
    # host side: one interval loop + one fetch per interval piece
    # ------------------------------------------------------------------
    def run(self, n_steps: int) -> None:
        """Advance ``n_steps`` steps, one device loop per LB round (chunk
        boundaries stay aligned to ``lb_interval`` multiples)."""
        interval = max(1, self.lb_interval)
        remaining = n_steps
        while remaining > 0:
            chunk = min(remaining, interval - (self.step_idx % interval))
            for piece in _chunk_pieces(chunk, interval):
                self._run_piece(piece)
            remaining -= chunk

    def step(self) -> Dict[str, float]:
        """Advance a single step.  Under ``pipeline="async"`` the returned
        diagnostics reflect the last *harvested* round (one step behind the
        issue frontier)."""
        self._run_piece(1)
        lag = 1 if self.pipeline == "sync" else 2
        return {
            "step": self.step_idx,
            "alive": float(self._alive_by_box.sum()),
            "adopted": bool(
                self.history["lb_steps"] and self.history["lb_steps"][-1] >= self.step_idx - lag
            ),
        }

    def flush(self) -> None:
        """Drain the interval pipeline: harvest every round in flight
        (feeding the balancer, the straggler loop and the pack controller)
        and commit any adoption it triggers.  A no-op when nothing is in
        flight, as always under ``pipeline="sync"``."""
        while self._pipe.pending:
            self._harvest_one()

    def pipeline_stats(self) -> Dict:
        """Interval-pipeline accounting, in the reference's keys: the mode,
        depth, rounds in flight, rounds harvested, ``host_blocked_s`` (host
        time inside the pipeline: issuing rounds, waiting on a round's
        history) and ``overlapped_host_s`` (host time between pipeline calls
        with a round in flight: the LB turnaround ``"async"`` hides, 0 under
        ``"sync"``).  Also ``dispatch_s`` (issuing), ``fetch_s`` (waiting on
        and decoding histories) and ``balance_s`` (bookkeeping, balancer and
        adoption after each harvest)."""
        return {
            "pipeline": self.pipeline,
            "depth": self._pipe.depth,
            "pending": self._pipe.pending,
            "harvests": self._pipe.harvests,
            "host_blocked_s": self._pipe.host_blocked_s,
            "overlapped_host_s": self._pipe.overlapped_host_s,
            "host_syncs": self.host_syncs,
            "dispatch_s": self._host_s["dispatch"],
            "fetch_s": self._host_s["fetch"],
            "balance_s": self._host_s["balance"],
        }

    def interval_trace(self, n_steps: Optional[int] = None) -> List[Tuple[str, float, float]]:
        """Run (and commit) the next ``n_steps`` steps (default one LB
        interval) under ``torch.profiler`` and return the split-phase spans
        they issued, ``(name, start_us, end_us)`` in issue order: per step,
        ``split_phase:frontier:d{d}`` per device, one
        ``split_phase:exchange_start``, ``split_phase:interior:d{d}`` per
        device, one ``split_phase:exchange_done`` and
        ``split_phase:fold:d{d}`` per device.  The counterpart of the
        reference's ``interval_hlo``: a compiled program can be inspected
        without running, an eager one only by running it, so this advances
        the runtime.  :func:`split_phase_order` checks the result; a
        monolithic runtime (``overlap=False``) issues no such spans."""
        from torch.profiler import ProfilerActivity, profile

        self.flush()
        n = int(n_steps) if n_steps else max(1, self.lb_interval)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            self.run(n)
            self.flush()
        spans = [
            (e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.name.startswith("split_phase:") and e.device_type == torch.autograd.DeviceType.CPU
        ]
        return sorted(spans, key=lambda sp: sp[1])

    def _run_piece(self, n_steps: int) -> None:
        """Issue one interval piece under the current mapping, then harvest
        down to the pipeline's depth: at once under ``"sync"`` (depth 1),
        behind one round in flight under ``"async"`` (depth 2: the previous
        round's history is read while this piece executes, and an adoption
        it triggers corrects the in-flight state one interval late)."""
        meta = {
            "n_steps": n_steps,
            "step_idx": self.step_idx,
            "lb_due": self.balancer.should_run(self.step_idx),
            # histories are slot-ordered under the issue-time mapping; the
            # harvest must read them through that slot_box, not a later one
            "slot_box": self._slot_box.copy(),
            "mapping": self.balancer.mapping.copy(),
            "mig_keys": self._mig_keys(),
        }
        t0 = time.perf_counter()
        with _trace.span("dlb.issue", step=self.step_idx):
            self._pipe.enqueue(self._interval, n_steps, self.t, meta=meta)
        self._host_s["dispatch"] += time.perf_counter() - t0
        self.host_dispatches += 1
        self.step_idx += n_steps
        self.t += n_steps * self.grid.dt
        while self._pipe.pending >= self._pipe.depth:
            self._harvest_one()

    def _harvest_one(self) -> None:
        """Fetch the oldest round's history (the interval's only
        device->host sync), fold it into the host bookkeeping, and run the
        balancer if that round opened an LB interval.  An adoption is
        committed as a slot permutation of the pipeline's tail state: under
        ``"async"`` that is the in-flight round's output, so it lands one
        interval after the counters it came from."""
        t1 = time.perf_counter()
        harvested = self._pipe.harvest()
        if harvested is None:
            return
        host, meta = harvested
        with _trace.span("dlb.book", step=meta["step_idx"]):
            self._book(host, meta, t1)

    def _book(self, host, meta: Dict, t1: float) -> None:
        """Decode a harvested round's history, fold it into the host
        bookkeeping and run the balancer if the round opened an LB interval
        (``t1``: when the harvest began, for the fetch's clock)."""
        host = self._decode(host)
        t2 = time.perf_counter()
        self._host_s["fetch"] += t2 - t1
        self.last_history = host
        self.host_syncs += 1
        n_steps, step_idx = meta["n_steps"], meta["step_idx"]
        sb, mapping, keys = meta["slot_box"], meta["mapping"], meta["mig_keys"]

        n_boxes = self.grid.n_boxes
        work_box = np.empty((n_steps, n_boxes))
        work_box[:, sb] = np.asarray(host["work"], np.float64)
        counts_box = np.empty((n_steps, n_boxes))
        counts_box[:, sb] = np.asarray(host["counts"], np.float64)
        alive_box = np.empty((n_steps, n_boxes))
        alive_box[:, sb] = np.asarray(host["alive"], np.float64)
        self._alive_by_box = alive_box[-1]
        self.dropped_total += int(np.asarray(host["dropped"]).sum())
        self._adapt_mig(np.asarray(host["emig_demand"]), keys=keys, step=step_idx)
        self.history["field_energy"].extend(float(v) for v in host["field_energy"].sum(axis=1))
        self.history["kinetic_energy"].extend(float(v) for v in host["kinetic_energy"].sum(axis=1))

        if meta["lb_due"]:
            with _trace.span("dlb.decide"):
                # row 0 is the round-boundary step: what per-step
                # execution would have fed the balancer
                self._observe_straggler(work_box[0], mapping)
                new_mapping = self.balancer.step(
                    step_idx,
                    work_box[0],
                    box_coords=self.decomp.coords,
                    box_bytes=self.decomp.box_bytes(counts_box[0]),
                )
                if new_mapping is not None:
                    new_mapping = self._equalize(new_mapping, work_box[0])
                    if self.comm == "neighbor":
                        new_mapping = locality_repair(
                            new_mapping,
                            work_box[0],
                            self._home_dev,
                            self.n_devices,
                            max_shift=self.locality_shift,
                        )
            if new_mapping is not None:
                self.balancer.mapping = new_mapping
                self.history["lb_steps"].append(step_idx)
                self._recommit(new_mapping)
        self._host_s["balance"] += time.perf_counter() - t2

    # ------------------------------------------------------------------
    # adoption: re-commit the state as a slot permutation
    # ------------------------------------------------------------------
    def _equalize(self, mapping: np.ndarray, costs: np.ndarray) -> np.ndarray:
        """Repair a mapping to exactly ``bpd`` boxes per device (a no-op for
        the equal-count knapsack)."""
        m = np.asarray(mapping, np.int64).copy()
        counts = np.bincount(m, minlength=self.n_devices)
        while counts.max() > self._bpd:
            src = int(np.argmax(counts))
            boxes = np.where(m == src)[0]
            b = boxes[np.argmin(costs[boxes])]  # cheapest box moves
            under = np.where(counts < self._bpd)[0]
            loads = np.array([costs[m == d].sum() for d in under])
            dst = int(under[np.argmin(loads)])
            m[b] = dst
            counts[src] -= 1
            counts[dst] += 1
        return m

    def apply_mapping(self, new_mapping) -> None:
        """Adopt an externally decided mapping: update the balancer and
        re-commit the state.  The mapping must give every device exactly
        ``bpd`` boxes."""
        self.flush()
        new = np.asarray(new_mapping, dtype=np.int64)
        if new.shape != (self.grid.n_boxes,) or new.min() < 0 or new.max() >= self.n_devices:
            raise ValueError("mapping must assign every box to a valid device slot")
        if np.any(np.bincount(new, minlength=self.n_devices) != self._bpd):
            raise ValueError(
                f"sharded runtime mappings must give every device exactly {self._bpd} boxes"
            )
        self.balancer.mapping = new
        self._recommit(new)

    def _recommit(self, new_mapping: np.ndarray) -> None:
        """Realize an adopted mapping as a slot permutation.  Boxes staying
        on a device keep their slots; incoming boxes fill the freed slots in
        curve order.  The permutation is a correction of the pipeline's tail
        state, so under ``pipeline="async"`` it applies to the in-flight
        round's output, one interval after the counters that motivated it.
        With ``strict_syncs`` it and the tables' upload run under sync-debug
        mode "error": neither may wait on the round in flight."""
        with _trace.span("dlb.adopt"):
            self._permute_slots(new_mapping)

    def _permute_slots(self, new_mapping: np.ndarray) -> None:
        S, bpd = self.grid.n_boxes, self._bpd
        old_slot_of_box = np.empty(S, np.int64)
        old_slot_of_box[self._slot_box] = np.arange(S)
        new_slot_box = -np.ones(S, np.int64)
        for d in range(self.n_devices):
            slots = np.arange(d * bpd, (d + 1) * bpd)
            for s in slots:
                if new_mapping[self._slot_box[s]] == d:
                    new_slot_box[s] = self._slot_box[s]
            incoming = [
                b for b in np.where(new_mapping == d)[0] if new_slot_box[old_slot_of_box[b]] != b
            ]
            incoming.sort(key=lambda b: self._curve[b])
            free = [s for s in slots if new_slot_box[s] < 0]
            for s, b in zip(free, incoming):
                new_slot_box[s] = b
        if (new_slot_box < 0).any() or len(set(new_slot_box)) != S:
            raise AssertionError("slot permutation must cover every box once")
        perm = old_slot_of_box[new_slot_box]
        with sync_free_region(self._strict):
            self._pipe.correct(self._permute_state, perm)
            self._slot_box = new_slot_box
            if self.comm == "neighbor":
                old_offsets = self._offsets
                self._build_comm_plan()
                if self._offsets != old_offsets:
                    # keep learned pack capacities on surviving offsets; new
                    # offsets start from the floor (demand-driven growth reacts
                    # within one interval)
                    for s, d in enumerate(self._mig_caps):
                        self._mig_caps[s] = {o: d.get(o, _MIN_MIG) for o in self._offsets}
                    self._mig_idle = {
                        (s, o): v for (s, o), v in self._mig_idle.items() if o in self._offsets
                    }
            self._commit_slot_tables()
        self.host_dispatches += 2  # the permutation + the tables' commit

    def _permute_state(self, state, perm: np.ndarray):
        """The adoption's slot permutation of a (tiles, species) state: new
        slot ``s`` takes old slot ``perm[s]``.  Rows move between logical
        devices with one ``index_select`` per (source, destination) pair;
        the indices travel without a host sync."""
        bpd, n_dev = self._bpd, self.n_devices
        tiles, species = state
        moves = []
        for d, dev in enumerate(self.devices):
            src = perm[d * bpd : (d + 1) * bpd]
            if np.array_equal(src, np.arange(d * bpd, (d + 1) * bpd)):
                moves.append(None)
                continue
            pairs = []
            for e in np.unique(src // bpd):
                rows = np.nonzero(src // bpd == e)[0]
                pairs.append((int(e), to_device(src[rows] - e * bpd, self.devices[e]),
                              to_device(rows, dev)))
            moves.append(pairs)

        def permute(per_device: List[torch.Tensor]) -> List[torch.Tensor]:
            out = []
            for d, dev in enumerate(self.devices):
                if moves[d] is None:
                    out.append(per_device[d])
                    continue
                new = torch.empty_like(per_device[d])
                for e, take, rows in moves[d]:
                    moved = per_device[e].index_select(0, take).to(dev, non_blocking=True)
                    new.index_copy_(0, rows, moved)
                out.append(new)
            return out

        n_sp = len(self._qm)
        per_key = {
            (s, k): permute([species[d][s][k] for d in range(n_dev)])
            for s in range(n_sp)
            for k in species[0][s]
        }
        new_species = [
            tuple({k: per_key[(s, k)][d] for k in species[0][s]} for s in range(n_sp))
            for d in range(n_dev)
        ]
        return permute(tiles), new_species

    # ------------------------------------------------------------------
    # capacity awareness (straggler mitigation hook)
    # ------------------------------------------------------------------
    def update_capacities(self, capacities: Optional[np.ndarray]) -> None:
        """Feed a per-device capacity vector into the knapsack and force the
        next LB round to rebalance against it."""
        self.balancer.set_capacities(capacities)
        self.balancer.force_rebalance()

    # ------------------------------------------------------------------
    # observability (host bookkeeping; never on the hot path)
    # ------------------------------------------------------------------
    def n_slots(self) -> int:
        """Balancer work items this runtime places: one slot per box."""
        return self.grid.n_boxes

    def slot_costs(self) -> Optional[np.ndarray]:
        """Smoothed per-box work-counter costs as of the last LB round."""
        return self.balancer.smoothed_costs

    def total_alive(self) -> int:
        """Alive particles across all boxes and species, from the last
        fetched interval history."""
        self.flush()
        return int(self._alive_by_box.sum())

    def box_counts(self) -> np.ndarray:
        """Alive particles per box (all species), from the last interval."""
        self.flush()
        return self._alive_by_box.copy()

    # ------------------------------------------------------------------
    # recovery surface
    # ------------------------------------------------------------------
    def _host_tiles(self) -> np.ndarray:
        """Slot-major interiors ``(S, 6, bnz, bnx)`` on the host."""
        return np.concatenate([t.cpu().numpy() for t in self._tiles])

    def snapshot(self) -> Dict:
        """Recoverable state at the last interval boundary as numpy leaves in
        box-major layout (device-count independent): interiors by box id,
        pooled alive particles per species, per-box counts, time/step, the
        mapping, balancer state and the pack capacities."""
        self.flush()
        inv = self._slot_of_box()
        tiles = self._host_tiles()[inv]
        species = []
        for s in range(len(self._qm)):
            # compacted on each device (slot-major, lane order), so only the
            # alive particles cross to the host
            alive = [sp[s]["alive"].reshape(-1) for sp in self._species]
            species.append(
                {
                    k: np.concatenate(
                        [sp[s][k].reshape(-1)[a].cpu().numpy() for sp, a in zip(self._species, alive)]
                    )
                    for k in _PKEYS
                }
            )
        snap: Dict = {
            "tiles": tiles,
            "species": species,
            "counts": self._alive_by_box.copy(),
            "t": np.float64(self.t),
            "step_idx": np.int64(self.step_idx),
            "mapping": np.asarray(self.balancer.mapping, np.int64).copy(),
            "n_devices": np.int64(self.n_devices),
            "mig_caps": [{int(o): np.int64(c) for o, c in d.items()} for d in self._mig_caps],
        }
        snap.update(snapshot_balancer(self.balancer))
        return snap

    def restore(self, snap: Dict) -> None:
        """Adopt a :meth:`snapshot`, possibly taken on another device count:
        the checkpointed populations are re-knapsacked onto this runtime's
        devices (gate bypassed, locality-repaired in neighbour mode), state
        is re-committed slot-major, and pack capacities are restored (summed
        when the device count changed).  Rounds in flight are discarded."""
        grid, S = self.grid, self.grid.n_boxes
        tiles = np.asarray(snap["tiles"], np.float32)
        if tiles.shape != (S, 6, grid.box_nz, grid.box_nx):
            raise ValueError(
                f"snapshot tiles {tiles.shape} do not fit this grid "
                f"({S} boxes of 6x{grid.box_nz}x{grid.box_nx})"
            )
        if len(snap["species"]) != len(self._qm):
            raise ValueError("snapshot species count does not match this problem")
        # rounds still in flight belong to the timeline the restore rolls
        # back: _commit_state drops them unread.  The reference harvests
        # them first, which feeds their counters to the balancer about to
        # be replaced and fails when a corrupt-state fault has poisoned it
        restore_balancer(self.balancer, snap, n_boxes=S)
        counts = np.nan_to_num(np.asarray(snap["counts"], np.float64), nan=0.0)
        costs = np.maximum(counts, 0.0)
        mapping = np.asarray(self.balancer.propose(costs, box_coords=self.decomp.coords), np.int64)
        mapping = self._equalize(mapping, costs)
        if self.comm == "neighbor":
            mapping = locality_repair(
                mapping, costs, self._home_dev, self.n_devices, max_shift=self.locality_shift
            )
        self.balancer.mapping = mapping
        self.balancer.force_rebalance()
        self._slot_box = self._slots_from_mapping(mapping)
        self._build_comm_plan()
        saved = snap.get("mig_caps")
        same_mesh = int(snap.get("n_devices", self.n_devices)) == self.n_devices
        if saved is not None and len(saved) == len(self._mig_caps):
            for s, d in enumerate(saved):
                table = {int(o): int(c) for o, c in d.items()}
                base = max(_MIN_MIG, self._caps[s] // 8) if s < len(self._caps) else _MIN_MIG
                if same_mesh:
                    self._mig_caps[s] = {o: max(base, table.get(o, base)) for o in self._mig_keys()}
                else:
                    pooled_cap = max(base, sum(table.values()))
                    self._mig_caps[s] = {o: pooled_cap for o in self._mig_keys()}
            self._mig_idle = {}
        pooled = [{k: np.asarray(sp[k], np.float32) for k in _PKEYS} for sp in snap["species"]]
        packed = self._pack_pooled(pooled)
        self._commit_state(tiles[self._slot_box], packed)
        self.t = float(snap["t"])
        self.step_idx = int(snap["step_idx"])

    @property
    def fields(self) -> Fields:
        """Global field state assembled on the host (CPU tensors) from the
        slot tiles."""
        self.flush()
        grid = self.grid
        tiles = self._host_tiles()
        out = np.zeros((6, grid.nz, grid.nx), np.float32)
        for s, b in enumerate(self._slot_box):
            bz, bx = grid.box_coords[b]
            out[
                :,
                bz * grid.box_nz : (bz + 1) * grid.box_nz,
                bx * grid.box_nx : (bx + 1) * grid.box_nx,
            ] = tiles[s]
        return Fields(*(torch.from_numpy(c.copy()) for c in out))


def split_phase_order(spans: Sequence[Tuple[str, float, float]], n_devices: int) -> List[str]:
    """Check the split-phase window on an :meth:`ShardedRuntime.
    interval_trace`: for every step and device the interior deposit is
    issued after the step's exchange start has returned and ends before its
    exchange done begins, and no arrival is folded before that device's
    interior deposit has been issued.  Returns the violations (empty when
    the window holds); a trace without split-phase spans is one."""
    by_name: Dict[str, List[Tuple[float, float]]] = {}
    for name, start, end in spans:
        by_name.setdefault(name, []).append((start, end))
    starts = by_name.get("split_phase:exchange_start", [])
    dones = by_name.get("split_phase:exchange_done", [])
    if not starts:
        return ["the trace holds no split-phase spans"]
    out = []
    if len(dones) != len(starts):
        out.append(f"{len(starts)} exchange starts but {len(dones)} exchange dones")
    for d in range(n_devices):
        frontier = by_name.get(f"split_phase:frontier:d{d}", [])
        interior = by_name.get(f"split_phase:interior:d{d}", [])
        fold = by_name.get(f"split_phase:fold:d{d}", [])
        if not (len(frontier) == len(interior) == len(fold) == len(starts)):
            out.append(f"device {d}: {len(frontier)} frontier, {len(interior)} interior, "
                       f"{len(fold)} fold spans for {len(starts)} steps")
            continue
        for i, (st, dn, fr, it, fo) in enumerate(zip(starts, dones, frontier, interior, fold)):
            if not fr[1] <= st[0]:
                out.append(f"step {i} device {d}: frontier deposit not done before the exchange start")
            if not st[1] <= it[0]:
                out.append(f"step {i} device {d}: interior deposit issued before the exchange start returned")
            if not it[1] <= dn[0]:
                out.append(f"step {i} device {d}: interior deposit ends after the exchange done begins")
            if not it[1] <= fo[0]:
                out.append(f"step {i} device {d}: an arrival folded before the interior deposit was issued")
    return out
