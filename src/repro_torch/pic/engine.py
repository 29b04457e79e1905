"""Device-resident multi-step PIC execution engine.

Counterpart of ``repro.pic.engine``.  The paper's point is that in-situ cost
assessment must be cheap relative to the physics: the balancer consumes
costs once per LB interval, so nothing in the hot loop touches the host
more often than that.

  * :func:`particle_phase` / :func:`field_phase` — the two halves of one
    step (gather + push + move + deposit; Maxwell leapfrog + laser +
    sponge).  Both accept a *local* grid plus an ``origin`` /
    ``domain_grid`` (and a per-tile laser profile), so the same physics runs
    on a halo-padded box tile as on the global grid.
  * :func:`particle_phase_stacked` / :func:`field_phase_stacked` — the same
    two halves over a stack of box slots ``(slots, ...)`` at once, as
    batched tensor code (no loop over slots): the sharded runtime's step.
  * :func:`particle_phase_stacked_frontier` /
    :func:`particle_phase_stacked_interior` — the same particle phase split
    in two for split-phase stepping (``ShardedRuntime(overlap=True)``):
    advance everything and deposit only the frontier, then deposit the
    rest without recomputing any physics.
  * :func:`build_step_body` — one step as ``(fields, species, t) ->
    (fields, species, StepOutputs)``.  ``engine_backend="cuda"`` routes the
    particle phase through the binned kernels and threads their in-kernel
    counters out; ``"torch"`` is the global plain-tensor path with the
    counters from ``box_work_counters``.
  * :func:`make_interval_fn` — ``n_steps`` applications of the body as a
    device-resident loop: per-step outputs are stacked on the device into
    ``(n_steps, ...)`` history tensors, and nothing reaches the host until
    the caller fetches them, once per interval.  (PyTorch runs eagerly, so
    the loop issues the same kernels a scan would; the step count stays a
    host integer and time stays a device tensor, ``t0 + i·dt``.)
  * :class:`IntervalPipeline` — interval programs as re-enqueueable
    closures over a rotating state, double-buffered: round *k+1* is issued
    before round *k*'s history is read, so the balancer's turnaround
    overlaps device work (``pipeline="async"``).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Deque, List, NamedTuple, Optional, Tuple

import torch

from .. import _trace
from .._device import map_tensors
from .deposition import box_particle_counts, box_work_counters, deposit_current
from .fields import Fields, apply_sponge, field_energy, step_b_half, step_e
from .grid import Grid2D
from .particles import (
    Particles,
    advance_positions,
    boris_push,
    gather_fields,
    kinetic_energy,
)
from .shapes import shape_weights

__all__ = [
    "ENGINE_BACKENDS",
    "StepOutputs",
    "particle_phase",
    "field_phase",
    "particle_phase_stacked",
    "particle_phase_stacked_frontier",
    "particle_phase_stacked_interior",
    "field_phase_stacked",
    "build_step_body",
    "make_interval_fn",
    "IntervalPipeline",
]

#: particle-phase backends: the global tensor path, or the binned CUDA kernels
ENGINE_BACKENDS = ("torch", "cuda")


class StepOutputs(NamedTuple):
    """Per-step device-side accounting emitted by the step body; under
    :func:`make_interval_fn` each leaf gains a leading ``(n_steps,)`` axis."""

    counts: torch.Tensor  # (n_boxes,) f32 — alive particles per box
    work: torch.Tensor  # (n_boxes,) f32 — executed work units
    field_energy: torch.Tensor  # 0-d f32
    kinetic_energy: torch.Tensor  # 0-d f32
    dropped: torch.Tensor  # 0-d i32 — particles lost to the bin capacity guard
    # (n_species, n_boxes) f32 — the per-species counts ``counts`` sums; the
    # work signal is additive over species, so this is what checks it
    species_counts: torch.Tensor


def validate_engine_backend(engine_backend: str) -> str:
    if engine_backend not in ENGINE_BACKENDS:
        raise ValueError(
            f"engine_backend must be one of {ENGINE_BACKENDS}, got {engine_backend!r}"
        )
    return engine_backend


def particle_phase(
    fields: Fields,
    species: Tuple[Particles, ...],
    grid: Grid2D,
    shape_order: int = 3,
    *,
    domain_grid: Optional[Grid2D] = None,
    origin: Tuple = (0.0, 0.0),
):
    """Gather + Boris push + move + current deposit for all species.

    ``grid`` is the grid the fields live on: the global grid, or a
    halo-padded box tile.  ``origin`` is the physical position of
    ``grid``'s cell (0, 0) (particles keep domain positions, so migration
    never rebases them), and ``domain_grid`` bounds the kill at the domain
    edge (default ``grid``).  Returns ``(species', (jx, jy, jz), counts)``
    with ``counts`` the alive particles per box of ``grid`` after the move.
    """
    dom = grid if domain_grid is None else domain_grid
    oz, ox = origin
    shifted = not (isinstance(oz, float) and isinstance(ox, float) and oz == 0.0 and ox == 0.0)
    dev = fields.ex.device
    jx = torch.zeros(grid.shape, dtype=torch.float32, device=dev)
    jy = torch.zeros(grid.shape, dtype=torch.float32, device=dev)
    jz = torch.zeros(grid.shape, dtype=torch.float32, device=dev)
    counts = torch.zeros(grid.n_boxes, dtype=torch.float32, device=dev)
    out_species = []
    for p in species:
        z_loc = p.z - oz if shifted else p.z
        x_loc = p.x - ox if shifted else p.x
        eb = gather_fields(fields, z_loc, x_loc, grid, shape_order)
        p = advance_positions(boris_push(p, eb, grid.dt), dom, grid.dt)
        out_species.append(p)
        p_loc = p._replace(z=p.z - oz, x=p.x - ox) if shifted else p
        jx_, jy_, jz_ = deposit_current(p_loc, grid, shape_order)
        jx, jy, jz = jx + jx_, jy + jy_, jz + jz_
        counts = counts + box_particle_counts(p_loc, grid)
    return tuple(out_species), (jx, jy, jz), counts


def field_phase(
    fields: Fields,
    j,
    grid: Grid2D,
    *,
    sponge: Optional[torch.Tensor] = None,
    laser=None,
    t=None,
    laser_profile: Optional[torch.Tensor] = None,
) -> Fields:
    """Maxwell leapfrog (B half, E full, B half) + laser injection + sponge.

    ``laser_profile`` selects the offset-aware injection (a fixed spatial
    profile times a time-dependent scalar, ``LaserAntenna.inject_profile``)
    for tiles whose frame differs from the global grid; without it the
    antenna injects on its global row."""
    with _trace.span("pic.field", fields.ex.device):
        return _field_phase(fields, j, grid, sponge, laser, t, laser_profile)


def _field_phase(fields: Fields, j, grid: Grid2D, sponge, laser, t, laser_profile) -> Fields:
    fields = step_b_half(fields, grid)
    fields = step_e(fields, j, grid)
    fields = step_b_half(fields, grid)
    if laser is not None:
        if laser_profile is None:
            fields = laser.inject(fields, grid, t)
        else:
            fields = laser.inject_profile(fields, laser_profile, grid, t)
    if sponge is not None:
        fields = apply_sponge(fields, sponge)
    return fields


def _patch_index(iz, ix, npts: int, nz: int, nx: int) -> torch.Tensor:
    """In-tile flat cell ``row * nx + col`` of each particle's stencil
    points, periodic within the tile: ``(slots, N, npts, npts)``."""
    offs = torch.arange(npts, device=iz.device)
    rows = torch.remainder(iz[..., None] + offs, nz)
    cols = torch.remainder(ix[..., None] + offs, nx)
    return rows[..., :, None] * nx + cols[..., None, :]


def _gather_stacked(f: Fields, z, x, grid: Grid2D, order: int):
    """``gather_fields`` over a stack of tiles: ``f`` components
    ``(slots, nz, nx)``, positions ``(slots, N)`` in the tiles' frame."""
    iz0, wz0 = shape_weights(z, grid.dz, 0.0, order)
    izh, wzh = shape_weights(z, grid.dz, 0.5, order)
    ix0, wx0 = shape_weights(x, grid.dx, 0.0, order)
    ixh, wxh = shape_weights(x, grid.dx, 0.5, order)
    npts = order + 1
    slots = z.shape[0]

    def interp(c, iz, wz, ix, wx):
        idx = _patch_index(iz, ix, npts, grid.nz, grid.nx)
        vals = torch.gather(c.reshape(slots, -1), 1, idx.reshape(slots, -1)).view(idx.shape)
        return torch.einsum("spij,spi,spj->sp", vals, wz, wx)

    return (
        interp(f.ex, iz0, wz0, ixh, wxh),
        interp(f.ey, iz0, wz0, ix0, wx0),
        interp(f.ez, izh, wzh, ix0, wx0),
        interp(f.bx, izh, wzh, ix0, wx0),
        interp(f.by, izh, wzh, ixh, wxh),
        interp(f.bz, iz0, wz0, ixh, wxh),
    )


def _deposit_stacked(p: Particles, grid: Grid2D, order: int) -> torch.Tensor:
    """``deposit_current`` over a stack of tiles in one flat ``index_add_``:
    ``p`` leaves ``(slots, N)`` in the tiles' frame, returns ``(slots, 3,
    nz, nx)``."""
    gamma = p.gamma()
    inv_vol = 1.0 / (grid.dz * grid.dx)
    qw = p.q * p.w * inv_vol
    coef = torch.where(p.alive, qw, torch.zeros_like(qw)) / gamma
    iz0, wz0 = shape_weights(p.z, grid.dz, 0.0, order)
    izh, wzh = shape_weights(p.z, grid.dz, 0.5, order)
    ix0, wx0 = shape_weights(p.x, grid.dx, 0.0, order)
    ixh, wxh = shape_weights(p.x, grid.dx, 0.5, order)
    slots, npts, cells = p.z.shape[0], order + 1, grid.nz * grid.nx
    slot_base = (torch.arange(slots, device=p.z.device) * (3 * cells))[:, None, None, None]
    idx, vals = [], []
    for c, (iz, wz, ix, wx, u) in enumerate(
        ((iz0, wz0, ixh, wxh, p.ux), (iz0, wz0, ix0, wx0, p.uy), (izh, wzh, ix0, wx0, p.uz))
    ):
        val = coef * u
        vals.append(val[..., None, None] * wz[..., :, None] * wx[..., None, :])
        idx.append(slot_base + c * cells + _patch_index(iz, ix, npts, grid.nz, grid.nx))
    out = torch.zeros(slots * 3 * cells, dtype=torch.float32, device=p.z.device)
    out.index_add_(0, torch.stack(idx, 1).reshape(-1), torch.stack(vals, 1).reshape(-1))
    return out.view(slots, 3, grid.nz, grid.nx)


def particle_phase_stacked(
    tiles6: torch.Tensor,
    species: Tuple[Particles, ...],
    origins: torch.Tensor,
    local_grid: Grid2D,
    *,
    domain_grid: Grid2D,
    shape_order: int = 3,
):
    """Slot-batched :func:`particle_phase` on padded box tiles.

    ``tiles6`` is ``(slots, 6, pnz, pnx)``, ``origins`` ``(slots, 2)`` (the
    physical position of each tile's cell (0, 0)), and every ``Particles``
    leaf ``(slots, cap)`` except the 0-d ``q``/``m``.  Returns ``(species',
    j3, counts)``: the un-folded per-tile deposits ``(slots, 3, pnz, pnx)``
    and the ``(slots,)`` alive counts after the move, summed over species.
    """
    fields = Fields(*tiles6.unbind(1))
    oz, ox = origins[:, 0:1], origins[:, 1:2]
    slots = tiles6.shape[0]
    j3 = torch.zeros((slots, 3) + local_grid.shape, dtype=torch.float32, device=tiles6.device)
    counts = torch.zeros(slots, dtype=torch.float32, device=tiles6.device)
    out_species = []
    for p in species:
        eb = _gather_stacked(fields, p.z - oz, p.x - ox, local_grid, shape_order)
        p = advance_positions(boris_push(p, eb, local_grid.dt), domain_grid, local_grid.dt)
        out_species.append(p)
        j3 = j3 + _deposit_stacked(p._replace(z=p.z - oz, x=p.x - ox), local_grid, shape_order)
        counts = counts + p.alive.sum(1).to(torch.float32)
    return tuple(out_species), j3, counts


def _frontier_flag(p: Particles, oz, ox, grid: Grid2D, mask: torch.Tensor) -> torch.Tensor:
    """Whether each particle's post-move cell lies on the frontier.

    ``mask`` is the padded-tile bool map of ``pic.boxes.frontier_cell_mask``
    and ``oz``/``ox`` the ``(slots, 1)`` tile origins; the cell lookup is
    clipped to the tile, so a particle observed outside it (mid-migration,
    or parked dead padding) classifies through the boundary cells, which
    are frontier by construction."""
    cz = torch.clamp((p.z - oz) / grid.dz, 0.0, grid.nz - 1).to(torch.int32)
    cx = torch.clamp((p.x - ox) / grid.dx, 0.0, grid.nx - 1).to(torch.int32)
    return mask.reshape(-1)[cz * grid.nx + cx]


def particle_phase_stacked_frontier(
    tiles6: torch.Tensor,
    species: Tuple[Particles, ...],
    origins: torch.Tensor,
    local_grid: Grid2D,
    *,
    domain_grid: Grid2D,
    shape_order: int = 3,
    frontier_mask: torch.Tensor,
):
    """Frontier half of the split-phase step: advance everything, deposit
    only what the halo exchange depends on.

    The same gather + Boris push + move as :func:`particle_phase_stacked`
    for **all** particles, but the deposit masks to particles whose
    post-move cell is on the frontier (``frontier_mask``): exactly the
    deposits the fold strips can see, so the strips can be sent from the
    returned ``j3`` before any interior work.  Masking zeroes the deposit
    coefficient, so ``j3`` equals the monolithic deposit on every sent
    cell.  Returns ``(species', j3_frontier, counts, frontier_flags)``:
    ``species'`` and ``counts`` (all alive particles) as the monolithic
    pass; one ``(slots, cap)`` bool flag tensor per species for
    :func:`particle_phase_stacked_interior`.
    """
    fields = Fields(*tiles6.unbind(1))
    oz, ox = origins[:, 0:1], origins[:, 1:2]
    slots = tiles6.shape[0]
    j3 = torch.zeros((slots, 3) + local_grid.shape, dtype=torch.float32, device=tiles6.device)
    counts = torch.zeros(slots, dtype=torch.float32, device=tiles6.device)
    out_species, flags = [], []
    for p in species:
        eb = _gather_stacked(fields, p.z - oz, p.x - ox, local_grid, shape_order)
        p = advance_positions(boris_push(p, eb, local_grid.dt), domain_grid, local_grid.dt)
        out_species.append(p)
        on_frontier = _frontier_flag(p, oz, ox, local_grid, frontier_mask)
        flags.append(on_frontier)
        p_loc = p._replace(z=p.z - oz, x=p.x - ox, alive=p.alive & on_frontier)
        j3 = j3 + _deposit_stacked(p_loc, local_grid, shape_order)
        counts = counts + p.alive.sum(1).to(torch.float32)
    return tuple(out_species), j3, counts, tuple(flags)


def particle_phase_stacked_interior(
    species: Tuple[Particles, ...],
    origins: torch.Tensor,
    local_grid: Grid2D,
    *,
    shape_order: int = 3,
    frontier_flags: Tuple[torch.Tensor, ...],
) -> torch.Tensor:
    """Interior half of the split-phase step: deposit the particles the
    frontier pass left out, from the **already advanced** species (no
    physics recomputed).  These deposits cannot touch a sent strip cell,
    so this pass does not depend on the strip exchange: it is the window
    the exchange is issued across.  ``j3_frontier + j3_interior`` matches
    the monolithic deposit to f32 rounding (only the per-cell sum order
    changes).  Returns ``(slots, 3, pnz, pnx)``."""
    oz, ox = origins[:, 0:1], origins[:, 1:2]
    slots = origins.shape[0]
    j3 = torch.zeros((slots, 3) + local_grid.shape, dtype=torch.float32, device=origins.device)
    for p, on_frontier in zip(species, frontier_flags):
        p_loc = p._replace(z=p.z - oz, x=p.x - ox, alive=p.alive & ~on_frontier)
        j3 = j3 + _deposit_stacked(p_loc, local_grid, shape_order)
    return j3


def field_phase_stacked(
    tiles6: torch.Tensor,
    j3: torch.Tensor,
    static2: torch.Tensor,
    t,
    local_grid: Grid2D,
    halo: int,
    *,
    laser=None,
    logical_device: Optional[int] = None,
) -> torch.Tensor:
    """Slot-batched :func:`field_phase` on padded tiles, keeping interiors.

    ``tiles6``/``j3`` are ``(slots, 6|3, pnz, pnx)`` padded E,B and folded
    J; ``static2`` ``(slots, 2, pnz, pnx)`` holds each slot's sponge mask
    and laser profile.  Returns the advanced ``(slots, 6, bnz, bnx)``
    interiors: with ``halo >= 4`` the three one-cell-deep leapfrog updates
    never reach the interior from the tile edge, so it matches the global
    solver to f32 rounding.  ``logical_device`` names the slots' logical
    device in the ``pic.field`` span."""
    with _trace.span("pic.field", tiles6.device, device=logical_device):
        f = _field_phase(
            Fields(*tiles6.unbind(1)), tuple(j3.unbind(1)), local_grid,
            static2[:, 0], laser, t, static2[:, 1],
        )
        return torch.stack(f, 1)[:, :, halo:-halo, halo:-halo].contiguous()


def build_step_body(
    grid: Grid2D,
    *,
    device,
    shape_order: int = 3,
    sponge: Optional[torch.Tensor] = None,
    laser=None,
    engine_backend: str = "torch",
    kernel_cap: Optional[int] = None,
) -> Callable:
    """Build the single-step body ``step(fields, species, t) -> (fields,
    species, StepOutputs)`` for state on ``device``."""
    use_kernels = validate_engine_backend(engine_backend) == "cuda"
    if use_kernels:
        if shape_order != 3:
            raise ValueError("the CUDA kernels implement order-3 shapes only")
        if kernel_cap is None:
            raise ValueError('engine_backend="cuda" requires kernel_cap')
        from ..kernels import ops as kops

        kops.device_tables(grid, device)  # the one host->device copy, up front

    def step(fields: Fields, species: Tuple[Particles, ...], t: torch.Tensor):
        with _trace.step(fields.ex.device):
            return body(fields, species, t)

    def body(fields: Fields, species: Tuple[Particles, ...], t: torch.Tensor):
        dev = fields.ex.device
        jx = torch.zeros(grid.shape, dtype=torch.float32, device=dev)
        jy = torch.zeros(grid.shape, dtype=torch.float32, device=dev)
        jz = torch.zeros(grid.shape, dtype=torch.float32, device=dev)
        counts = torch.zeros(grid.n_boxes, dtype=torch.float32, device=dev)
        dropped = torch.zeros((), dtype=torch.int32, device=dev)
        if use_kernels:
            work = torch.zeros(grid.n_boxes, dtype=torch.float32, device=dev)
            new_species, per_species = [], []
            for p in species:
                p2, (jx_, jy_, jz_), counters, counts_b, nd = kops.pic_substep_body(
                    fields, p, grid=grid, dt=grid.dt, cap=kernel_cap
                )
                new_species.append(p2)
                jx, jy, jz = jx + jx_, jy + jy_, jz + jz_
                per_species.append(counts_b.to(torch.float32))
                counts = counts + per_species[-1]
                # species by species, as the reference sums them
                work = work + counters.to(torch.float32)
                # particles beyond a bin's capacity skip this step's push
                dropped = dropped + nd
            species = tuple(new_species)
        else:
            species, (jx, jy, jz), counts = particle_phase(fields, species, grid, shape_order)
            work = box_work_counters(counts, grid)
            per_species = [box_particle_counts(p, grid) for p in species]
        fields = field_phase(fields, (jx, jy, jz), grid, sponge=sponge, laser=laser, t=t)
        with _trace.span("pic.diag", dev):
            out = StepOutputs(
                counts=counts,
                work=work,
                field_energy=field_energy(fields, grid),
                kinetic_energy=sum(kinetic_energy(p) for p in species),
                dropped=dropped,
                species_counts=torch.stack(per_species),
            )
        return fields, species, out

    return step


def make_interval_fn(step_body: Callable, grid: Grid2D) -> Callable:
    """``interval(fields, species, t0, n_steps) -> (fields, species,
    StepOutputs)`` with a leading ``(n_steps,)`` history axis on every
    output.  ``t0`` is a 0-d float32 device tensor; step i runs at
    ``t0 + i·dt`` in float32 on the device.  Issues no host sync."""
    dt = grid.dt

    def interval(fields: Fields, species, t0: torch.Tensor, n_steps: int):
        steps = torch.arange(n_steps, dtype=torch.float32, device=t0.device)
        outs = []
        for i in range(n_steps):
            fields, species, out = step_body(fields, species, t0 + steps[i] * dt)
            outs.append(out)
        history = StepOutputs(*(torch.stack(leaf) for leaf in zip(*outs)))
        return fields, species, history

    return interval


def _start_fetch(history: Any) -> Tuple[Any, List[Any]]:
    """Issue the device->host copy of every history tensor without waiting:
    CUDA tensors go into fresh pinned buffers (``non_blocking``) and one
    event per card is recorded behind the copies; CPU tensors are cloned,
    so later in-place work on the state cannot reach a round's history."""
    cards = set()

    def copy(t: torch.Tensor) -> torch.Tensor:
        if t.device.type != "cuda":
            return t.detach().clone()
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        cards.add(t.device)
        return buf

    host = map_tensors(copy, history)
    events = []
    for dev in cards:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append(ev)
    return host, events


class IntervalPipeline:
    """Interval programs as re-enqueueable closures over a rotating state
    (counterpart of ``repro.pic.engine.IntervalPipeline``).

    The serialisation the async LB pipeline removes: after issuing round
    *k*, the host waits for its history, runs the balancer, commits the
    next mapping, and only then issues round *k+1*, so the device idles for
    the whole host turnaround.  The pipeline owns the state chain, so the
    caller can

      1. :meth:`enqueue` round *k+1* under the current mapping right away,
      2. :meth:`harvest` round *k*'s history while *k+1* executes,
      3. :meth:`correct` the tail state (the stale-mapping slot
         permutation): it lands between rounds *k+1* and *k+2*.

    There is no worker thread.  The reference dispatches from one because
    XLA:CPU runs multi-device programs synchronously at dispatch.  Here a
    program runs on the calling thread and issues its kernels, which CUDA
    executes asynchronously in stream order; that order alone puts a
    correction after the round in flight and before the next one, and a
    Python worker would only contend with the balancer for the GIL.  Each
    round's history is copied into pinned host buffers as soon as the round
    is issued, with an event recorded behind the copies: a harvest waits on
    that event only, never on the whole device, so the round issued after
    it stays in flight.  On CPU tensors everything runs inline at the call,
    and the semantics of ``depth`` still hold: histories come back in issue
    order under their issue-time ``meta``, and a correction reaches only
    the rounds enqueued after it.

    ``depth`` bounds the rounds in flight: 1 is the synchronous loop
    (harvest right after each enqueue), 2 the double-buffered one.

    Accounting: :attr:`host_blocked_s` is the host's time inside the
    pipeline's calls (issuing rounds, waiting on a round's event, converting
    its history); :attr:`overlapped_host_s` is the host's time between
    pipeline calls while a round was in flight, the host work the pipeline
    hides (0 under depth 1, the balancer turnaround under depth 2);
    :attr:`harvests` counts the histories fetched, one host sync each.
    """

    def __init__(self, state: Any, *, depth: int = 2):
        if depth < 1:
            raise ValueError("pipeline depth must be >= 1")
        self.depth = depth
        self._state = state
        self._inflight: Deque[Tuple[Any, List[Any], Any]] = deque()
        #: host seconds spent inside pipeline calls
        self.host_blocked_s = 0.0
        #: host seconds between pipeline calls with a round in flight
        self.overlapped_host_s = 0.0
        #: rounds harvested (each one device->host sync)
        self.harvests = 0
        self._resume_t: Optional[float] = None
        self._correct_err: Optional[BaseException] = None

    def _absorb_overlap(self) -> None:
        if self._resume_t is not None:
            self.overlapped_host_s += time.perf_counter() - self._resume_t
            self._resume_t = None

    def _mark_resume(self) -> None:
        self._resume_t = time.perf_counter() if self._inflight else None

    def _check_correction(self) -> None:
        """Re-raise a failed :meth:`correct` at the next pipeline call, as
        the reference does, before the caller acts on state the correction
        never produced."""
        if self._correct_err is not None:
            err, self._correct_err = self._correct_err, None
            raise RuntimeError("enqueued pipeline correction failed") from err

    @property
    def state(self) -> Any:
        """The tail of the state chain: what the next enqueue consumes.  No
        wait is needed, since any use of it on the device is stream-ordered
        after the rounds in flight."""
        self._check_correction()
        return self._state

    @property
    def pending(self) -> int:
        """Rounds enqueued but not yet harvested."""
        return len(self._inflight)

    @property
    def full(self) -> bool:
        """True when another enqueue would exceed ``depth`` rounds in
        flight (harvest first)."""
        return len(self._inflight) >= self.depth

    def enqueue(self, program: Callable, *args, meta: Any = None) -> None:
        """Run ``program(state, *args) -> (state', history)`` on the tail
        state (on CUDA this issues its kernels and returns), start the
        history's copy to the host, and queue it with ``meta`` for
        :meth:`harvest`."""
        if self.full:
            raise RuntimeError(f"pipeline full ({self.depth} rounds in flight); harvest first")
        self._check_correction()
        self._absorb_overlap()
        t0 = time.perf_counter()
        self._state, history = program(self._state, *args)
        host, events = _start_fetch(history)
        self.host_blocked_s += time.perf_counter() - t0
        self._inflight.append((host, events, meta))
        self._mark_resume()

    def correct(self, fn: Callable, *args) -> None:
        """Replace the tail state with ``fn(state, *args)``: after every
        round already issued, before anything enqueued later.  A failure
        leaves the state as it was and is raised at the next pipeline call."""
        try:
            self._state = fn(self._state, *args)
        except Exception as e:  # surfaced by _check_correction
            self._correct_err = e

    def harvest(self) -> Optional[Tuple[Any, Any]]:
        """Wait for the oldest round's history copy (on its event only) and
        return ``(numpy history, meta)``; ``None`` when nothing is in
        flight."""
        if not self._inflight:
            return None
        self._absorb_overlap()
        host, events, meta = self._inflight.popleft()
        t0 = time.perf_counter()
        for ev in events:
            ev.synchronize()
        out = map_tensors(lambda t: t.numpy(), host)
        self.host_blocked_s += time.perf_counter() - t0
        self._check_correction()
        self.harvests += 1
        self._mark_resume()
        return out, meta

    def drain(self) -> list:
        """Harvest every round in flight, in issue order; afterwards
        :attr:`state` is the committed tail (a checkpoint's consistent
        cut)."""
        out = []
        while self._inflight:
            out.append(self.harvest())
        return out

    def reset(self, state: Any) -> None:
        """Replace the state chain (the restore hook); refuses while rounds
        are in flight."""
        if self._inflight:
            raise RuntimeError(
                f"cannot reset with {len(self._inflight)} rounds in flight; drain first"
            )
        self._check_correction()
        self._state = state
        self._resume_t = None

    def close(self) -> None:
        """Drop the state chain and any in-flight histories (there is no
        worker to stop); the pipeline must not be used afterwards."""
        self._inflight.clear()
        self._state = None
        self._resume_t = None
