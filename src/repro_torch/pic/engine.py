"""Device-resident multi-step PIC execution engine.

Counterpart of ``repro.pic.engine``.  The paper's point is that in-situ cost
assessment must be cheap relative to the physics: the balancer consumes
costs once per LB interval, so nothing in the hot loop touches the host
more often than that.

  * :func:`particle_phase` / :func:`field_phase` — the two halves of one
    step on the global grid (gather + push + move + deposit; Maxwell
    leapfrog + laser + sponge).
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
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

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

__all__ = [
    "ENGINE_BACKENDS",
    "StepOutputs",
    "particle_phase",
    "field_phase",
    "build_step_body",
    "make_interval_fn",
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
):
    """Gather + Boris push + move + current deposit for all species on the
    global grid.  Returns ``(species', (jx, jy, jz), counts)`` with
    ``counts`` the alive particles per box after the move."""
    dev = fields.ex.device
    jx = torch.zeros(grid.shape, dtype=torch.float32, device=dev)
    jy = torch.zeros(grid.shape, dtype=torch.float32, device=dev)
    jz = torch.zeros(grid.shape, dtype=torch.float32, device=dev)
    counts = torch.zeros(grid.n_boxes, dtype=torch.float32, device=dev)
    out_species = []
    for p in species:
        eb = gather_fields(fields, p.z, p.x, grid, shape_order)
        p = advance_positions(boris_push(p, eb, grid.dt), grid, grid.dt)
        out_species.append(p)
        jx_, jy_, jz_ = deposit_current(p, grid, shape_order)
        jx, jy, jz = jx + jx_, jy + jy_, jz + jz_
        counts = counts + box_particle_counts(p, grid)
    return tuple(out_species), (jx, jy, jz), counts


def field_phase(
    fields: Fields,
    j,
    grid: Grid2D,
    *,
    sponge: Optional[torch.Tensor] = None,
    laser=None,
    t=None,
) -> Fields:
    """Maxwell leapfrog (B half, E full, B half) + laser injection + sponge."""
    fields = step_b_half(fields, grid)
    fields = step_e(fields, j, grid)
    fields = step_b_half(fields, grid)
    if laser is not None:
        fields = laser.inject(fields, grid, t)
    if sponge is not None:
        fields = apply_sponge(fields, sponge)
    return fields


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
