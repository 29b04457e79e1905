"""Faults planted in the program's timed path, one at a time, for the test
that sees ``correct`` come out false."""
import contextlib

import torch

from portbench.reference.compare import LANE_OPS, TILE


@contextlib.contextmanager
def patched(owner, name, make):
    """``owner.name`` replaced by ``make(original)`` inside."""
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def stale_state():
    """Every interval hands back the state it was given (histories as
    computed)."""
    from repro_torch.dist.sharded_runtime import ShardedRuntime
    from repro_torch.pic import stepper

    def make_fn(orig):
        def make_interval_fn(step_body, grid):
            real = orig(step_body, grid)

            def interval(fields, species, t0, n_steps):
                return (fields, species) + real(fields, species, t0, n_steps)[2:]

            return interval

        return make_interval_fn

    def make_sharded(orig):
        def _interval(self, state, n_steps, t_start):
            return state, orig(self, state, n_steps, t_start)[1]

        return _interval

    stack = contextlib.ExitStack()
    stack.enter_context(patched(stepper, "make_interval_fn", make_fn))
    stack.enter_context(patched(ShardedRuntime, "_interval", make_sharded))
    return stack


def half_batch():
    """Half of every species is left out of each step's push and deposit,
    the current of the rest doubled to stand for the whole."""
    from repro_torch.dist import sharded_runtime
    from repro_torch.kernels import ops

    def make_binned(orig):
        def pic_substep_body(f, p, **kw):
            keep = torch.arange(p.n, device=p.z.device) % 2 == 0
            new_p, j, counters, counts, nd = orig(f, p._replace(alive=p.alive & keep), **kw)
            new_p = new_p._replace(alive=new_p.alive | (p.alive & ~keep))
            return new_p, tuple(2 * c for c in j), counters, counts, nd

        return pic_substep_body

    def make_slots(orig):
        def particle_phase_slots(tiles6, species, origins, local_grid, **kw):
            halves = []
            for p in species:
                lane = torch.arange(p.alive.shape[1], device=p.alive.device)[None, :]
                n = p.alive.sum(1, keepdim=True)
                halves.append(p._replace(alive=p.alive & (lane < (n + 1) // 2)))
            out, j3, counts, work = orig(tiles6, tuple(halves), origins, local_grid, **kw)
            out = tuple(
                q._replace(alive=q.alive | (p.alive & ~h.alive)) for p, h, q in zip(species, halves, out)
            )
            return out, 2 * j3, counts, work

        return particle_phase_slots

    stack = contextlib.ExitStack()
    stack.enter_context(patched(ops, "pic_substep_body", make_binned))
    stack.enter_context(patched(sharded_runtime, "particle_phase_slots", make_slots))
    return stack


def no_exchange():
    """The sharded runtime's guard-strip exchange between logical devices
    left out: no halo pasted, no deposit folded across boxes."""
    from repro_torch.dist import sharded_runtime

    def make(orig):
        def neighbor_reduce(init, payloads, fold):
            return init

        return neighbor_reduce

    return patched(sharded_runtime, "neighbor_reduce", make)


def altered_answer():
    """One answer altered where it is made: a chunk more work counted in box
    0 (binned path), slot 0's new fields doubled (slot path)."""
    from repro_torch.dist import sharded_runtime
    from repro_torch.kernels import ops

    def make_binned(orig):
        def pic_substep_body(f, p, **kw):
            new_p, j, counters, counts, nd = orig(f, p, **kw)
            counters = counters.clone()
            counters[0] += TILE * LANE_OPS
            return new_p, j, counters, counts, nd

        return pic_substep_body

    def make_fields(orig):
        def field_phase_stacked(*args, **kw):
            out = orig(*args, **kw).clone()
            out[0] *= 2.0
            return out

        return field_phase_stacked

    stack = contextlib.ExitStack()
    stack.enter_context(patched(ops, "pic_substep_body", make_binned))
    stack.enter_context(patched(sharded_runtime, "field_phase_stacked", make_fields))
    return stack
