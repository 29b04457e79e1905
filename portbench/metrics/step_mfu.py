"""``step_mfu``: the whole step's physics bound (both kernels over every
alive particle, the Yee update over every cell) over the traced stretch's
wall time per step, in percent of the card's peak."""
from portbench import yardstick


def read(ctx):
    if not ctx.trace.device:
        return None
    if not ctx.alive_per_step or ctx.trace.window_s <= 0:
        return None
    bound = sum(yardstick.step_bound_s(a, ctx.cells) for a in ctx.alive_per_step)
    return 100.0 * bound / ctx.trace.window_s
