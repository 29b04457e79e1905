"""``step_mfu``: the least time the card could take for each traced step's
work, as the domain bounds it (``ctx.step_bounds_s``; PIC: both kernels
over every alive particle, the Yee update over every cell), over the
traced stretch's wall time, in percent of the card's peak."""


def read(ctx):
    if not ctx.trace.device:
        return None
    if not ctx.step_bounds_s or ctx.trace.window_s <= 0:
        return None
    return 100.0 * sum(ctx.step_bounds_s) / ctx.trace.window_s
