"""``glue_device_ms``: device time per step of every operation other than
the two PIC kernels (binning, tiles, scatters, the field solve, copies)."""

KERNELS = ("gather_push_kernel", "deposition_kernel")


def read(ctx):
    if not ctx.trace.device:
        return None
    lo, hi = ctx.trace.window
    glue = sum(
        min(e, hi) - max(s, lo)
        for name, s, e in ctx.trace.device
        if e > lo and s < hi and not any(k in name for k in KERNELS)
    )
    return 1e3 * glue / ctx.trace.steps if ctx.trace.steps else None
