"""``device_idle_share``: percent of the traced window in which the merged
timeline of device work is empty."""
from portbench.trace import busy_s


def read(ctx):
    if not ctx.trace.device:
        return None
    window = ctx.trace.window_s
    return 100.0 * (1.0 - busy_s(ctx.trace) / window) if window > 0 else None
