"""``launches_per_step``: the CUDA calls (``cuda*`` and ``cu*``) that put
work on the device (kernel launches, copies and sets) the host made inside
the program's ``pic.step`` spans, per step of the traced stretch."""
from bisect import bisect_left, bisect_right

from portbench.metrics._spans import STEP

#: name prefixes of the calls that enqueue device work
CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")


def read(ctx):
    steps = [(s, e) for name, s, e in ctx.trace.host if name == STEP]
    calls = sorted(s for name, s, _ in ctx.trace.host if name.startswith(CALLS))
    if not steps or not calls or not ctx.trace.steps:
        return None
    inside = sum(bisect_right(calls, e) - bisect_left(calls, s) for s, e in steps)
    return inside / ctx.trace.steps
