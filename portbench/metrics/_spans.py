"""Shared by the readers of the program's spans (``program_span``).

The program opens its spans at the layer boundaries of the PIC step and the
DLB loop while a profiler session records (``repro_torch._trace``).  Each
is also a host event of the profiler under the same name, so host
durations are read from ``ctx.trace.host``; device extents (the stretch of
the stream's timeline a span covers, from its two timing events) come from
the program's span buffer, which holds the traced stretch's spans once the
session has ended.  A program without the spans gives nothing to read."""
from __future__ import annotations

from typing import List, Optional

#: one PIC step's span
STEP = "pic.step"


def program_spans() -> List:
    """The spans of the program's latest profiler session; none where the
    program has no tracer."""
    try:
        from repro_torch import _trace
    except ImportError:
        return []
    return _trace.spans()


def device_ms_per_step(ctx, name: str) -> Optional[float]:
    """The device extents of the spans ``name``, summed over the traced
    stretch, per step; nothing where no such span was timed on a device."""
    extents = [s.device_ms() for s in program_spans() if s.name == name]
    extents = [e for e in extents if e is not None]
    if not extents or not ctx.trace.steps:
        return None
    return sum(extents) / ctx.trace.steps


def host_ms_per_span(ctx, name: str) -> Optional[float]:
    """The mean host duration of the spans ``name`` over the traced
    stretch, in milliseconds; nothing where there is none."""
    durations = [e - s for n, s, e in ctx.trace.host if n == name]
    return 1e3 * sum(durations) / len(durations) if durations else None
