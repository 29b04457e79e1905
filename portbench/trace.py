"""The traced stretch: ``torch.profiler`` over one stretch, reduced to a
plain record that the per-layer readers take.

A :class:`Trace` holds the device's operations (kernels, copies, sets) and
the host's operations as ``(name, start_s, end_s)`` on the profiler's one
clock, the traced window and the steps in it.  Busy time is the length of
the union of the device's operations: where the four logical devices'
kernels overlap on the one card, a second of overlap counts once.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, List, NamedTuple, Tuple

__all__ = ["Trace", "capture", "busy_intervals", "busy_s", "breakdown"]

Span = Tuple[str, float, float]

#: CUPTI's marker for a full launch queue, a record and not device work
_NOT_WORK = ("Command Buffer Full",)
#: the harness's own spans: around the traced stretch, each re-make, each interval
SPAN_PREFIX = "portbench:"
WINDOW_SPAN = SPAN_PREFIX + "window"
#: operation names are cut to this many characters
NAME_CHARS = 200
#: idle gaps shorter than this are summed together, not attributed
SHORT_GAP_S = 20e-6


class Trace(NamedTuple):
    device: List[Span]
    host: List[Span]
    window: Tuple[float, float]
    steps: int

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def capture(fn: Callable[[], int], on_card: bool = True) -> Trace:
    """Run ``fn`` (which returns the steps it ran, ending idle) under the
    profiler and reduce what it recorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        with record_function(WINDOW_SPAN):
            steps = fn()
        if on_card:
            torch.cuda.synchronize()
    device, host, window = [], [], None
    for e in prof.events():
        span = (e.name[:NAME_CHARS], e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        if e.device_type == DeviceType.CUDA:
            # a record_function span has a copy on the device's timeline: not work
            annotation = getattr(e, "is_user_annotation", False) or e.name.startswith(SPAN_PREFIX)
            if not annotation and e.name not in _NOT_WORK and span[2] > span[1]:
                device.append(span)
        elif e.name == WINDOW_SPAN:
            window = span[1:]
        else:
            host.append(span)
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    return Trace(device=device, host=host, window=window, steps=int(steps))


def busy_intervals(trace: Trace) -> List[Tuple[float, float]]:
    """The merged timeline of device work inside the window."""
    lo, hi = trace.window
    spans = sorted((max(s, lo), min(e, hi)) for _, s, e in trace.device if e > lo and s < hi)
    merged: List[Tuple[float, float]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def busy_s(trace: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(trace))


def _innermost(starts: List[float], host: List[Span], long: List[Span], t: float,
               reach: int = 5000) -> str:
    """The host operation covering time ``t`` that started last (the
    innermost, host spans being nested): among the ``reach`` operations
    that started last before ``t``, else among the ``long`` ones; ``host``
    and ``long`` sorted by start."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - reach), -1):
        if host[j][2] >= t:
            return host[j][0]
    covering = [sp for sp in long if sp[1] <= t <= sp[2]]
    return covering[-1][0] if covering else "(no host op)"


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time of the
    device summed by what the host was doing in each gap (the innermost host
    operation at the gap's midpoint; gaps under ``SHORT_GAP_S`` summed as
    one entry)."""
    ops = defaultdict(float)
    for name, s, e in trace.device:
        ops[name] += e - s
    gaps = defaultdict(float)
    host = sorted(trace.host, key=lambda sp: sp[1])
    starts = [sp[1] for sp in host]
    long = [sp for sp in host if sp[2] - sp[1] >= 1e-3]
    lo, hi = trace.window
    edges = [lo] + [t for iv in busy_intervals(trace) for t in iv] + [hi]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e - s >= SHORT_GAP_S:
            gaps[_innermost(starts, host, long, 0.5 * (s + e))] += e - s
        elif e > s:
            gaps[f"(gaps under {SHORT_GAP_S * 1e6:.0f} us)"] += e - s

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(ops), "idle_gaps": ranked(gaps)}
