"""Spans at the layer boundaries of the PIC step and the DLB loop.

Tracing is on exactly while a ``torch.profiler`` session records
(``torch.autograd.profiler._is_profiler_enabled``), as the profiler's own
annotations are: the program has no switch of its own.  Off, :func:`span`
reads that one flag and returns a shared no-op context: no object, no
event.  On, a span

  * opens a ``torch.profiler.record_function`` of its name, so its host
    start and end sit on the profiler's clock beside the device trace;
  * records its name, its parent (the innermost span open around it), the
    step and the logical device, each given or taken from the parent;
  * on a CUDA device, records a timing event on that device's current
    stream at entry and at exit: the span's *device extent*, the stretch of
    the stream's timeline from the start of the first work issued inside
    it to the end of the last (:meth:`Span.device_ms`).  Recording an
    event does not wait, so a span adds no host synchronisation; the
    extents are read once the work is done.

:func:`step` opens the span of one PIC step (``pic.step``).  Its step
index is the next on the step cursor, which a span given ``step=`` sets:
the DLB loop's ``dlb.issue`` gives the first step of the interval it
issues, and the steps inside it count on from there.

The spans are kept in memory in the order they opened, at most
:data:`MAX_SPANS` (later ones still open their profiler annotation).
:func:`spans` returns them; the first span recorded after that starts the
buffer anew, so what a reader gets after a profiler session is that
session's spans.  The profiler is one per process, and so is the tracer;
spans are opened from one thread.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

__all__ = ["MAX_SPANS", "STEP", "Span", "span", "step", "spans"]

#: spans kept per session
MAX_SPANS = 1 << 16
#: the name of one PIC step's span
STEP = "pic.step"

_OFF = contextlib.nullcontext()


class _State:
    def __init__(self) -> None:
        self.buffer: List[Span] = []
        self.open: List[Span] = []
        self.read = False
        self.cursor: Optional[int] = None


_STATE = _State()


class Span:
    """One recorded span; the context that opens and closes it."""

    __slots__ = ("name", "parent", "step", "device", "_stream", "_events", "_annotation")

    def __init__(self, name: str, parent: Optional["Span"], step: Optional[int],
                 device: Optional[int], on: Optional[torch.device]):
        self.name = name
        #: the innermost span open around this one, or None
        self.parent = parent
        #: the PIC step, or None outside any step and interval
        self.step = step
        #: the logical device, or None where the span covers them all
        self.device = device
        self._stream = torch.cuda.current_stream(on) if on is not None and on.type == "cuda" else None
        self._events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None
        self._annotation = None

    def __enter__(self) -> "Span":
        self._annotation = _profiler.record_function(self.name)
        self._annotation.__enter__()
        if self._stream is not None:
            self._events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self._events[0].record(self._stream)
        _STATE.open.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        _STATE.open.pop()
        if self._events is not None:
            self._events[1].record(self._stream)
        self._annotation.__exit__(*exc)
        self._annotation = None
        return False

    def device_ms(self) -> Optional[float]:
        """The device extent in milliseconds, None for a span on no CUDA
        device.  Read after the work inside it is done (a synchronize)."""
        if self._events is None:
            return None
        return self._events[0].elapsed_time(self._events[1])


def span(name: str, on: Optional[torch.device] = None, *, step: Optional[int] = None,
         device: Optional[int] = None):
    """The span ``name`` as a context: ``on`` is the torch device whose
    stream times it (None: host only), ``step`` and ``device`` the PIC
    step (which also sets the step cursor) and the logical device, taken
    from the parent span where not given.  A no-op unless a profiler
    session records."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    if step is not None:
        _STATE.cursor = step
    return _open(name, on, step, device)


def step(on: Optional[torch.device] = None):
    """The span of one PIC step, numbered by the step cursor."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    s = _STATE
    k = s.cursor
    if k is not None:
        s.cursor = k + 1
    return _open(STEP, on, k, None)


def _open(name, on, step_, device):
    s = _STATE
    if s.read:
        s.buffer, s.read = [], False
    parent = s.open[-1] if s.open else None
    if step_ is None and parent is not None:
        step_ = parent.step
    if device is None and parent is not None:
        device = parent.device
    if len(s.buffer) >= MAX_SPANS:
        return _profiler.record_function(name)
    sp = Span(name, parent, step_, device, on)
    s.buffer.append(sp)
    return sp


def spans() -> List[Span]:
    """The spans of the latest profiler session, in the order they opened."""
    _STATE.read = True
    return list(_STATE.buffer)
