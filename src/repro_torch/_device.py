"""Device resolution for the port's entry points.

Every entry point puts its state on ``"cuda"`` unless the caller names
another device.  There is no silent fallback: asking for CUDA on a machine
without it raises, so a run never quietly measures the CPU.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterator, Optional, Union

import numpy as np
import torch

__all__ = [
    "DEFAULT_DEVICE",
    "CudaEventClock",
    "make_generator",
    "resolve_device",
    "sync_free_region",
    "to_device",
    "map_tensors",
]

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``device`` as a ``torch.device`` (default ``"cuda"``); raises if it
    names CUDA and no CUDA device is present."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch defaults to device='cuda' but no CUDA device is present; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


@contextlib.contextmanager
def sync_free_region(enabled: bool) -> Iterator[None]:
    """Inside, when ``enabled``: any host synchronisation with a CUDA device
    raises (``torch.cuda.set_sync_debug_mode("error")``).  The interval
    loops run under it when their ``strict_syncs`` is set."""
    if not enabled:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def make_generator(
    seed: Union[int, torch.Generator, None], device: Optional[Union[str, torch.device]] = None
) -> Optional[torch.Generator]:
    """``seed`` if it is already a generator (its device decides where the
    draws land), else a new generator on ``resolve_device(device)`` seeded
    with it; ``None`` for ``device="meta"`` (shapes only, nothing drawn)."""
    if device is not None and torch.device(device).type == "meta":
        return None
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=resolve_device(device)).manual_seed(int(seed))


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without a host synchronisation: on CUDA
    through a pinned copy and a non-blocking upload (a pageable upload
    waits for the stream), elsewhere as is."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def map_tensors(fn: Callable, tree: Any) -> Any:
    """``fn`` over the tensor leaves of nested dicts, lists, tuples and
    NamedTuples; other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return tree


class CudaEventClock:
    """Device timestamps for ``ActivityLedger``: each reading records a CUDA
    event on the current stream, waits for it, and returns its time in
    seconds since the origin event that :meth:`reset` recorded.  An event
    pair around a launch is the direct analogue of a CUPTI activity
    record's start and end; the wait is the host synchronisation the
    paper's CUPTI strategy pays for."""

    def __init__(self, device: torch.device):
        self.device = device
        self._origin: Optional[torch.cuda.Event] = None

    def reset(self) -> None:
        """Record the origin event (the start of a measurement round)."""
        self._origin = torch.cuda.Event(enable_timing=True)
        self._origin.record(torch.cuda.current_stream(self.device))

    def __call__(self) -> float:
        if self._origin is None:
            self.reset()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        ev.synchronize()
        return self._origin.elapsed_time(ev) / 1e3
