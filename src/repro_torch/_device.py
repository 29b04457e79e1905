"""Device resolution for the port's entry points.

Every entry point puts its state on ``"cuda"`` unless the caller names
another device.  There is no silent fallback: asking for CUDA on a machine
without it raises, so a run never quietly measures the CPU.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device", "sync_free_region"]

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
