"""Device resolution for the port's entry points.

Every entry point puts its state on ``"cuda"`` unless the caller names
another device.  There is no silent fallback: asking for CUDA on a machine
without it raises, so a run never quietly measures the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

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
