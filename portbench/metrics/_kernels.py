"""Shared by the kernel readers: a kernel's share of its roofline over the
traced stretch."""
from __future__ import annotations

from typing import Callable, Optional

from portbench import yardstick


def roofline(ctx, kernel: str, work: Callable) -> Optional[float]:
    """Percent: the least time the card could take for every launch's work
    (bytes and operations summed over the launches the stretch made),
    over the device time of the kernels whose name holds ``kernel``.
    Nothing when no such kernel ran."""
    device_s = sum(e - s for name, s, e in ctx.trace.device if kernel in name)
    if device_s <= 0.0:
        return None
    n_bytes = n_flops = 0.0
    for counts in ctx.launches:
        b, f = work(counts, ctx.tile_cells)
        n_bytes += b
        n_flops += f
    return 100.0 * yardstick.bound_s(n_bytes, n_flops) / device_s
