"""``stage_ms.push``: device time per step of the ``pic.push`` spans, the field tiles and the fused gather + push + move kernel
(their device extents summed over the traced stretch)."""
from portbench.metrics._spans import device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx, "pic.push")
