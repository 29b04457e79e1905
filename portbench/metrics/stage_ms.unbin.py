"""``stage_ms.unbin``: device time per step of the ``pic.unbin`` spans, the new state written back: the gathers and wheres back to particle order
(their device extents summed over the traced stretch)."""
from portbench.metrics._spans import device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx, "pic.unbin")
