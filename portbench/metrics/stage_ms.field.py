"""``stage_ms.field``: device time per step of the ``pic.field`` spans, the field solve: Yee update, laser and sponge
(their device extents summed over the traced stretch)."""
from portbench.metrics._spans import device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx, "pic.field")
