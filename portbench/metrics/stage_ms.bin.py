"""``stage_ms.bin``: device time per step of the ``pic.bin`` spans, binning each species by box: the sort, the bin offsets, the zero-filled (boxes, cap) arrays and their scatters
(their device extents summed over the traced stretch)."""
from portbench.metrics._spans import device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx, "pic.bin")
