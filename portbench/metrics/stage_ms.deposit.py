"""``stage_ms.deposit``: device time per step of the ``pic.deposit`` spans, the deposition's inputs (gamma, live lanes, coefficients, the three products), the kernel and the tiles' sum onto the grid
(their device extents summed over the traced stretch)."""
from portbench.metrics._spans import device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx, "pic.deposit")
