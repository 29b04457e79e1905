"""``stage_ms.diag``: device time per step of the ``pic.diag`` spans, the step's outputs: field and kinetic energy, the history rows
(their device extents summed over the traced stretch)."""
from portbench.metrics._spans import device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx, "pic.diag")
