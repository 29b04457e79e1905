"""``stage_ms.deposit``: device time per step of the ``pic.deposit`` spans, the deposition kernel computing each lane's current from the pushed momenta, then the tiles' sum onto the grid (slot path: the positions back to the domain frame and the kill first)
(their device extents summed over the traced stretch)."""
from portbench.metrics._spans import device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx, "pic.deposit")
