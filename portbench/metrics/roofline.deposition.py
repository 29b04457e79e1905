"""``roofline.deposition``: the current-deposition kernel's share of its
roofline over the traced stretch."""
from portbench import yardstick
from portbench.metrics._kernels import roofline


def read(ctx):
    return roofline(ctx, "deposition_kernel", yardstick.deposition_work)
