"""``roofline.gather_push``: the fused gather + Boris push + move kernel's
share of its roofline over the traced stretch."""
from portbench import yardstick
from portbench.metrics._kernels import roofline


def read(ctx):
    return roofline(ctx, "gather_push_kernel", yardstick.gather_push_work)
