"""k2_roofline: K2's summed bound over its device time (%)."""
from perfbench.metrics._layer import roofline


def read(ctx):
    return roofline(ctx, "k2_kernel", ctx.k2_bounds_ms)
