"""k1_roofline: K1's summed bound over its device time (%)."""
from perfbench.metrics._layer import roofline


def read(ctx):
    return roofline(ctx, "k1_kernel", ctx.k1_bounds_ms)
