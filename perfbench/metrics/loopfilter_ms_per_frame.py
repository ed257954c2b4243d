"""loopfilter_ms_per_frame: self time of the 'loopfilter' spans per frame (ms)."""
from perfbench.metrics._layer import per_frame


def read(ctx):
    return per_frame(ctx, "loopfilter")
