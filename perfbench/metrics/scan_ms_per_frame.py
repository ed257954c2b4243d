"""scan_ms_per_frame: self time of the 'scan' spans per frame (ms)."""
from perfbench.metrics._layer import per_frame


def read(ctx):
    return per_frame(ctx, "scan")
