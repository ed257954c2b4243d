"""frame_latency_ms_p90: the 90th percentile, over every frame pushed and
returned in the profiled part of the window, of the time from the start
of the frame's push to the return of its AU (ms)."""
from perfbench.measure import percentile


def read(ctx):
    if not ctx.latencies_ms:
        return None
    return percentile(ctx.latencies_ms, 90)
