"""scan_device_ms_per_frame: device time of the operations launched
under the program's ``scan`` spans (the spans they open included) per AU of
the profiled part of a traced window (ms)."""
from perfbench.metrics import _program

_program.install()


def read(ctx):
    ns = _program.under_per_frame(ctx, "scan", 0)
    return None if ns is None else ns / 1e6
