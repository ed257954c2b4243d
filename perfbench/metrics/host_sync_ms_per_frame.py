"""host_sync_ms_per_frame: the host's time inside the program's ``sync``
spans (waiting for the device, and the copy) per AU of the profiled part
of a traced window (ms)."""
from perfbench.metrics import _program

_program.install()


def read(ctx):
    p = _program.program(ctx)
    if p is None or not p.frames:
        return None
    return p.sync_ns / 1e6 / p.frames
