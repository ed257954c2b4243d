"""host_syncs_per_frame: points where the host waited for the device (the
program's ``sync`` spans: fetches, recon and hash copies, blocking
uploads) per AU of the profiled part of a traced window."""
from perfbench.metrics import _program


def read(ctx):
    p = _program.program(ctx)
    if p is None or not p.frames:
        return None
    return p.syncs / p.frames
