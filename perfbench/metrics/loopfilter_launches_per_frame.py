"""loopfilter_launches_per_frame: device operations (kernels, copies, fills)
launched under the program's ``loopfilter`` spans (the spans they open
included) per AU of the profiled part of a traced window."""
from perfbench.metrics import _program


def read(ctx):
    return _program.under_per_frame(ctx, "loopfilter", 1)
