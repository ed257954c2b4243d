"""search_launches_per_frame: device operations (kernels, copies, fills)
launched under the program's ``search`` spans (the spans they open
included) per AU of the profiled part of a traced window."""
from perfbench.metrics import _program

_program.install()


def read(ctx):
    return _program.under_per_frame(ctx, "search", 1)
