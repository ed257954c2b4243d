"""k1_host_us_per_launch: the host's cost of one wavefront level of the
CTU scan (us): the self time of the program's ``scan.level`` spans (the
level's slice, K1's argument checks and launch, the count) over their
number, in the profiled part of a traced window."""
from perfbench.metrics import _program

_program.install()


def read(ctx):
    p = _program.program(ctx)
    if p is None or not p.levels:
        return None
    return p.level_self_ns / p.levels / 1e3
