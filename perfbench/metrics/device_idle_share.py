"""device_idle_share: share of the profiled window in which no operation
ran on the device (%), from the union of its operations' intervals."""


def read(ctx):
    if ctx.window_ns <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_ns / ctx.window_ns)
