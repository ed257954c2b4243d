"""Shared arithmetic of the per-layer metrics' readers."""


def per_frame(ctx, span: str):
    """Self time (ms) of the spans named ``span`` in the synchronised part
    of a traced window, per AU returned there; None where no such span
    ran."""
    ms = ctx.self_ms.get(span)
    if ms is None or not ctx.frames_a:
        return None
    return ms / ctx.frames_a


def roofline(ctx, kernel: str, bounds_ms):
    """Share (%) of the summed bound of the window's launches of
    ``kernel`` in the device time of its kernels (by name) in the
    profiled window; None where it did not run."""
    from perfbench.measure import roofline_pct
    dev_ns = sum(v for k, v in ctx.kernel_ns.items() if kernel in k)
    return roofline_pct(bounds_ms, dev_ns)
