"""Spans that the benchmark records around calls into the port's layers.

``install`` wraps the port's module seams (the same seams as the port's
``tools/profile_torch.py``) before the encoder builds its pipelines; every
wrapper records into one ``Tracer``.  Each span has a name (its layer), a
start and an end on the host's monotonic clock, and the span that was open
when it began, so a layer's self time excludes the layers it called.

The tracer has three modes:

* ``off``: the wrappers call straight through and record nothing;
* ``sync``: each span synchronises the device at its start and at its
  end, so a span's duration includes the device work its layer queued;
* ``mark``: spans are recorded without synchronising (to label what the
  host was doing while the device idled), and each launch of the kernels
  K1 and K2 is recorded for its bound (``yardstick``).

An untraced run installs nothing.
"""

from __future__ import annotations

import functools
import time

import torch

from . import yardstick

# span name -> (module, owner class or None, attribute) of the seams whose
# calls it covers; "builder" seams return the callables that do the work
METHODS = {
    "push": [("encoder.intra_encoder", "Encoder", "push_frame")],
    "dispatch": [("encoder.intra_encoder", "Encoder", "_dispatch_one")],
    "finish": [("encoder.intra_encoder", "Encoder", "_finish_one")],
    "lookahead": [("encoder.lookahead", "Lookahead", "push"),
                  ("encoder.lookahead", "Lookahead", "_analyze"),
                  ("encoder.lookahead", "Lookahead", "_propagate"),
                  ("encoder.intra_encoder", "Encoder", "_slicetype_decide")],
    "entropy": [("encoder.intra_encoder", "Encoder", "_entropy_encode"),
                ("encoder.intra_encoder", "Encoder", "_derive_inter_all")],
    "fetch": [("encoder.intra_encoder", "Encoder", "_fetch_outputs")],
    "qp_plan": [("encoder.intra_encoder", "Encoder", "_qp_plan")],
    "complexity": [("encoder.intra_encoder", "Encoder",
                    "_complexity_estimate")],
    "aq": [("encoder.aq", None, "aq_offsets")],
    "pad": [("encoder.intra_encoder", None, "pad_plane")],
    "weightp": [("encoder.weights", None, "analyse_luma_weight")],
}
BUILDERS = {
    "analysis": ("encoder.device_pipeline", "_analyse_builder"),
    "loopfilter": ("encoder.device_pipeline", "_filter_stage_builder"),
    "search": ("encoder.device_pipeline", "_inter_tools_builder"),
}
# the inter tools the search span covers (the motion search with K2, the
# MC and the uniformization)
SEARCH_TOOLS = ("me", "eval_mv", "eval_mv_ps", "chroma_pred",
                "chroma_pred_ps", "bi_avg")
PACKAGE = "x265_tpu_torch"


class Tracer:
    """Spans and kernel launches recorded in memory."""

    def __init__(self, synchronize=torch.cuda.synchronize):
        self.synchronize = synchronize
        self.mode = "off"
        self.spans = []     # [name, start_ns, end_ns, parent index]
        self.stack = []
        self.k1 = []        # yardstick.k1_launch_record per launch
        self.k2 = []

    def reset(self, mode: str) -> None:
        self.mode = mode
        self.spans, self.stack, self.k1, self.k2 = [], [], [], []

    def wrap(self, name: str, fn):
        @functools.wraps(fn)
        def traced(*a, **k):
            mode = self.mode
            if mode == "off":
                return fn(*a, **k)
            if mode == "sync":
                self.synchronize()
            rec = [name, time.perf_counter_ns(), 0,
                   self.stack[-1] if self.stack else -1]
            self.spans.append(rec)
            self.stack.append(len(self.spans) - 1)
            try:
                out = fn(*a, **k)
                if mode == "sync":
                    self.synchronize()
            finally:
                self.stack.pop()
                rec[2] = time.perf_counter_ns()
            return out
        return traced

    def self_ns(self) -> dict:
        """Self time of every span name, in nanoseconds: a span's duration
        less the durations of the spans it opened."""
        child = [0] * len(self.spans)
        for name, t0, t1, parent in self.spans:
            if parent >= 0:
                child[parent] += t1 - t0
        out = {}
        for (name, t0, t1, _p), c in zip(self.spans, child):
            out[name] = out.get(name, 0) + (t1 - t0 - c)
        return out


def install(tracer: Tracer):
    """Wrap the seams and the kernel launches; returns a function that
    puts the originals back."""
    import importlib
    undo = []

    def patch(owner, attr, new):
        undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    for name, seams in METHODS.items():
        for mod, cls, attr in seams:
            m = importlib.import_module(f"{PACKAGE}.{mod}")
            owner = getattr(m, cls) if cls else m
            patch(owner, attr, tracer.wrap(name, getattr(owner, attr)))

    dp = importlib.import_module(f"{PACKAGE}.encoder.device_pipeline")
    analyse, filters, tools = (getattr(dp, BUILDERS[n][1]) for n in
                               ("analysis", "loopfilter", "search"))

    def analyse_builder(*a):
        return tracer.wrap("analysis", analyse(*a))

    def filter_builder(enc):
        f = filters(enc)
        g = tracer.wrap("loopfilter", f)
        g.merged_masks = f.merged_masks
        return g

    def tools_builder(enc):
        t = dict(tools(enc))
        for k in SEARCH_TOOLS:
            if k in t:
                t[k] = tracer.wrap("search", t[k])
        return t

    patch(dp, BUILDERS["analysis"][1], analyse_builder)
    patch(dp, BUILDERS["loopfilter"][1], filter_builder)
    patch(dp, BUILDERS["search"][1], tools_builder)

    cs = importlib.import_module(f"{PACKAGE}.encoder.ctu_scan")
    scan_fn = cs.CtuScan.scan_fn
    patch(cs.CtuScan, "scan_fn", lambda self, *a, **k: tracer.wrap(
        "scan", scan_fn(self, *a, **k)))

    k1 = importlib.import_module(f"{PACKAGE}.encoder.ctu_scan_cuda")
    k1_launch = k1.launch

    def k1_traced(lib, scan, inter, decide32, carry, xs):
        carry, ys = k1_launch(lib, scan, inter, decide32, carry, xs)
        if tracer.mode == "mark":
            tracer.k1.append(yardstick.k1_launch_record(xs, ys, inter, scan))
        return carry, ys
    patch(k1, "launch", k1_traced)

    k2 = importlib.import_module(f"{PACKAGE}.encoder.me_cuda")
    k2_launch = k2.launch

    def k2_traced(lib, W, ob, mvi, pmv, lam, subme, mrq, bit_depth=8):
        outs = k2_launch(lib, W, ob, mvi, pmv, lam, subme, mrq, bit_depth)
        if tracer.mode == "mark":
            tracer.k2.append(yardstick.k2_launch_record(
                W, ob, mvi, pmv, lam, outs, subme, mrq, bit_depth))
        return outs
    patch(k2, "launch", k2_traced)

    def restore():
        for owner, attr, orig in reversed(undo):
            setattr(owner, attr, orig)
    return restore
