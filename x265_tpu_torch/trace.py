"""Spans of the encoder's layers, kept in memory while a caller has the
recorder on.

The recorder is off unless a caller turns it on with ``start()`` and off
with ``stop()`` (the benchmark, the CLI's ``--profile-dir``, tests).  Off,
a span costs one check of a module flag: ``span`` returns a shared inert
context and ``spanned`` calls straight through.  On, each span records its
name, its start and end on the host's monotonic clock
(``time.perf_counter_ns``), the index of the span that was open when it
began (its parent; -1 for none) and the display index of the frame it
works for: given by ``dispatch`` and ``finish``, inherited by the spans
they open, -1 for a span that serves a batch.  A span named ``sync`` marks
a point where the host waits for the device.

When the recorder starts inside an active ``torch.profiler`` session,
each span is also a profiler user annotation under the same name, so an
exported trace shows the layers.  Started outside one it adds none: an
annotation costs far more than a span, and a profiler of CUDA activity
alone keeps none.  With ``start(guard_syncs=True)`` the recorder also sets
``torch.cuda.set_sync_debug_mode("error")`` until ``stop()`` and lifts it
inside ``sync`` spans only: any other synchronisation of the device
raises.

Spans opened by several host threads keep one stack each.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time

import torch

_on = False
_guard = False
_annotate = False
# span index -> (name, start_ns, end_ns, parent, frame): tuples of numbers
# and strings, which the garbage collector stops tracking, so a long
# recording adds nothing to its full collections
_spans: dict = {}
_ids = itertools.count()
_local = threading.local()


class _Inert:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_INERT = _Inert()


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


class _Span:
    __slots__ = ("name", "parent", "frame", "stack", "i", "t0", "rf")

    def __init__(self, name: str, frame, default: int):
        self.stack = stack = _stack()
        self.parent = parent = stack[-1] if stack else -1
        if frame is None:
            p = _spans.get(parent)
            frame = p[4] if p is not None else -1
            if frame < 0:
                frame = default
        self.name, self.frame, self.rf = name, frame, None

    def __enter__(self):
        self.i = i = next(_ids)
        _spans[i] = (self.name, 0, 0, self.parent, self.frame)
        self.stack.append(i)
        if _annotate:
            self.rf = torch.ops.profiler._record_function_enter_new(
                self.name, None)
        if _guard and self.name == "sync":
            torch.cuda.set_sync_debug_mode(0)
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if _guard and self.name == "sync":
            torch.cuda.set_sync_debug_mode("error")
        if self.rf is not None:
            torch.ops.profiler._record_function_exit._RecordFunction(self.rf)
        _spans[self.i] = (self.name, self.t0, t1, self.parent, self.frame)
        if self.stack:      # empty where start() ran inside this span
            self.stack.pop()
        return False


def span(name: str, frame=None, default: int = -1):
    """A context recording one span.  ``frame``: the display index of the
    frame the span works for; None inherits the open span's, or takes
    ``default`` where that is -1 or no span is open."""
    if not _on:
        return _INERT
    return _Span(name, frame, default)


def sync():
    """A span around a point where the host waits for the device."""
    if not _on:
        return _INERT
    return _Span("sync", None, -1)


def spanned(name: str):
    """Decorator: every call of the function is one span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*a, **k):
            if not _on:
                return fn(*a, **k)
            with _Span(name, None, -1):
                return fn(*a, **k)
        return traced
    return wrap


def start(guard_syncs: bool = False) -> None:
    """Forget earlier spans and record from now on."""
    global _on, _guard, _annotate, _spans, _ids
    _spans, _ids = {}, itertools.count()
    _local.stack = []
    _annotate = torch.autograd._profiler_enabled()
    _guard = bool(guard_syncs)
    if _guard:
        torch.cuda.set_sync_debug_mode("error")
    _on = True


def stop() -> list:
    """Stop recording; returns the spans recorded since ``start()`` (and
    forgets them), each (name, start_ns, end_ns, parent index, frame), in
    the order they began."""
    global _on, _guard, _spans
    _on = False
    if _guard:
        torch.cuda.set_sync_debug_mode(0)
        _guard = False
    out, _spans = [_spans[i] for i in sorted(_spans)], {}
    return out


def self_ns(spans) -> dict:
    """Self time of every span name (ns): each span's duration less the
    durations of the spans it opened."""
    child = [0] * len(spans)
    for _n, t0, t1, parent, _f in spans:
        if parent >= 0:
            child[parent] += t1 - t0
    out: dict = {}
    for (name, t0, t1, _p, _f), c in zip(spans, child):
        out[name] = out.get(name, 0) + (t1 - t0 - c)
    return out
