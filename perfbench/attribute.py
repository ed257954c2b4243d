"""The device trace read against the program's own spans.

The program (``x265_tpu_torch.trace``) records spans with their parents:
(name, start, end, parent index, frame), in the order they began, from one
host thread.  Each device operation of the profiled part (a kernel, copy
or fill) goes to the innermost span that was open when the host launched
it: the profiler's runtime event of the launch (``cudaLaunchKernel``,
``cudaMemcpyAsync``, ...) carries the correlation id of the operation it
queued, and its start is the launch's time.  An operation whose launch is
missing, or was made under no span, is unattributed.  Attributed and
unattributed device time add up to the summed device time of every
operation, each counted once.

Two clocks meet here: the spans' (the host's monotonic clock) and the
profiler's.  ``align`` puts the spans on the profiler's clock: by the
profiler's own user annotations of the spans where the trace holds them
(one per span, the same names in the same order), else by one offset
measured from a marker launch bracketed by two reads of the spans' clock.

``readings`` puts it together for a traced run's profiled part: the
spans' counts and self times, and on the card the device trace against
them, every reading per AU returned there (the ``finish`` spans that no
other ``finish`` encloses).
"""

from __future__ import annotations

import bisect
import time
from types import SimpleNamespace

from . import measure


def self_ns(spans) -> dict:
    """Self time (ns) of every span name: each span's duration less the
    durations of the spans it opened."""
    child = [0] * len(spans)
    for s in spans:
        if s[3] >= 0:
            child[s[3]] += s[2] - s[1]
    out: dict = {}
    for s, c in zip(spans, child):
        out[s[0]] = out.get(s[0], 0) + (s[2] - s[1] - c)
    return out


def innermost(spans) -> tuple:
    """The sorted change points of nested spans and the index of the
    innermost open span after each (-1 where none is open)."""
    events = []
    for i, s in enumerate(spans):
        events.append((s[1], 1, i))
        events.append((s[2], 0, i))
    # at one instant a span ends before the next one starts
    events.sort(key=lambda e: (e[0], e[1], e[2] if e[1] else -e[2]))
    stack, times, owner = [], [], []
    for t, start, i in events:
        if start:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        times.append(t)
        owner.append(stack[-1] if stack else -1)
    return times, owner


def owners(ops, launch_ns: dict, spans) -> list:
    """For each device operation (name, start, end, correlation id), the
    index of the innermost span open at its launch, or -1."""
    times, owner = innermost(spans)
    out = []
    for op in ops:
        t = launch_ns.get(op[3])
        k = bisect.bisect_right(times, t) - 1 if t is not None else -1
        out.append(owner[k] if k >= 0 else -1)
    return out


def totals(ops, own, spans) -> dict:
    """Device time (ns) and operations by the innermost span's name
    (``by_span``), by every span name the launch was under, the innermost
    and its ancestors, each name once (``under``), and unattributed."""
    per = {}
    lost = [0, 0]
    for op, i in zip(ops, own):
        d = op[2] - op[1]
        acc = per.setdefault(i, [0, 0]) if i >= 0 else lost
        acc[0] += d
        acc[1] += 1
    by_span, under = {}, {}
    for i, (ns, n) in per.items():
        for table, names in ((by_span, (spans[i][0],)),
                             (under, _lineage(spans, i))):
            for name in names:
                acc = table.setdefault(name, [0, 0])
                acc[0] += ns
                acc[1] += n
    return dict(by_span=by_span, under=under, unattributed=lost,
                total=[sum(op[2] - op[1] for op in ops), len(ops)])


def _lineage(spans, i) -> set:
    names = set()
    while i >= 0:
        names.add(spans[i][0])
        i = spans[i][3]
    return names


def align(spans, annotations, marker=None) -> tuple:
    """The spans on the profiler's clock, and how they got there.

    ``annotations``: the profiler's user annotations (name, start, end)
    in the order they began.  Where they are the spans one for one, the
    spans take their times ("annotations").  Else ``marker`` (pc0, pc1,
    start, end): a launch made between two reads pc0 <= pc1 of the spans'
    clock, whose runtime event ran from start to end on the profiler's:
    the offset lies in [end - pc1, start - pc0], and the spans move by its
    middle ("marker", with the interval's half width in ns).  None where
    neither holds."""
    if annotations and len(annotations) == len(spans) and all(
            a[0] == s[0] for a, s in zip(annotations, spans)):
        return ([(s[0], a[1], a[2]) + tuple(s[3:])
                 for s, a in zip(spans, annotations)], "annotations", 0)
    if marker is not None:
        pc0, pc1, start, end = marker
        lo, hi = end - pc1, start - pc0
        if lo <= hi:
            off = (lo + hi) // 2
            return ([(s[0], s[1] + off, s[2] + off) + tuple(s[3:])
                     for s in spans], "marker", (hi - lo) // 2)
    return None, None, None


def top_level(spans, name: str) -> int:
    """Spans named ``name`` that no span of that name encloses."""
    return sum(1 for s in spans if s[0] == name
               and (s[3] < 0 or spans[s[3]][0] != name))


def marker_launch() -> tuple:
    """A launch bracketed by two reads of the spans' clock, made after the
    device has drained (and after one launch of the same kernel, so that
    the bracket holds no first-launch work): (pc0, pc1)."""
    import torch
    torch.cuda._sleep(1)
    torch.cuda.synchronize()
    pc0 = time.perf_counter_ns()
    torch.cuda._sleep(1)
    pc1 = time.perf_counter_ns()
    return pc0, pc1


def _events(prof, names) -> tuple:
    """The device operations (name, start, end, correlation id), the host
    launch time of each correlation id, the runtime event of the last
    launch, and the user annotations named as spans, from the profiler's
    events in memory."""
    from torch.autograd import DeviceType
    ops, launch, notes, last = [], {}, [], None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            ops.append((name, ev.start_ns(), ev.end_ns(),
                        ev.correlation_id()))
        elif name.startswith("cu"):
            launch[ev.correlation_id()] = ev.start_ns()
            if name.startswith("cudaLaunchKernel") and (
                    last is None or ev.start_ns() > last[1]):
                last = (ev.correlation_id(), ev.start_ns(), ev.end_ns())
        elif name in names:
            notes.append((name, ev.start_ns(), ev.end_ns()))
    notes.sort(key=lambda a: (a[1], -a[2]))
    return ops, launch, notes, last


def readings(spans, prof, phase_b, t_close, marker):
    """The program's spans of the profiled part, and on the card the
    device trace against them."""
    frames = top_level(spans, "finish")
    own = self_ns(spans)
    n_of = {}
    for s in spans:
        n_of[s[0]] = n_of.get(s[0], 0) + 1
    sync_ns = sum(s[2] - s[1] for s in spans if s[0] == "sync")
    r = SimpleNamespace(frames=frames, levels=n_of.get("scan.level", 0),
                        level_self_ns=own.get("scan.level", 0),
                        syncs=n_of.get("sync", 0), sync_ns=sync_ns,
                        under=None)
    per = max(1, frames)
    info = dict(frames=frames, spans=len(spans),
                self_ms_per_frame={k: v / 1e6 / per
                                   for k, v in sorted(own.items())},
                spans_per_frame={k: v / per for k, v in sorted(n_of.items())},
                syncs_per_frame=r.syncs / per,
                sync_ms_per_frame=sync_ns / 1e6 / per)
    r.info = info
    if prof is None or not frames:
        return r
    ops, launch, notes, last = _events(prof, set(n_of))
    if last is not None:
        # the marker is the last launch; it is not the program's
        ops = [op for op in ops if op[3] != last[0]]
    aligned, route, half = align(
        spans, notes, None if last is None else marker + last[1:])
    info["clock"] = dict(route=route, half_width_ns=half,
                         annotations=len(notes))
    if aligned is None:
        return r
    owner = owners(ops, launch, aligned)
    tot = totals(ops, owner, aligned)
    r.under = tot["under"]

    def kernel(part, span):
        idx = [i for i, op in enumerate(ops) if part in op[0]]
        at = sum(1 for i in idx
                 if owner[i] >= 0 and aligned[owner[i]][0] == span)
        return dict(ops=len(idx), under_span=at)

    lo = int(phase_b["t0"] * 1e9) + phase_b["epoch"]
    hi = int(t_close * 1e9) + phase_b["epoch"]
    idle = measure.label_gaps(
        measure.gaps([(op[1], op[2]) for op in ops], lo, hi),
        [s[:3] for s in aligned])
    info.update(
        device_ms=dict(total=tot["total"][0] / 1e6,
                       attributed=(tot["total"][0]
                                   - tot["unattributed"][0]) / 1e6,
                       unattributed=tot["unattributed"][0] / 1e6),
        ops=dict(total=tot["total"][1], unattributed=tot["unattributed"][1]),
        device_ms_per_frame={k: v[0] / 1e6 / per
                             for k, v in sorted(tot["by_span"].items())},
        launches_per_frame={k: v[1] / per
                            for k, v in sorted(tot["by_span"].items())},
        under_device_ms_per_frame={k: v[0] / 1e6 / per
                                   for k, v in sorted(tot["under"].items())},
        under_launches_per_frame={k: v[1] / per
                                  for k, v in sorted(tot["under"].items())},
        idle_ms_per_frame={k: v / 1e6 / per for k, v in sorted(idle.items())},
        k1=kernel("k1_kernel", "scan.level"),
        k2=kernel("k2_kernel", "search.k2"))
    return r
