"""The benchmark's arithmetic: percentiles, busy time as a union of
intervals, idle gaps labelled by the host's spans, and the device trace
of a window read from the profiler's events in memory."""

from __future__ import annotations

import bisect
import math


def percentile(values, q: float) -> float:
    """Nearest-rank percentile ``q`` (0-100) over every sample."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no samples")
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]


def union(intervals, lo: int, hi: int) -> list:
    """The union of [start, end) intervals clipped to [lo, hi), as sorted
    disjoint intervals."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy(intervals, lo: int, hi: int) -> int:
    """Length of the union of the intervals inside [lo, hi): overlapping
    work (two streams, a copy beside a kernel) counts once."""
    return sum(e - s for s, e in union(intervals, lo, hi))


def gaps(intervals, lo: int, hi: int) -> list:
    """The idle stretches of [lo, hi) between the busy intervals."""
    out, t = [], lo
    for s, e in union(intervals, lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def innermost_timeline(spans) -> tuple:
    """From nested spans [(name, start, end)] of one thread, the sorted
    change points and the innermost open span's name after each (None
    where no span is open)."""
    events = []
    for name, s, e in spans:
        events.append((s, 1, name))
        events.append((e, 0, name))
    events.sort(key=lambda x: (x[0], x[1]))
    stack, times, labels = [], [], []
    for t, kind, name in events:
        if kind:
            stack.append(name)
        elif name in stack:
            # the innermost open span of that name closes
            del stack[len(stack) - 1 - stack[::-1].index(name)]
        times.append(t)
        labels.append(stack[-1] if stack else None)
    return times, labels


def label_gaps(gap_list, spans, none_label="no span") -> dict:
    """Idle time by the innermost host span open at each gap's midpoint."""
    times, labels = innermost_timeline(spans)
    out = {}
    for s, e in gap_list:
        i = bisect.bisect_right(times, (s + e) / 2) - 1
        lab = labels[i] if i >= 0 and labels[i] is not None else none_label
        out[lab] = out.get(lab, 0) + (e - s)
    return out


def short_name(name: str) -> str:
    """A device operation's name without its return type, arguments and,
    for long template names, template arguments."""
    n = name[5:] if name.startswith("void ") else name
    n = n.split("(")[0].strip()
    return n if len(n) <= 64 else n.split("<")[0] + "<...>"


def top(d: dict, n: int = 10) -> list:
    return sorted(d.items(), key=lambda kv: -kv[1])[:n]


def device_events(prof) -> list:
    """[(name, start_ns, end_ns)] of every operation that ran on a CUDA
    device (kernels, copies, fills), read from the profiler's results in
    memory, on the profiler's wall clock (epoch nanoseconds)."""
    from torch.autograd import DeviceType
    res = prof.profiler.kineto_results
    out = []
    for ev in res.events():
        if ev.device_type() == DeviceType.CUDA:
            out.append((ev.name(), ev.start_ns(), ev.end_ns()))
    return out


def roofline_pct(bounds_ms, device_ns) -> float | None:
    """Share (%) of the kernel's launches' summed bound in their summed
    device time; None where the window saw no launch."""
    if not bounds_ms or device_ns <= 0:
        return None
    return 100.0 * sum(bounds_ms) * 1e6 / device_ns
