"""The program's own spans (``x265_tpu_torch.trace``) in a traced run, for
the readers of the metrics that read them.

The harness knows nothing of these spans.  Each of their readers calls
``install`` when the harness loads it, before a traced run starts, and
``install`` hooks, once a process, the two points where the profiled part
of the window opens and closes:

* ``spans.Tracer.reset``: when the harness's tracer enters its profiled
  mode ("mark"), the program's recorder starts;
* ``harness._read_trace``: the recorder stops and, on the card, a marker
  launch is made while the profiler still runs; after the harness's own
  readings, the program's spans are read against the device trace
  (``perfbench.attribute``), printed as the ``program_spans`` info line
  and handed to the readers as ``ctx.program``.

The harness's own readings are left as they were.  Against a program
without the recorder nothing is hooked, and every such reader returns
None.  Every reading is per AU returned in the profiled part: the spans
``finish`` that no other ``finish`` encloses.
"""

from __future__ import annotations

import json
import time
from types import SimpleNamespace

from perfbench import attribute, measure

_installed = False


def install() -> None:
    global _installed
    if _installed:
        return
    _installed = True
    try:
        from x265_tpu_torch import trace
    except ImportError:
        return
    from perfbench import harness, spans
    reset, read = spans.Tracer.reset, harness._read_trace

    def reset_and_start(self, mode):
        reset(self, mode)
        if mode == "mark":
            trace.start()

    def read_trace(tracer, prof, phase_a, phase_b, t_close, lat_ms, mod):
        recorded = trace.stop()
        marker = marker_launch() if prof is not None else None
        ctx = read(tracer, prof, phase_a, phase_b, t_close, lat_ms, mod)
        ctx.program = readings(recorded, prof, phase_b, t_close, marker)
        print(json.dumps(dict(info="program_spans", **ctx.program.info)),
              flush=True)
        return ctx

    spans.Tracer.reset = reset_and_start
    harness._read_trace = read_trace


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
    frames = attribute.top_level(spans, "finish")
    own = attribute.self_ns(spans)
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
    aligned, route, half = attribute.align(
        spans, notes, None if last is None else marker + last[1:])
    info["clock"] = dict(route=route, half_width_ns=half,
                         annotations=len(notes))
    if aligned is None:
        return r
    owner = attribute.owners(ops, launch, aligned)
    tot = attribute.totals(ops, owner, aligned)
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


def program(ctx):
    """The readings, or None where the run recorded no span."""
    return getattr(ctx, "program", None)


def under_per_frame(ctx, span: str, what: int):
    """Device ns (``what`` 0) or operations (1) launched under ``span``
    per AU of the profiled part; None where the run has no device trace
    read against the spans."""
    p = program(ctx)
    if p is None or p.under is None or not p.frames:
        return None
    return p.under.get(span, [0, 0])[what] / p.frames
