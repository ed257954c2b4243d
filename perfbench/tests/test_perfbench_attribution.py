"""The device trace read against the program's spans, on synthetic events:
the innermost span at each launch, unattributed operations, the partition
of device time, the two clock routes, the readings and the readers; and a
traced run on the CPU that reports the spans' own metrics."""

import json
import sys
import time
import types

import pytest
from torch.autograd import DeviceType

from perfbench import attribute, harness
from perfbench.metrics import _program
from perfbench.tests.tiny import CELLS

# (name, start, end, parent, frame), in the order they began
SPANS = [("finish", 0, 100, -1, 4),        # 0
         ("sync", 10, 20, 0, 4),           # 1
         ("dispatch", 200, 400, -1, 5),    # 2
         ("search", 210, 300, 2, 5),       # 3
         ("search", 220, 260, 3, 5),       # 4
         ("search.k2", 230, 240, 4, 5),    # 5
         ("scan", 300, 390, 2, 5),         # 6
         ("scan.level", 310, 320, 6, 5),   # 7
         ("scan.level", 320, 330, 6, 5),   # 8
         ("finish", 500, 600, -1, 5),      # 9
         ("finish", 510, 590, 9, 5)]       # 10: a redo inside a finish


def test_innermost_span_at_each_launch():
    times, owner = attribute.innermost(SPANS)
    launches = {1: 15, 2: 235, 3: 225, 4: 270, 5: 315, 6: 320, 7: 150,
                8: 395, 9: 0}
    ops = [("k", 1000 + c, 1010 + c, c) for c in range(1, 11)]
    own = attribute.owners(ops, launches, SPANS)
    # 6 launches at the instant one level ends and the next begins;
    # 10 has no launch event
    assert own == [1, 5, 4, 3, 7, 8, -1, 2, 0, -1]
    assert times == sorted(times)


def test_device_time_partitions():
    ops = [("k1_kernel<32>", 0, 30, 1), ("elementwise", 40, 45, 2),
           ("k2_kernel<8>", 50, 70, 3), ("copy", 80, 81, 4),
           ("elementwise", 90, 100, 5)]
    own = [7, 4, 5, -1, 3]
    tot = attribute.totals(ops, own, SPANS)
    assert tot["total"] == [66, 5]
    assert tot["unattributed"] == [1, 1]
    assert tot["by_span"] == {"scan.level": [30, 1], "search": [15, 2],
                              "search.k2": [20, 1]}
    # a span's subtree: nested spans of one name count once
    assert tot["under"]["search"] == [35, 3]
    assert tot["under"]["scan"] == [30, 1]
    assert tot["under"]["dispatch"] == [65, 4]
    attributed = sum(v[0] for v in tot["by_span"].values())
    assert attributed + tot["unattributed"][0] == tot["total"][0]


def test_self_time_and_frames():
    own = attribute.self_ns(SPANS)
    assert own["finish"] == 90 + 20 + 80
    assert own["search"] == (90 - 40) + (40 - 10)
    assert own["scan"] == 90 - 20
    assert attribute.top_level(SPANS, "finish") == 2


def test_clock_routes():
    notes = [(s[0], s[1] + 7000, s[2] + 7000) for s in SPANS]
    al, route, half = attribute.align(SPANS, notes)
    assert route == "annotations" and half == 0
    assert al[3] == ("search", 7210, 7300, 2, 5)
    # annotations that are not the spans one for one: the marker
    al, route, half = attribute.align(SPANS, notes[1:], (1000, 1010,
                                                         5004, 5006))
    assert route == "marker"
    assert (half, al[0][1]) == (4, 4000)    # offset in [3996, 4004]
    assert attribute.align(SPANS, [], (1000, 1001, 0, 5)) == (None, None,
                                                              None)
    assert attribute.align(SPANS, [], None)[0] is None


class _Ev:
    def __init__(self, name, dev, s, e, corr):
        self._v = (name, dev, s, e, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def _prof(events):
    res = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=res))


def test_readings_on_a_synthetic_trace():
    """The marker route (no annotations): the spans move by the offset the
    marker's launch gives; K1 under a level, K2 under search.k2; the
    marker's own operation is left out."""
    off = 10_000
    cpu, dev = DeviceType.CPU, DeviceType.CUDA
    evs = [_Ev("cudaLaunchKernel", cpu, off + 312, off + 313, 1),
           _Ev("void k1_kernel<32, 8, 0>(K1Args)", dev, off + 330,
               off + 360, 1),
           _Ev("cudaLaunchKernel", cpu, off + 232, off + 233, 2),
           _Ev("void k2_kernel<8>(int const*)", dev, off + 240, off + 250,
               2),
           _Ev("cudaMemcpyAsync", cpu, off + 12, off + 18, 3),
           _Ev("Memcpy DtoH (Device -> Pageable)", dev, off + 13,
               off + 17, 3),
           _Ev("cudaLaunchKernel", cpu, off + 150, off + 151, 4),
           _Ev("void elementwise_kernel", dev, off + 152, off + 160, 4),
           _Ev("cudaStreamSynchronize", cpu, off + 12, off + 18, 9),
           _Ev("cudaLaunchKernel", cpu, off + 1002, off + 1004, 5),
           _Ev("void spin_kernel(long)", dev, off + 1005, off + 1006, 5)]
    phase_b = dict(t0=0.0, epoch=off)
    r = attribute.readings(SPANS, _prof(evs), phase_b, 700e-9,
                           (1000, 1006))
    info = r.info
    assert info["clock"] == dict(route="marker", half_width_ns=2,
                                 annotations=0)
    assert r.frames == 2 and r.levels == 2 and r.syncs == 1
    assert info["k1"] == dict(ops=1, under_span=1)
    assert info["k2"] == dict(ops=1, under_span=1)
    assert info["ops"] == dict(total=4, unattributed=1)
    dm = info["device_ms"]
    assert dm["attributed"] + dm["unattributed"] == pytest.approx(
        dm["total"]) and dm["total"] == pytest.approx(52e-6)
    ctx = types.SimpleNamespace(program=r)
    assert _program.under_per_frame(ctx, "scan", 0) == 15
    assert _program.under_per_frame(ctx, "search", 1) == 0.5
    assert _program.under_per_frame(ctx, "loopfilter", 0) == 0.0
    # the idle stretches of the window by the innermost span
    assert sum(info["idle_ms_per_frame"].values()) == pytest.approx(
        (700 - 52) / 1e6 / 2)


def test_readers_read_nothing_without_the_spans():
    """Against a program without the recorder no reading reaches ctx:
    every reader of the spans returns None."""
    bench = harness.load_json(harness.ROOT + "/BENCHMARK.json")
    c = harness.find_cell(bench, harness.ROOT, "ultrafast-1080p.live")
    readers = dict((m["name"], r) for m, r in harness.metric_readers(
        bench, harness.ROOT, c.cell, True))
    new = ("k1_host_us_per_launch", "scan_device_ms_per_frame",
           "search_device_ms_per_frame", "loopfilter_device_ms_per_frame",
           "search_launches_per_frame", "loopfilter_launches_per_frame",
           "host_syncs_per_frame", "host_sync_ms_per_frame")
    for name in new:
        assert readers[name](types.SimpleNamespace()) is None, name


def test_no_recorder_no_hook(monkeypatch):
    """A program without ``x265_tpu_torch.trace`` (the parent's) has no
    recorder for the harness to turn on: a traced run reads none of its
    spans, and its readers return None."""
    import x265_tpu_torch
    with monkeypatch.context() as mp:
        mp.delattr(x265_tpu_torch, "trace", raising=False)
        mp.setitem(sys.modules, "x265_tpu_torch.trace", None)
        assert harness._recorder() is None
    monkeypatch.setattr(harness, "_recorder", lambda: None)
    res = harness.run_cell("ultrafast-1080p.live", 2 ** 31 + 13, 1.0, True,
                           time.perf_counter(), device="cpu",
                           overrides=CELLS["ultrafast-1080p.live"])
    assert res["correct"]
    m = res["metrics"]
    assert "k1_host_us_per_launch" not in m
    assert "host_syncs_per_frame" not in m
    assert "scan_ms_per_frame" in m


def test_traced_cpu_run_reports_the_spans():
    """A traced run on the CPU reports the metrics of the spans' own
    clock; the device metrics need the card's trace."""
    res = harness.run_cell("ultrafast-1080p.live", 2 ** 31 + 11, 3.0, True,
                           time.perf_counter(), device="cpu",
                           overrides=CELLS["ultrafast-1080p.live"])
    assert res["correct"]
    m = res["metrics"]
    assert m["k1_host_us_per_launch"]["value"] > 0
    assert m["host_syncs_per_frame"]["value"] > 0
    assert m["host_sync_ms_per_frame"]["value"] > 0
    assert "scan_device_ms_per_frame" not in m
    assert "scan_ms_per_frame" in m and "entropy_ms_per_frame" in m


def test_traced_segment_run_reports_the_spans(capsys):
    """The GOP-parallel driver's traced run: the recorder is on in the
    profiled part, every AU of it is a top-level ``finish`` span, and the
    readers of the spans' own clock read the batched rounds."""
    w = "medium-zerolatency-1080p.ch8"
    res = harness.run_cell(w, 2 ** 31 + 17, 1.0, True, time.perf_counter(),
                           device="cpu", overrides=CELLS[w])
    assert res["correct"]
    m = res["metrics"]
    for name in ("k1_host_us_per_launch", "host_syncs_per_frame",
                 "scan_ms_per_frame", "search_ms_per_frame",
                 "entropy_ms_per_frame", "loopfilter_ms_per_frame"):
        assert m[name]["value"] > 0, name
    assert "frame_latency_ms_p90" not in m
    out = capsys.readouterr().out
    spans_line = [json.loads(x) for x in out.splitlines()
                  if '"program_spans"' in x][0]
    assert spans_line["frames"] > 0
    assert spans_line["frames"] % CELLS[w]["config"]["gops"] == 0
