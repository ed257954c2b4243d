"""The port's span recorder (``x265_tpu_torch.trace``) on the CPU at 64x64.

* the recorder's nesting, parents, frames and self time on synthetic
  spans, and that off it records nothing;
* a 4-frame ultrafast encode: off it records nothing; on it gives the
  same access units and recons byte for byte, every span the
  configuration reaches (ultrafast runs no SAO and no weightp), one
  ``scan.level`` span for each wavefront level of each scan, and the
  display index of its frame on every ``dispatch`` and ``finish``;
* the CLI's ``--profile-dir`` trace carries the layers' names.
"""

import glob
import json
import time

import numpy as np
import pytest

from x265_tpu_torch import cli, io, trace
from x265_tpu_torch.common.params import default_params
from x265_tpu_torch.encoder.intra_encoder import Encoder
from x265_tpu_torch.smoke_config import synthetic_frame
from torch_threads import one_torch_thread  # noqa: F401

W, H = 64, 64
N = 4
# the spans a CPU encode of the ultrafast preset reaches
REACHED = {"dispatch", "pad", "complexity", "qp_plan", "pipeline",
           "analysis", "search", "search.k2", "scan", "scan.prep",
           "scan.level", "scan.unpack", "loopfilter", "deblock",
           "checksum", "finish", "syntax", "entropy", "hash", "rc", "sync"}


def _frames(n):
    base = synthetic_frame(W, H, 0)
    return [(np.roll(base[0], 3 * t, axis=1), base[1], base[2])
            for t in range(n)]


def _encode():
    enc = Encoder(default_params("ultrafast", source_width=W,
                                 source_height=H, qp=32,
                                 decoded_picture_hash=1), device="cpu")
    efs = []
    for planes in _frames(N):
        efs += enc.push_frame(planes)
    efs += enc.flush()
    return enc, efs


def _outputs(efs):
    return [(ef.au, ef.display_idx, [np.asarray(p).tobytes()
                                     for p in ef.recon]) for ef in efs]


@pytest.fixture(scope="module")
def encodes():
    """The encode with the recorder off, then on: (outputs, spans) each,
    and the encoder of the traced run."""
    trace.stop()
    _enc, efs = _encode()
    off = _outputs(efs), trace.stop()
    trace.start()
    try:
        enc, efs = _encode()
    finally:
        spans = trace.stop()
    return off, (_outputs(efs), spans), enc


def test_recorder_nesting_parents_and_self_time():
    assert trace.span("x") is trace.span("y")     # off: one inert context
    with trace.span("x"):
        pass
    assert trace.stop() == []

    @trace.spanned("work")
    def work(n):
        with trace.sync():
            time.sleep(n)
        return n

    trace.start()
    with trace.span("a", 3):
        with trace.span("b"):
            work(0.002)
        with trace.span("c", None, default=7):
            pass
    with trace.span("d", None, default=5):
        with trace.span("e", -1):
            with trace.span("f", None, default=9):
                pass
    spans = trace.stop()
    names = [s[0] for s in spans]
    assert names == ["a", "b", "work", "sync", "c", "d", "e", "f"]
    parents = [s[3] for s in spans]
    assert parents == [-1, 0, 1, 2, 0, -1, 5, 6]
    # frames: given, inherited, or the default where the parent has none
    assert [s[4] for s in spans] == [3, 3, 3, 3, 3, 5, -1, 9]
    assert all(s[1] <= s[2] for s in spans)
    for i, (_n, t0, t1, p, _f) in enumerate(spans):
        if p >= 0:
            assert spans[p][1] <= t0 <= t1 <= spans[p][2]
    dur = [s[2] - s[1] for s in spans]
    own = trace.self_ns(spans)
    assert own["a"] == dur[0] - dur[1] - dur[4]
    assert own["b"] == dur[1] - dur[2]
    assert own["work"] == dur[2] - dur[3]
    assert own["sync"] == dur[3] >= 2_000_000
    assert sum(own.values()) == dur[0] + dur[5]
    assert trace.span("x") is trace.span("y")     # off again


def test_off_records_nothing_and_on_changes_no_byte(encodes):
    (out_off, spans_off), (out_on, spans_on), _enc = encodes
    assert spans_off == []
    assert len(out_on) == N and spans_on
    assert out_on == out_off


def test_every_reached_span_appears(encodes):
    _off, (_out, spans), _enc = encodes
    names = {s[0] for s in spans}
    assert names == REACHED


def test_one_level_span_per_wavefront_level(encodes):
    _off, (_out, spans), enc = encodes
    n_levels = enc._get_ctu_scan().t["n_levels"]
    scans = [i for i, s in enumerate(spans) if s[0] == "scan"]
    assert scans
    for i in scans:
        kids = [s[0] for s in spans if s[3] == i]
        assert kids.count("scan.level") == n_levels
        assert kids.count("scan.prep") == kids.count("scan.unpack") == 1
    levels = sum(s[0] == "scan.level" for s in spans)
    assert levels == n_levels * len(scans)


def test_dispatch_and_finish_carry_the_display_index(encodes):
    _off, (out, spans), _enc = encodes
    shown = sorted(d for _au, d, _rec in out)
    assert shown == list(range(N))
    for name in ("dispatch", "finish"):
        frames = sorted(s[4] for s in spans if s[0] == name)
        assert frames == shown, name
    # a finish span's children work for its frame
    for i, s in enumerate(spans):
        if s[3] >= 0 and spans[s[3]][0] == "finish":
            assert s[4] == spans[s[3]][4]


def test_cli_profile_dir_trace_names_the_layers(tmp_path):
    """--profile-dir turns the recorder on: the exported trace holds the
    layers' spans as user annotations (CPU, 64x64, two frames)."""
    inp = tmp_path / "in.y4m"
    io.write_y4m(str(inp), _frames(2), W, H)
    prof = tmp_path / "prof"
    assert cli.main([str(inp), "-o", str(tmp_path / "out.265"),
                     "--preset", "ultrafast", "--qp", "32",
                     "--no-progress", "--device", "cpu",
                     "--profile-dir", str(prof)]) == 0
    files = glob.glob(str(prof / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"scan", "loopfilter", "finish"} <= names
    assert trace.stop() == []       # the CLI turned the recorder off
