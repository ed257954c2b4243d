"""The harness on the CPU: discovery by name, the metric arithmetic, the
import check, the draw of the judged pictures, and whole runs of every
cell (and of a cell with shot cuts added as files) at a small size, sound
and with each planted fault; the GOP-parallel driver's window."""

import json
import os
import shutil
import sys
import time
import types

import pytest

from perfbench import check, faults, harness, measure, run, spans
from perfbench.tests.tiny import CELLS, VOD, VOD_CONFIG, VOD_TRAFFIC

ROOT = harness.ROOT


def _bench():
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def test_every_cell_finds_its_files():
    bench = _bench()
    for cell in bench["workloads"]:
        c = harness.find_cell(bench, ROOT, cell["name"])
        assert c.config["name"] == cell["config"]
        # the GOP-parallel driver's pool is its GOPs
        assert ("pool_frames" in c.traffic) != (
            c.config.get("driver") == "gop_parallel")
        for trace in (False, True):
            readers = harness.metric_readers(bench, ROOT, c.cell, trace)
            names = {m["name"] for m, _ in readers}
            if trace:
                assert names == {m["name"] for m in bench["per_layer"]
                                 if cell["name"] in m.get(
                                     "workloads", [cell["name"]])}
                assert names and all(callable(r) for _, r in readers)
            else:
                assert names == {"fps", "setup_s"}


def _add_cell(root, name, config, traffic, bench=None):
    """Add a configuration, a traffic mix and a cell to the copy at
    ``root`` as new files and entries only; returns the benchmark."""
    bench = bench or harness.load_json(os.path.join(root, "BENCHMARK.json"))
    (root / "perfbench" / "configs" / (config["name"] + ".json")).write_text(
        json.dumps(config))
    (root / "perfbench" / "traffic" / (name + ".json")).write_text(
        json.dumps(traffic))
    bench["configs"].append(dict(
        bench["configs"][0], name=config["name"],
        file=f"perfbench/configs/{config['name']}.json"))
    bench["workloads"].append(dict(name=f"{config['name']}.{name}",
                                   config=config["name"], traffic=name,
                                   chips=1, why="a test's added cell"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench


def _copy(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(os.path.join(ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    return root


@pytest.fixture
def copy_with_additions(tmp_path):
    """A copy of the benchmark to which a configuration, a traffic mix, a
    per-layer metric and a cell are added as new files and entries only."""
    root = _copy(tmp_path)
    (root / "perfbench" / "metrics" / "pushes_per_frame.py").write_text(
        '"""pushes_per_frame: push spans per frame."""\n\n\n'
        "def read(ctx):\n"
        "    return ctx.self_ms.get('push') and 1.0\n")
    bench = _add_cell(root, "vod2", dict(VOD_CONFIG, name="x265-fast-1080p",
                                         preset="fast"),
                      dict(VOD_TRAFFIC, shot_frames=[40, 50]))
    bench["per_layer"].append(dict(
        name="pushes_per_frame", unit="1", better="lower",
        source="program_span", layer="entry", moves="fps",
        workloads=["x265-fast-1080p.vod2"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


@pytest.fixture(scope="module")
def vod_copy(tmp_path_factory):
    """A copy with a cell of shot cuts and scene-cut detection added."""
    root = _copy(tmp_path_factory.mktemp("vod"))
    _add_cell(root, "vod", VOD_CONFIG, VOD_TRAFFIC)
    return str(root)


def test_metric_workloads_select_cells(copy_with_additions):
    root = copy_with_additions
    bench = harness.load_json(os.path.join(root, "BENCHMARK.json"))
    names = {c: {m["name"] for m, _ in harness.metric_readers(
        bench, root, harness.find_cell(bench, root, c).cell, True)}
        for c in ("ultrafast-1080p.live", "x265-fast-1080p.vod2")}
    assert "pushes_per_frame" in names["x265-fast-1080p.vod2"]
    assert "pushes_per_frame" not in names["ultrafast-1080p.live"]
    assert "frame_latency_ms_p90" in names["ultrafast-1080p.live"]
    assert "frame_latency_ms_p90" not in names["x265-fast-1080p.vod2"]


def test_added_files_are_found_by_name(copy_with_additions):
    root = copy_with_additions
    bench = harness.load_json(os.path.join(root, "BENCHMARK.json"))
    c = harness.find_cell(bench, root, "x265-fast-1080p.vod2")
    assert c.config["preset"] == "fast"
    assert c.traffic["shot_frames"] == [40, 50]
    readers = dict((m["name"], r) for m, r in harness.metric_readers(
        bench, root, c.cell, True))
    assert readers["pushes_per_frame"](types.SimpleNamespace(
        self_ms={"push": 3.0})) == 1.0


def test_added_cell_runs(copy_with_additions):
    res = harness.run_cell("x265-fast-1080p.vod2", 31, 2.0, True,
                           time.perf_counter(), root=copy_with_additions,
                           device="cpu", overrides=VOD)
    assert res["correct"]
    assert res["metrics"]["pushes_per_frame"]["value"] == 1.0
    assert list(res)[-1] == "checks"


def test_percentile_over_every_sample():
    v = list(range(1, 101))
    assert measure.percentile(v, 90) == 90
    assert measure.percentile(v[::-1], 90) == 90
    assert measure.percentile([5.0], 90) == 5.0
    assert measure.percentile(list(range(1, 12)), 90) == 10


def test_union_counts_overlap_once():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 50)]
    assert measure.busy(iv, 0, 100) == 35
    assert measure.busy(iv, 8, 45) == 7 + 10 + 5
    assert measure.gaps(iv, 0, 60) == [(15, 20), (30, 40), (50, 60)]
    # two streams covering the same stretch: busy never passes the window
    assert measure.busy([(0, 100), (0, 100)], 0, 100) == 100


def test_idle_gaps_labelled_by_innermost_span():
    spans_ = [("push", 0, 100), ("entropy", 10, 30), ("loopfilter", 50, 60)]
    gaps = [(12, 14), (20, 28), (40, 44), (52, 54), (110, 120)]
    out = measure.label_gaps(gaps, spans_)
    assert out == {"entropy": 10, "push": 4, "loopfilter": 2, "no span": 10}


def test_roofline_sums():
    assert measure.roofline_pct([0.001, 0.003], 8000) == pytest.approx(50.0)
    assert measure.roofline_pct([], 100) is None
    assert measure.roofline_pct([0.1], 0) is None


def test_self_time_excludes_children():
    t = spans.Tracer(lambda: None)
    t.reset("mark")
    inner = t.wrap("entropy", lambda: time.sleep(0.02))
    outer = t.wrap("push", lambda: (time.sleep(0.01), inner()))
    outer()
    s = t.self_ns()
    assert 0.015e9 <= s["entropy"] < 0.2e9
    assert 0.005e9 <= s["push"] < 0.02e9 + 0.01e9
    assert [x[3] for x in t.spans] == [-1, 0]


@pytest.mark.parametrize("name,bad", [("x265_tpu_torch", False),
                                      ("x265_tpu_torch.encoder", False),
                                      ("x265_tpu", True),
                                      ("x265_tpu.common", True),
                                      ("jax", True), ("jaxlib", True),
                                      ("flax.linen", True)])
def test_import_check(monkeypatch, name, bad):
    for k in list(sys.modules):
        if k.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, k)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert bool(harness.forbidden_modules()) == bad


def _run(workload, vod_copy, **kw):
    if workload == "vod":
        return harness.run_cell("x265-medium-test.vod", 2 ** 31 + 7, 3.0,
                                False, time.perf_counter(), root=vod_copy,
                                device="cpu", overrides=VOD, **kw)
    return harness.run_cell(workload, 2 ** 31 + 7, 3.0, False,
                            time.perf_counter(), device="cpu",
                            overrides=CELLS[workload], **kw)


@pytest.mark.parametrize("workload", sorted(CELLS) + ["vod"])
def test_sound_run_is_correct(workload, vod_copy):
    res = _run(workload, vod_copy)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["metrics"]["fps"]["value"] > 0
    assert res["metrics"]["setup_s"]["value"] > 0
    assert all(v["value"] == 0 for v in res["checks"].values())
    assert {"k1_outputs_differing", "k2_outputs_differing"} <= set(
        res["checks"])
    # the SAO decision is judged where the configuration runs SAO
    assert ("sao_ctbs_differing" in res["checks"]) == (
        workload != "ultrafast-1080p.live")


# every fault each cell can have: the live and channel configurations
# detect no scene cuts, and the live one runs no SAO
NOT_THERE = {"ultrafast-1080p.live": {"scenecut_missed", "sao_skipped"},
             "medium-zerolatency-1080p.ch8": {"scenecut_missed"}}
CELL_FAULTS = [(w, f) for w in sorted(CELLS) + ["vod"]
               for f in sorted(faults.FAULTS)
               if f not in NOT_THERE.get(w, ())]


@pytest.mark.parametrize("workload,fault", CELL_FAULTS)
def test_fault_is_caught(workload, fault, vod_copy):
    res = _run(workload, vod_copy, fault=faults.FAULTS[fault])
    assert not res["correct"]
    assert not check.verdict({k: v["value"]
                              for k, v in res["checks"].items()})


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_fails_the_step_check(workload):
    """The control (the reference steps in bfloat16 in the program's
    place) fails the numbers that hold the encoder's decisions."""
    res = _run(workload, None, fault=faults.control)
    c = {k: v["value"] for k, v in res["checks"].items()}
    assert c["k1_outputs_differing"] + c["k2_outputs_differing"] > 0


def test_sample_covers_every_slice_type():
    types = [2, 1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 2, 1, 0]
    window = list(range(4, 16))
    for seed in range(20):
        s = check.draw_sample(seed, window, 3, types)
        assert s[0] == 0 and len(s) == 4
        assert {types[k] for k in s[1:]} == {0, 1, 2}
        assert set(s[1:]) <= set(window)
    assert check.draw_sample(5, window, 3, types) == check.draw_sample(
        5, window, 3, types)


def test_run_that_loads_the_jax_package_prints_nothing(tmp_path, capsys):
    """A per-layer reader that imports the JAX package inside ``read``
    makes the run exit non-zero with no result line."""
    root = _copy(tmp_path)
    (root / "perfbench" / "metrics" / "device_idle_share.py").write_text(
        "def read(ctx):\n"
        "    import x265_tpu.common  # noqa: F401\n"
        "    return None\n")
    before = set(sys.modules)
    try:
        rc = run.main(["--workload", "ultrafast-1080p.live", "--seed", "3",
                       "--seconds", "1", "--trace", "1"], root=str(root),
                      device="cpu", overrides=CELLS["ultrafast-1080p.live"])
    finally:
        for k in set(sys.modules) - before:
            if k.split(".")[0] in harness.FORBIDDEN:
                del sys.modules[k]
    out = capsys.readouterr()
    assert rc != 0
    assert "x265_tpu" in out.err
    assert '"correct"' not in out.out


def _info(out: str, name: str) -> dict:
    """The info line ``name`` that a run printed."""
    for line in out.splitlines():
        if line.startswith("{") and json.loads(line).get("info") == name:
            return json.loads(line)
    raise AssertionError(f"no {name} line")


def test_gop_window_holds_whole_p_rounds(capsys):
    """The GOP-parallel window opens after the warm-up rounds and holds
    whole rounds of P pictures with every reference slot active; the
    call stops at the window's last round."""
    w = "medium-zerolatency-1080p.ch8"
    res = harness.run_cell(w, 2 ** 31 + 5, 0.5, False, time.perf_counter(),
                           device="cpu", overrides=CELLS[w])
    info = _info(capsys.readouterr().out, "window")
    G = CELLS[w]["config"]["gops"]
    assert res["correct"], res["checks"]
    assert info["frames"] > 0 and info["frames"] % G == 0
    assert info["window_kinds"] == {"P": info["frames"]}
    assert info["window_refs"] == {"3": info["frames"]}
    assert not info["window_at_gop_end"]
    assert res["attempted"] == info["pushed"] == G * (4 + info["frames"]
                                                      // G)


# the result line's layout on the parent of the GOP-parallel driver: the
# push_frame path's line keeps it
LIVE_LINE = {
    False: (["correct", "attempted", "failed", "metrics", "device",
             "checks"], ["fps", "setup_s"],
            ["platform", "kind", "count", "memory_peak_bytes"]),
    True: (["correct", "attempted", "failed", "metrics", "device",
            "breakdown", "checks"],
           ["frame_latency_ms_p90", "entropy_ms_per_frame",
            "loopfilter_ms_per_frame", "search_ms_per_frame",
            "scan_ms_per_frame", "k1_host_us_per_launch",
            "host_syncs_per_frame", "host_sync_ms_per_frame"],
           ["platform", "kind", "count", "memory_peak_bytes", "busy_s",
            "window_s"])}


@pytest.mark.parametrize("trace", [False, True])
def test_live_result_line_is_as_before(trace):
    w = "ultrafast-1080p.live"
    res = harness.run_cell(w, 2 ** 31 + 7, 2.0, trace, time.perf_counter(),
                           device="cpu", overrides=CELLS[w])
    keys, metrics, device = LIVE_LINE[trace]
    assert list(res) == keys
    assert list(res["metrics"]) == metrics
    assert list(res["device"]) == device
    assert res["correct"] and res["failed"] == 0
    assert {k: v["value"] for k, v in res["checks"].items()} == dict(
        pictures_missing=0, samples_differing=0, hash_mismatches=0,
        motion_mismatches=0, k1_outputs_differing=0, k2_outputs_differing=0)


def test_gop_window_closes_at_the_gops_end(capsys):
    """A window longer than the rest of the GOPs closes at their last
    round: it never holds an I round or a round with fewer reference
    pictures, whatever the program's speed."""
    w = "medium-zerolatency-1080p.ch8"
    res = harness.run_cell(w, 2 ** 31 + 9, 60.0, False, time.perf_counter(),
                           device="cpu", overrides=CELLS[w])
    info = _info(capsys.readouterr().out, "window")
    G = CELLS[w]["config"]["gops"]
    K = CELLS[w]["params"]["keyint_max"]
    assert res["correct"], res["checks"]
    assert info["window_at_gop_end"] and info["window_s"] < 60.0
    assert info["window_kinds"] == {"P": G * (K - 4)}
    assert info["window_refs"] == {"3": G * (K - 4)}
    assert res["attempted"] == G * K
