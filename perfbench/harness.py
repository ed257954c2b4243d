"""One run of one cell: set-up, the measured window, the flush, the check.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

* ``configs/<config>.json`` (the entry's ``file``): the preset and tune
  the encoder starts from, every field set beyond them, and the driver
  (``driver``, ``push_frame`` where it names none);
* ``traffic/<traffic>.json``: the content generator's parameters, the
  frames or rounds coded before the window, the pictures the check
  decodes;
* ``metrics/<metric>.py``: a reader ``read(ctx)`` of one per-layer metric
  from a traced run, returning None where it finds nothing to read.

A driver runs the program through the window (``Window``) on a pool of
frames made from the seed:

* ``push_frame`` (``drive_push``): one ``x265_tpu_torch`` ``Encoder`` in
  one thread, frames offered back to back.  The window opens after a
  fixed number of frames, at the return of a push that returned AUs (the
  lookahead is full and AUs flow), and closes at the first such return
  after ``--seconds``.  Frames still in flight are flushed after it,
  untimed, and their AUs join the stream that is judged.
* ``gop_parallel`` (``gop_parallel.drive``): closed GOPs encoded together,
  one batched dispatch a round; the window holds whole rounds.

``fps`` is every AU finished inside the window over its length.  Each
AU's reconstruction is copied for the check (``check``) without a host
synchronisation: on the card into page-locked buffers made in set-up, by
a copy queued on the stream; a seeded sample of the K1 and K2 calls is
kept for the check by cloning on the device (``steps``).

A traced run (``--trace 1``) measures the same window in two parts: the
first third with every span synchronised (the layers' self times per
frame), the rest under the profiler with unsynchronised spans and the
program's own span recorder on (the device's busy and idle time, the
kernels' device time against their bounds, the idle gaps by the host's
span, each frame's latency, the device trace by the program's spans).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import resource
import sys
import time
from types import SimpleNamespace

from . import measure

PB = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PB)
FORBIDDEN = ("jax", "jaxlib", "flax", "x265_tpu")
TRACE_SYNC_SHARE = 1 / 3


class HarnessError(Exception):
    """A cell that cannot run here (no card, a missing file)."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, root: str, workload: str) -> SimpleNamespace:
    """The cell, its configuration and its traffic, by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise HarnessError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfgs = {c["name"]: c for c in bench["configs"]}
    entry = cfgs[cell["config"]]
    config = load_json(os.path.join(root, entry["file"]))
    traffic = load_json(os.path.join(root, "perfbench", "traffic",
                                     cell["traffic"] + ".json"))
    return SimpleNamespace(cell=cell, entry=entry, config=config,
                           traffic=traffic)


def metric_readers(bench: dict, root: str, cell: dict, trace: bool) -> list:
    """[(metric entry, reader)] of the cell: its end-to-end metrics in an
    untraced run, its per-layer metrics (each a module of its own) in a
    traced run."""
    kind = "per_layer" if trace else "end_to_end"
    out = []
    for m in bench[kind]:
        if "workloads" in m and cell["name"] not in m["workloads"]:
            continue
        reader = None
        if trace:
            path = os.path.join(root, "perfbench", "metrics",
                                m["name"] + ".py")
            spec = importlib.util.spec_from_file_location(
                "perfbench_metric_" + m["name"].replace(".", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            reader = mod.read
        out.append((m, reader))
    return out


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is one the
    run may not import."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def make_params(config: dict):
    from x265_tpu_torch.common.params import default_params
    return default_params(config["preset"], tune=config.get("tune"),
                          **config["params"])


def cut_displays(traffic: dict, cuts: list, pushed: int) -> list:
    """Display indices of the frames that open a shot (the pool's own cuts,
    and its start again each time the stream wraps)."""
    pool = int(traffic["pool_frames"])
    starts = set(cuts) | {0}
    return [i for i in range(1, pushed) if i % pool in starts]


def host_planes(coded) -> tuple:
    import numpy as np
    out = []
    for p in coded:
        a = p.cpu().numpy() if hasattr(p, "cpu") else np.asarray(p)
        out.append(a.view(np.uint16) if a.dtype == np.int16 else a.copy())
    return tuple(out)


class PlaneStore:
    """The reconstructions of the AUs a run returns, for the check.  On
    the card each AU's planes are copied into a page-locked host buffer of
    ``capacity`` pictures, made at the first AU (in set-up), by a copy
    queued on the device's stream: no host synchronisation.  Beyond the
    buffer, and elsewhere, they are cloned where they are.  ``planes()``
    (after a synchronisation) gives them as host arrays."""

    def __init__(self, capacity: int, cuda: bool):
        self.capacity, self.cuda = capacity, cuda
        self.buf, self.used, self.items = None, 0, []

    def add(self, coded) -> None:
        import torch
        if not self.cuda:
            self.items.append(host_planes(coded))
            return
        sizes = [p.numel() * p.element_size() for p in coded]
        if self.buf is None:
            self.frame_bytes = sum(sizes)
            self.buf = torch.empty(self.capacity * self.frame_bytes,
                                   dtype=torch.uint8, pin_memory=True)
        if self.used < self.capacity and sum(sizes) <= self.frame_bytes:
            off = self.used * self.frame_bytes
            views = []
            for p, n in zip(coded, sizes):
                v = self.buf[off:off + n].view(p.dtype).view(p.shape)
                v.copy_(p, non_blocking=True)
                views.append(v)
                off += n
            self.used += 1
            self.items.append(tuple(views))
        else:
            self.items.append(tuple(p.clone() for p in coded))

    def planes(self) -> list:
        return [host_planes(t) for t in self.items]


class _GcWatch:
    """Collections of Python's garbage collector and their seconds, by
    generation (``gc.callbacks``)."""

    def __init__(self):
        self.n, self.s, self.t0 = [0, 0, 0], [0.0, 0.0, 0.0], 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self.t0 = time.perf_counter()
        else:
            g = info["generation"]
            self.n[g] += 1
            self.s[g] += time.perf_counter() - self.t0

    def summary(self) -> dict:
        return dict(collections=self.n, seconds=self.s)


def _recorder():
    """The program's own span recorder (``x265_tpu_torch.trace``), or None
    for a program without one."""
    try:
        from x265_tpu_torch import trace
    except ImportError:
        return None
    return trace


class Window:
    """The measured window, as every driver keeps it.  The driver calls
    ``open`` at the end of its warm-up, ``step`` at the end of each unit of
    work (a push that returned AUs, a round of GOPs) with the AUs that it
    finished until ``step`` says that the window has closed, then
    ``close``.  With a ``tracer`` (a traced run) the window is measured in
    two parts: until ``TRACE_SYNC_SHARE`` of ``seconds`` with every span of
    the tracer synchronised, then, from the end of the unit that passes
    it, with the tracer's spans unsynchronised, the program's own span
    recorder on and, on the card, the profiler."""

    def __init__(self, seconds: float, tracer, cuda: bool):
        self.seconds, self.tracer, self.cuda = seconds, tracer, cuda
        self.frames = 0
        self.t_open = self.t_close = None
        self.phase_a = self.phase_b = self.prof = self.recorder = None
        self.lat_ms = []        # frame latencies of the profiled part
        self.traced = None

    def open(self, t: float) -> None:
        import torch
        from x265_tpu_torch.encoder import ctu_scan_cuda, me_cuda
        self.k1_0, self.k2_0 = ctu_scan_cuda.LAUNCHES, me_cuda.LAUNCHES
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()
        self.t_open = t
        self.deadline = t + self.seconds
        if self.tracer is not None:
            self.tracer.reset("sync")
            self.t_split = t + self.seconds * TRACE_SYNC_SHARE
        self.ru0 = resource.getrusage(resource.RUSAGE_SELF)
        self.cpu0 = time.process_time()
        self.gc_watch = _GcWatch()
        gc.callbacks.append(self.gc_watch)

    def step(self, t: float, n: int, last: bool = False) -> bool:
        """A unit of the window ended at ``t`` with ``n`` AUs finished;
        True where the window closes with it: the first unit that ends
        ``seconds`` after the opening, or the ``last`` that the driver
        can offer."""
        self.frames += n
        if (self.tracer is not None and self.phase_b is None and n
                and t >= self.t_split):
            self._profile()
        if (t >= self.deadline or last) and n:
            self.t_close = t
            return True
        return False

    def _profile(self) -> None:
        self.phase_a = dict(self_ns=self.tracer.self_ns(),
                            frames=self.frames)
        self.tracer.reset("mark")
        self.recorder = _recorder()
        if self.recorder is not None:
            self.recorder.start()
        if self.cuda:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        self.phase_b = dict(t0=time.perf_counter(),
                            epoch=time.time_ns() - time.perf_counter_ns())

    def close(self) -> None:
        import torch
        from x265_tpu_torch.encoder import ctu_scan_cuda, me_cuda
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        self.cpu_s = time.process_time() - self.cpu0
        gc.callbacks.remove(self.gc_watch)
        self.ctx_switches = dict(
            voluntary=ru1.ru_nvcsw - self.ru0.ru_nvcsw,
            involuntary=ru1.ru_nivcsw - self.ru0.ru_nivcsw)
        self.peak = torch.cuda.max_memory_allocated() if self.cuda else 0
        self.k1_n = ctu_scan_cuda.LAUNCHES - self.k1_0
        self.k2_n = me_cuda.LAUNCHES - self.k2_0
        if self.tracer is None:
            return
        self.tracer.mode = "off"
        from . import attribute
        recorded = (self.recorder.stop() if self.recorder is not None
                    else None)
        marker = attribute.marker_launch() if self.prof is not None else None
        ctx = _read_trace(self.tracer, self.prof, self.phase_a, self.phase_b,
                          self.t_close, self.lat_ms)
        ctx.spans = recorded
        if recorded is not None:
            ctx.program = attribute.readings(recorded, self.prof,
                                             self.phase_b, self.t_close,
                                             marker)
            print(json.dumps(dict(info="program_spans",
                                  **ctx.program.info)), flush=True)
        self.traced = ctx

    def info(self) -> dict:
        return dict(
            frames=self.frames, window_s=self.t_close - self.t_open,
            k1_launches_per_frame=self.k1_n / max(1, self.frames),
            k2_launches_per_frame=self.k2_n / max(1, self.frames),
            peak_device_gib=self.peak / 2 ** 30)


def drive_push(run, win: Window) -> SimpleNamespace:
    """The ``push_frame`` driver: one ``Encoder`` in one thread, the pool's
    frames pushed back to back (the pool repeats).  The window opens at
    the return of the first push, from the traffic's ``warmup_frames``
    on, that returned AUs; a unit is a push that returned AUs.  The
    frames still in flight when it closes are flushed, untimed."""
    from x265_tpu_torch.encoder.intra_encoder import Encoder
    pool, traffic = run.pool, run.traffic
    enc = Encoder(run.params, device=run.device)
    stream = [enc.headers()]
    recon = PlaneStore(int(traffic["pool_frames"]), run.cuda)
    motion = []
    store = enc._store_col_motion

    def keep_motion(ps, poc):
        store(ps, poc)
        motion.append(enc._col_store[poc])
    enc._store_col_motion = keep_motion

    push_t = []
    win_orders = []

    def push(i):
        push_t.append(time.perf_counter())
        efs = enc.push_frame(pool[i % len(pool)])
        t = time.perf_counter()
        for ef in efs:
            stream.append(ef.au)
            recon.add(ef.coded)
        return efs, t

    warm = int(traffic["warmup_frames"])
    i = 0
    while True:
        efs, t = push(i)
        i += 1
        if i >= warm and efs:
            break
    win.open(t)
    kinds = {}
    push_s = []
    while True:
        n_before = len(recon.items)
        efs, t = push(i)
        push_s.append(t - push_t[-1])
        i += 1
        for ef in efs:
            kinds[ef.kind] = kinds.get(ef.kind, 0) + 1
        win_orders.extend(range(n_before, len(recon.items)))
        if win.phase_b is not None:
            win.lat_ms.extend((t - push_t[ef.display_idx]) * 1e3
                              for ef in efs
                              if push_t[ef.display_idx] >= win.phase_b["t0"])
        if win.step(t, len(efs)):
            break
    win.close()
    pushed = i
    for ef in enc.flush():
        stream.append(ef.au)
        recon.add(ef.coded)
    return SimpleNamespace(
        stream=stream, recon=recon, order=None, motion=motion, pushed=pushed,
        win_orders=win_orders, pool_index=lambda cvs, poc, display:
        display % len(pool), info=dict(
            pushed=pushed, window_kinds=kinds,
            push_s=dict(n=len(push_s), p50=measure.percentile(push_s, 50),
                        p90=measure.percentile(push_s, 90),
                        max=max(push_s))))


def _drivers() -> dict:
    """Each driver's run and the size of the pool it encodes."""
    from . import gop_parallel
    return {"push_frame": (drive_push,
                           lambda config, params, traffic:
                           int(traffic["pool_frames"])),
            "gop_parallel": (gop_parallel.drive, gop_parallel.pool_frames)}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, root: str = ROOT, device: str = "cuda",
             overrides: dict | None = None, fault=None) -> dict:
    """One run of ``workload``; returns the result line's object.  The
    configuration's ``driver`` (``push_frame`` where it names none)
    drives the program through the window.  The ``overrides`` (a test's
    small sizes: ``config``, ``params``, ``traffic``) and the ``fault`` (a
    function that plants one in the program and returns its undo) serve
    the benchmark's own tests and the control's readings."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    c = find_cell(bench, root, workload)
    chips = int(c.cell["chips"])
    import torch
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < chips):
        raise HarnessError(
            f"{workload} needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    config = dict(c.config)
    traffic = dict(c.traffic)
    if overrides:
        config.update(overrides.get("config", {}))
        config["params"] = {**config["params"],
                            **overrides.get("params", {})}
        traffic.update(overrides.get("traffic", {}))
    readers = metric_readers(bench, root, c.cell, trace)
    drivers = _drivers()
    name = config.get("driver", "push_frame")
    if name not in drivers:
        raise HarnessError(f"no driver {name!r}")

    from . import check, content, spans, steps
    cuda = device == "cuda"
    if cuda:
        from x265_tpu_torch.build import load_library
        load_library()
    params = make_params(config)
    drive, pool_frames = drivers[name]
    traffic["pool_frames"] = pool_frames(config, params, traffic)
    W, H = params.source_width, params.source_height
    pool = content.generate(traffic, W, H, seed, device=device)
    cuts = content.cut_frames(traffic, W, H, seed)

    undo_fault = fault() if fault is not None else None
    recorder = steps.StepRecorder(seed, int(traffic["check_k1_calls"]),
                                  int(traffic["check_k2_calls"]))
    undo_steps = recorder.install()
    tracer = (spans.Tracer(torch.cuda.synchronize if cuda else lambda: None)
              if trace else None)
    undo = spans.install(tracer) if trace else None
    if trace and cuda:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device=device).add_(1)     # CUPTI's start-up
    win = Window(seconds, tracer, cuda)
    try:
        run = drive(SimpleNamespace(
            params=params, config=config, traffic=traffic, pool=pool,
            device=device, cuda=cuda), win)
        if cuda:
            torch.cuda.synchronize()
        recon = run.recon.planes()
        if run.order is not None:
            recon = [recon[k] for k in run.order]
    finally:
        undo_steps()
        if undo is not None:
            undo()
        if undo_fault is not None:
            undo_fault()
    stream, pushed = run.stream, run.pushed
    setup_s = win.t_open - t_start
    window_s = win.t_close - win.t_open
    print(json.dumps(dict(
        info="window", **win.info(), stream_bytes=sum(len(a) for a in stream),
        **run.info, cpu_s=win.cpu_s, gc=win.gc_watch.summary(),
        ctx_switches=win.ctx_switches)), flush=True)

    run.recon = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    judged_cuts = (cut_displays(traffic, cuts, pushed)
                   if params.scenecut_threshold > 0 and cuts else None)
    t_check = time.perf_counter()
    au_stream = b"".join(stream)
    sample = check.draw_sample(seed, run.win_orders,
                               int(traffic["check_pictures"]),
                               check.slice_types(au_stream))
    log, step_log = [], []
    source = None
    if params.sao:
        def source(e):
            return host_planes(pool[run.pool_index(e.cvs, e.poc, e.display)])
    numbers = check.judge(au_stream, pushed, recon, run.motion, sample,
                          judged_cuts, device, log, source)
    numbers.update(check.judge_steps(au_stream, recorder, config, step_log))
    ok = check.verdict(numbers)
    print(json.dumps(dict(info="check", pictures=log, steps=step_log,
                          seconds=time.perf_counter() - t_check)), flush=True)
    failed = numbers["pictures_missing"] + (0 if ok else 1)

    metrics = {}
    traced = win.traced
    for m, reader in readers:
        if trace:
            v = reader(traced)
        elif m["name"] == "fps":
            v = win.frames / window_s
        elif m["name"] == "setup_s":
            v = setup_s
        else:
            v = None
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(0) if cuda else "cpu",
               count=chips, memory_peak_bytes=win.peak)
    result = dict(correct=ok, attempted=pushed, failed=failed,
                  metrics=metrics, device=dev)
    if trace and traced is not None:
        dev["busy_s"] = traced.busy_ns / 1e9
        dev["window_s"] = traced.window_ns / 1e9
        result["breakdown"] = traced.breakdown
    result["checks"] = check.report(numbers)
    return result


def _read_trace(tracer, prof, phase_a, phase_b, t_close,
                lat_ms) -> SimpleNamespace:
    """The traced window's readings, for the per-layer metrics' readers."""
    ctx = SimpleNamespace(
        frames_a=phase_a["frames"], self_ms={
            k: v / 1e6 for k, v in phase_a["self_ns"].items()},
        latencies_ms=lat_ms, busy_ns=0, window_ns=0, breakdown=None,
        kernel_ns={}, k1_bounds_ms=[], k2_bounds_ms=[])
    if prof is None:
        return ctx
    prof.__exit__(None, None, None)
    epoch = phase_b["epoch"]
    lo = int(phase_b["t0"] * 1e9) + epoch
    hi = int(t_close * 1e9) + epoch
    evs = measure.device_events(prof)
    iv = [(s, e) for _, s, e in evs]
    ctx.window_ns = hi - lo
    ctx.busy_ns = measure.busy(iv, lo, hi)
    by_name, short = {}, {}
    for name, s, e in evs:
        by_name[name] = by_name.get(name, 0) + (e - s)
        k = measure.short_name(name)
        short[k] = short.get(k, 0) + (e - s)
    ctx.kernel_ns = by_name
    host = [(name, s + epoch, e + epoch) for name, s, e, _p in tracer.spans
            if e > 0]
    idle = measure.label_gaps(measure.gaps(iv, lo, hi), host)
    ctx.breakdown = dict(
        device_ops=[[k, v / 1e9] for k, v in measure.top(short)],
        idle_gaps=[[k, v / 1e9] for k, v in measure.top(idle)])
    from . import yardstick
    ctx.k1_bounds_ms = [yardstick.k1_record_bound(r)[0] for r in tracer.k1]
    ctx.k2_bounds_ms = [yardstick.k2_record_bound(r)[0] for r in tracer.k2]
    tracer.k1, tracer.k2 = [], []
    return ctx
