"""Where the time of x265_tpu_torch's 1080p slices goes, on one GPU.

    python3 tools/profile_torch.py [--slice ippp|b|bench|bench10|slow|nr|
                                            superfast|ultrafast|ctu16|
                                            gop_parallel|wavefront]
                                   [--frames N]
                                   [--out chiprun_out/profile.json]

Three encodes of a chip_smoke slice (1080p, Params() defaults): ``ippp``
(bframes=0, 4 frames through encode_frame), ``b`` (bframes=4 with
b-pyramid and the lookahead off, 6 frames through push_frame / flush:
I0 P5 B3 B1+B2 B4), ``bench`` (bench.py's configuration, the lookahead
on, 10 frames through push_frame / flush), ``bench10`` (the bench slice
at Main10, ``internal_bit_depth=10``, on ten 10-bit frames), ``slow`` (the
bench slice's frames at ``default_params("slow")``: RDOQ with psy-RDOQ,
ref=4, the lookahead on), ``nr`` (the B slice with noise reduction
600 / 600), ``superfast`` / ``ultrafast`` (the bench slice's frames at
those presets: CTU 32, bframes 3 with a fixed GOP, one reference) or
``ctu16`` (the IPPP slice at CTU 16 through encode_frame),
``gop_parallel`` (24 frames as 8 closed IPPP GOPs of 3 through
encode_gop_parallel: one batched I round, two batched P rounds) or
``wavefront`` (not an encode: the wavefront intra recon's luma 16x16
encode of ``smoke_wavefront_inputs`` at 1920x1088, 528 levels, its stages
the recon step's parts):
  1. warm-up;
  2. torch.profiler over CPU and CUDA, with the encoder's span recorder
     (``x265_tpu_torch.trace``) on: device time by kernel name, the port's
     own kernels (K1, K2) with their time and launches whatever their
     rank, and the idle share of the profiled encode (the union of the
     device's operations, ``perfbench.measure.busy``);
  3. stage breakdown from the recorder's spans (``perfbench.attribute``):
     each span's host self time, the device time and operations launched
     under it, the device's idle time by the innermost span, and the
     host's waits for the device (``sync`` spans), per frame.  The
     wavefront slice has no spans: its breakdown is empty.
On the bench and slow slices it also times the lookahead's device programs
alone with CUDA events at the 1080p lowres size (the lowres program, its SAD
half that the trellis's pair costs run, and the bidir program), so that the
lookahead stage's wall divides into device time and the host work and
synchronisation around it.
Prints a summary and writes the numbers, with the card's name and power
limit, as JSON.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _params(slice_):
    from x265_tpu_torch import smoke_config as sc
    return dict(ippp=sc.smoke_params, b=sc.smoke_params_b,
                bench=sc.smoke_params_bench,
                bench10=sc.smoke_params_bench10, slow=sc.smoke_params_slow,
                nr=sc.smoke_params_nr, superfast=sc.smoke_params_superfast,
                ultrafast=sc.smoke_params_ultrafast,
                ctu16=sc.smoke_params_ctu16,
                gop_parallel=sc.smoke_params_gop_parallel)[slice_]()


def _encode(frames, slice_):
    import torch
    from x265_tpu_torch import Encoder, Params
    from x265_tpu_torch import smoke_config as sc

    if slice_ == "wavefront":
        from x265_tpu_torch.encoder.wavefront import WavefrontIntraRecon
        x = sc.smoke_wavefront_inputs()
        blocks, modes, qp = x["y"]
        wf = WavefrontIntraRecon(x["width"], x["height"], 6, 16,
                                 is_luma=True, device="cuda")
        blocks = torch.as_tensor(blocks).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wf.encode(blocks, modes, qp)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    params = _params(slice_)
    if slice_ == "gop_parallel":
        from x265_tpu_torch.parallel import encode_gop_parallel
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encode_gop_parallel(frames, Params(**params), sc.GOPS,
                            device="cuda")
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    pushed = slice_ not in ("ippp", "ctu16")
    enc = Encoder(Params(**params), device="cuda")
    enc.headers()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for planes in frames:
        if pushed:
            enc.push_frame(planes)
        else:
            enc.encode_frame(planes)
    if pushed:
        enc.flush()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _lookahead_programs_ms(frames, slice_):
    """Device milliseconds of one call of each lookahead program on two
    analysed 1080p frames (CUDA events, the mean of 20 after a warm call)."""
    import torch
    from x265_tpu_torch import Params
    from x265_tpu_torch.encoder.lookahead import Lookahead, LowresFrame

    params = Params(**_params(slice_))
    la = Lookahead(params, params.internal_bit_depth, "cuda")
    f0, f1 = (LowresFrame(planes, None, None) for planes in frames[:2])
    la._analyze(f0)
    la._analyze(f1)
    la.bidir_cost(f1, f0, f0)                # builds the bidir program
    mv = torch.as_tensor(f1.mv, device="cuda")

    def events_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / reps

    return {"lowres program (analysis)": events_ms(
                lambda: la._prog(f1.low, f0.low)),
            "SAD half (trellis pair cost)": events_ms(
                lambda: la._prog.inter(f1.low, f0.low)),
            "bidir program": events_ms(
                lambda: la._bidir_prog(f1.low, f0.low, f0.low, mv, mv)),
            "grid": list(f0.intra_cost.shape)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--slice", choices=("ippp", "b", "bench", "bench10",
                                        "slow", "nr", "superfast",
                                        "ultrafast", "ctu16", "gop_parallel",
                                        "wavefront"),
                    default="ippp")
    ap.add_argument("--frames", type=int, default=None,
                    help="frames to encode (4 for ippp and ctu16, 6 for b "
                         "and nr, 10 for bench, bench10, slow, superfast "
                         "and ultrafast, 24 for gop_parallel, a multiple "
                         "of 8; 1 for wavefront)")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "profile.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch: no CUDA device")
    from torch.profiler import ProfilerActivity, profile
    from x265_tpu_torch.smoke_config import (smoke_frames,
                                             smoke_frames_bench10)
    if args.frames is None:
        args.frames = dict(ippp=4, b=6, bench=10, bench10=10, slow=10,
                           nr=6, superfast=10, ultrafast=10, ctu16=4,
                           gop_parallel=24, wavefront=1)[args.slice]
    bench = args.slice.startswith("bench") or args.slice == "slow"

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    frames = (smoke_frames_bench10(n=args.frames) if args.slice == "bench10"
              else smoke_frames(args.frames))
    warm = _encode(frames, args.slice)

    from perfbench import measure
    from perfbench.metrics import _program
    from x265_tpu_torch import trace
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        phase = dict(t0=t0, epoch=time.time_ns() - time.perf_counter_ns())
        trace.start()
        prof_wall = _encode(frames, args.slice)
        spans = trace.stop()
        t1 = time.perf_counter()
        marker = _program.marker_launch()
    from torch.autograd import DeviceType
    by_kernel = defaultdict(float)
    own = defaultdict(lambda: dict(ms=0.0, launches=0))
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:      # kernels and copies
            by_kernel[ev.key] += ev.self_device_time_total / 1e3   # ms
            # the kernels are templates: "void k1_kernel<64, 8, 0>(K1Args)"
            # (CTB size, bit depth, mode), "void k2_kernel<10>(...)"
            if "k1_kernel" in ev.key or "k2_kernel" in ev.key:
                k = own[ev.key.split("(")[0]]
                k["ms"] += ev.self_device_time_total / 1e3
                k["launches"] += ev.count
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:25]
    lo = int(t0 * 1e9) + phase["epoch"]
    hi = int(t1 * 1e9) + phase["epoch"]
    busy = measure.busy(
        [(s, e) for _n, s, e in measure.device_events(prof)], lo, hi) / 1e6
    stages = _program.readings(spans, prof, phase, t1, marker).info

    la_ms = _lookahead_programs_ms(frames, args.slice) if bench else None
    out = dict(device=smi, slice=args.slice, frames=args.frames,
               warm_s=warm,
               wall_ms=prof_wall * 1e3, fps=args.frames / prof_wall,
               device_busy_ms=busy,
               idle_share=1.0 - busy / ((hi - lo) / 1e6),
               kernels_ms=dict(top), port_kernels=dict(own),
               stages=stages, lookahead_programs_ms=la_ms)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"{smi}: {args.slice} {args.frames} frames, profiled wall "
          f"{prof_wall * 1e3:.1f} ms ({args.frames / prof_wall:.3f} fps), "
          f"device busy {busy:.1f} ms, idle share {out['idle_share']:.3f}")
    for k, v in sorted(own.items()):
        print(f"  {k}: {v['ms']:.3f} ms over {v['launches']} launches")
    for k, v in top:
        print(f"  {v:10.3f} ms  {k[:100]}")
    if stages.get("frames"):
        print(f"stages, ms a frame over {stages['frames']} frames (host "
              f"self / device under the span / idle under the innermost "
              f"span); clock {stages.get('clock')}:")
        dev = stages.get("under_device_ms_per_frame", {})
        idle = stages.get("idle_ms_per_frame", {})
        for k, v in sorted(stages["self_ms_per_frame"].items(),
                           key=lambda kv: -kv[1]):
            print(f"  {v:10.2f} {dev.get(k, 0.0):10.2f} "
                  f"{idle.get(k, 0.0):10.2f}  {k}")
    if la_ms is not None:
        print(f"lookahead programs alone (device ms a call, lowres grid "
              f"{la_ms.pop('grid')}):")
        for k, v in la_ms.items():
            print(f"  {v:10.4f} ms  {k}")


if __name__ == "__main__":
    main()
