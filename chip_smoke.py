#!/usr/bin/env python3
"""Smoke test of x265_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):
  1. the card's name and power limit (nvidia-smi), then the build of the
     kernels K1 and K2 from x265_tpu_torch/csrc/ with nvcc for sm_90a;
  2. K1 against its plain torch step on the card: the whole 62-level CTU
     scan of seeded random 1920x1088 inputs, I and P, psy-rd 2.0; every
     output must be equal;
  3. K2 against its plain torch version on the card: 8160 blocks, subme 2,
     merange 57; q0, pred and cost must be equal;
  4. the slice: 1080p IPPP (4 frames of the bench's panning content) at
     Params() defaults with bframes=0 through Encoder.encode_frame on the
     card; K1 must launch 62 x 4 times and K2 3 x 3 times, and the stream's
     MD5 must equal the golden digest of x265_tpu's own encode
     (x265_tpu_torch/data/golden_1080p_ippp.json, tools/make_golden.py).
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def _events_ms(fn, reps):
    """Mean device milliseconds of ``fn()`` over ``reps`` calls (after one
    warm call), timed with CUDA events."""
    import torch
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


def _max_abs_err(a, b):
    import torch
    errs = [0.0]
    for x, y in zip(a, b):
        if x is None and y is None:
            continue
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"shape/dtype differ: {x.shape} {x.dtype} "
                                 f"vs {y.shape} {y.dtype}")
        d = (x.to(torch.float64) - y.to(torch.float64)).abs()
        errs.append(float(d.max()) if d.numel() else 0.0)
    return max(errs)


def check_k1(dev):
    """K1 vs the plain step: full scans of random 1080p inputs."""
    import numpy as np
    import torch
    from x265_tpu_torch.encoder.ctu_scan import CtuScan, PictureGeometry

    rng = np.random.RandomState(1)
    g = PictureGeometry(1920, 1088, 6, 3)
    ph, pw = g.ctbs_h << 6, g.ctbs_w << 6
    b16, b32, nctb = (ph // 16) * (pw // 16), (ph // 32) * (pw // 32), \
        g.n_ctbs

    def T(a):
        return torch.as_tensor(a).to(dev)

    oy = T(rng.randint(0, 256, (ph, pw)).astype(np.uint8))
    ocb = T(rng.randint(0, 256, (ph // 2, pw // 2)).astype(np.uint8))
    ocr = T(rng.randint(0, 256, (ph // 2, pw // 2)).astype(np.uint8))
    qp = T(rng.randint(24, 40, nctb).astype(np.int32))
    lam = T((0.85 * 2.0 ** (rng.randint(24, 40, nctb) / 3.0 - 4.0)
             ).astype(np.float32))
    modes = T(rng.randint(0, 35, b16).astype(np.int32))
    mode32 = T(rng.randint(0, 35, b32).astype(np.int32))
    use32 = torch.zeros((b32,), dtype=torch.bool, device=dev)
    inter = dict(is_inter=T(rng.rand(b16) < 0.7),
                 ipred_y=T(rng.randint(0, 256, (b16, 16, 16)).astype(
                     np.int32)),
                 ipred_cb=T(rng.randint(0, 256, (b16, 8, 8)).astype(
                     np.int32)),
                 ipred_cr=T(rng.randint(0, 256, (b16, 8, 8)).astype(
                     np.int32)),
                 m32_in=T(rng.rand(b32) < 0.4))
    scan = CtuScan(g, bit_depth=8, sign_hide=True,
                   strong_intra_smoothing=True, psy_rd=2.0)
    res = {}
    for cfg in ("I", "P"):
        kw = inter if cfg == "P" else {}
        runs = {}
        for route in ("kernel", "plain"):
            fn = scan.scan_fn(inter=cfg == "P", decide32=True,
                              allow_kernel=route == "kernel")

            def go(fn=fn, kw=kw):
                return fn(oy, ocb, ocr, modes, mode32, use32, qp, qp, qp,
                          lam=lam, **kw)

            out = go()
            torch.cuda.synchronize()
            runs[route] = (out, _events_ms(go, 2))
        err = _max_abs_err(runs["kernel"][0], runs["plain"][0])
        print(f"K1 {cfg}: 62-level scan {runs['kernel'][1]:.2f} ms kernel, "
              f"{runs['plain'][1]:.2f} ms plain, max_abs_err {err}",
              flush=True)
        if err != 0.0:
            raise AssertionError(f"K1 differs from the plain step ({cfg})")
        res[cfg] = (runs["kernel"][1], runs["plain"][1], err)
    return res


def check_k2(dev):
    """K2 vs the plain refine at the 1080p shapes (B = 8160)."""
    import numpy as np
    import torch
    from x265_tpu_torch.encoder import me_cuda
    from x265_tpu_torch.encoder.device_pipeline import me_lambda

    rng = np.random.RandomState(2)
    B, mrq = 8160, 57
    base = rng.randint(0, 256, (B, 1, 25)).astype(np.int32)
    W = torch.as_tensor(np.clip(base + rng.randint(-20, 21, (B, 25, 25)),
                                0, 255).astype(np.int32)).to(dev)
    ob = torch.as_tensor(rng.randint(0, 256, (B, 16, 16)).astype(
        np.int32)).to(dev)
    mvi = torch.as_tensor(rng.randint(-mrq, mrq + 1, (B, 2)).astype(
        np.int32)).to(dev)
    pmv = torch.as_tensor((4 * rng.randint(-49, 50, (B, 2))).astype(
        np.int32)).to(dev)
    lam = me_lambda(32).to(dev)
    lib = me_cuda.load_library()
    k = me_cuda.launch(lib, W, ob, mvi, pmv, lam, 2, mrq)
    p = me_cuda.refine_plain(W, ob, mvi, pmv, lam, 2, mrq)
    torch.cuda.synchronize()
    err = _max_abs_err(k, p)
    ms = _events_ms(lambda: me_cuda.launch(lib, W, ob, mvi, pmv, lam, 2,
                                           mrq), 10)
    plain_ms = _events_ms(lambda: me_cuda.refine_plain(W, ob, mvi, pmv, lam,
                                                       2, mrq), 3)
    print(f"K2: B={B} subme 2 merange {mrq}: {ms:.3f} ms kernel, "
          f"{plain_ms:.3f} ms plain, max_abs_err {err}", flush=True)
    if err != 0.0:
        raise AssertionError("K2 differs from the plain refine")
    return ms, plain_ms, err


def encode_slice(dev):
    """The 1080p IPPP slice through Encoder.encode_frame; returns the
    stream and per-frame wall seconds."""
    import torch
    from x265_tpu_torch import Encoder, Params
    from x265_tpu_torch.smoke_config import smoke_frames, smoke_params

    frames = smoke_frames()
    enc = Encoder(Params(**smoke_params()), device=dev)
    aus, secs = [enc.headers()], []
    for planes in frames:
        torch.cuda.synchronize()
        t0 = time.time()
        au, _rec = enc.encode_frame(planes)
        torch.cuda.synchronize()
        secs.append(time.time() - t0)
        aus.append(au)
    return aus, secs


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import x265_tpu_torch  # noqa: F401  (fails outside a checkout)
    from x265_tpu_torch import build
    from x265_tpu_torch.encoder import ctu_scan_cuda, me_cuda

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.time()
    lib = build.load_library()
    print(f"kernel build: {time.time() - t0:.1f} s (nvcc sm_90a), "
          f"K1 shared memory {lib.k1_smem_bytes()} B", flush=True)
    for line in build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip(), flush=True)

    k1 = check_k1(dev)
    k2 = check_k2(dev)

    with open(os.path.join(ROOT, "x265_tpu_torch", "data",
                           "golden_1080p_ippp.json")) as f:
        golden = json.load(f)
    encode_slice(dev)                       # warm: first-call allocations
    ctu_scan_cuda.LAUNCHES = 0
    me_cuda.LAUNCHES = 0
    aus, secs = encode_slice(dev)
    n1, n2 = ctu_scan_cuda.LAUNCHES, me_cuda.LAUNCHES
    stream = b"".join(aus)
    md5 = hashlib.md5(stream).hexdigest()
    nfr = len(secs)
    fps = nfr / sum(secs)
    print(f"slice 1080p IPPP on {smi}: bytes per AU {[len(a) for a in aus]}"
          f", frame seconds {[round(s, 3) for s in secs]}, {fps:.3f} fps",
          flush=True)
    print(f"launches: K1 {n1} (want {62 * nfr}), K2 {n2} "
          f"(want {3 * (nfr - 1)}); md5 {md5} (golden {golden['md5']})",
          flush=True)
    if n1 != 62 * nfr or n2 != 3 * (nfr - 1):
        raise AssertionError("the slice did not run through K1/K2 as "
                             "expected")
    if md5 != golden["md5"] or len(stream) != golden["total_bytes"]:
        raise AssertionError("stream differs from x265_tpu's golden")

    print(json.dumps({"kernels": [
        dict(name="K1 ctu_step", route="cuda",
             source="x265_tpu_torch/csrc/k1_ctu_step.cu",
             replaces="x265_tpu/encoder/ctu_scan_pallas.py:72",
             launches=n1, max_abs_err=max(k1["I"][2], k1["P"][2]),
             ms=k1["P"][0], plain_ms=k1["P"][1]),
        dict(name="K2 subpel_refine", route="cuda",
             source="x265_tpu_torch/csrc/k2_subpel_refine.cu",
             replaces="x265_tpu/encoder/me_pallas.py:71",
             launches=n2, max_abs_err=k2[2], ms=k2[0], plain_ms=k2[1])]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
