"""Where one launch of K1 spends its time, stage by stage, on one GPU.

    python3 tools/profile_k1_stages.py [--out k1_stages.json]

Builds the kernel sources a second time with ``-DK1_STAGE_CLOCKS``, which
makes every block barrier of K1 also stamp its source line and
``clock64()``.  Takes the busiest wavefront level of ``chip_smoke.py``'s
seeded 1080p scan inputs (psy-rd 2.0), I and P, and launches K1 on it:
  * the one-launch time of the normal build and of the stamped build (CUDA
    events; the difference is what the stamps cost);
  * per barrier line of ``x265_tpu_torch/csrc/k1_ctu_step.cuh``, the cycles
    spent in the stage that ends there (summed over the CTU's passes
    through that line, averaged over the level's real lanes), the number
    of passes, and the share of the lane's cycles.
Prints a table per configuration and, with ``--out``, writes the numbers,
with the card's name and power limit, as JSON.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SRC = os.path.join(ROOT, "x265_tpu_torch", "csrc", "k1_ctu_step.cuh")
STAMPS, STAMP_BLOCKS = 1024, 16     # K1_STAMPS, K1_STAMP_BLOCKS in SRC


def _label(src, line):
    """A short description of the stage that ends at barrier ``line``."""
    if line == 0:
        return "launch to the lane's start"
    if line == -1:
        return "outputs (after the last barrier)"
    for k in range(line - 2, max(line - 40, 0), -1):
        text = src[k].strip()
        if text.startswith(("for (", "//", "k1_prep3", "if (")) or "//" in text:
            return text[:70]
    return ""


def _stage_table(lines, clocks, real):
    """Cycles per barrier line, averaged over the real lanes."""
    per_line, passes = defaultdict(float), defaultdict(int)
    totals = []
    for b in real:
        row_l = lines[b * STAMPS:(b + 1) * STAMPS]
        row_t = clocks[b * STAMPS:(b + 1) * STAMPS]
        end = list(row_l).index(-1)
        for i in range(1, end + 1):
            per_line[int(row_l[i])] += float(row_t[i] - row_t[i - 1]) / len(real)
            if b == real[0]:
                passes[int(row_l[i])] += 1
        totals.append(float(row_t[end] - row_t[0]))
    return per_line, passes, totals


def main():
    import numpy as np
    import torch

    import chip_smoke
    from x265_tpu_torch import build
    from x265_tpu_torch.encoder import ctu_scan_cuda

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the numbers here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_k1_stages: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    lib = build.load_library()
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    clib = build._bind(build._build(
        [nvcc], build.NVCC_FLAGS + ["-DK1_STAGE_CLOCKS"], "sm90a_clocks"))
    clib.k1_stage_clocks.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    clib.k1_stage_clocks.restype = ctypes.c_int
    with open(SRC) as f:
        src = f.read().splitlines()

    scan, li, n_real, run = chip_smoke.k1_inputs(dev)
    report = dict(device=smi, level=li, real_lanes=n_real, configs={})
    for cfg in ("I", "P"):
        is_p = cfg == "P"
        _, lvl = chip_smoke._capture_level(li, lambda: run(cfg, "kernel"))
        xs, carry0 = lvl["xs"], lvl["carry"]
        real = [b for b, cx in enumerate(xs["cx"].tolist())
                if cx < scan.t["geom"].ctbs_w and b < STAMP_BLOCKS]
        ms = {name: chip_smoke.k1_launch_ms(lb, scan, is_p, xs, carry0, 20)
              for name, lb in (("normal", lib), ("stamped", clib))}
        # one clean stamped launch on the level's own carry
        ck = tuple(c.clone() for c in carry0)
        kargs, _ys = ctu_scan_cuda.kernel_args(scan, is_p, True, ck, xs)
        if clib.k1_ctu_step(*kargs) != 0:
            raise RuntimeError("stamped K1 launch failed")
        torch.cuda.synchronize()
        lines = np.zeros(STAMP_BLOCKS * STAMPS, np.int32)
        clocks = np.zeros(STAMP_BLOCKS * STAMPS, np.int64)
        rc = clib.k1_stage_clocks(lines.ctypes.data, clocks.ctypes.data)
        if rc != 0:
            raise RuntimeError(f"reading the stage clocks failed: rc {rc}")
        per_line, passes, totals = _stage_table(lines, clocks, real)
        total = sum(per_line.values())
        print(f"K1 {cfg}: level {li}, {len(real)} real lanes: one launch "
              f"{ms['normal']:.4f} ms, stamped {ms['stamped']:.4f} ms; lane "
              f"cycles mean {np.mean(totals):.0f}, max {max(totals):.0f}",
              flush=True)
        rows = []
        for line in sorted(per_line, key=lambda k: -per_line[k]):
            rows.append(dict(line=line, passes=passes[line],
                             cycles=per_line[line],
                             share=per_line[line] / total,
                             stage=_label(src, line)))
            print(f"  :{line:<5} x{passes[line]:<3} {per_line[line]:10.0f} cyc "
                  f"{100 * per_line[line] / total:5.1f}%  {rows[-1]['stage']}",
                  flush=True)
        report["configs"][cfg] = dict(ms=ms["normal"], ms_stamped=ms["stamped"],
                                      lane_cycles=totals, stages=rows)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
