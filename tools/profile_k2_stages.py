"""Where one launch of K2 spends its time, stage by stage, on one GPU.

    python3 tools/profile_k2_stages.py [--out k2_stages.json]

Builds the kernel sources a second time with ``-DK2_STAGE_CLOCKS``, which
makes every block barrier of K2 also stamp its source line and
``clock64()``, and each block its SM.  On ``chip_smoke.py``'s random 1080p
set (B = 8160, subme 2, merange 57) it reports:
  * the one-launch time of the normal build and of the stamped build (CUDA
    events; the difference is what the stamps cost);
  * per barrier line of ``x265_tpu_torch/csrc/k2_subpel_refine.cu``, the
    cycles of the stage that ends there, averaged over the blocks, and its
    share of a block's cycles;
  * a block's cycles from start to end (mean and max), the blocks resident
    on an SM at once (mean over the launch), and the launch's length in
    blocks' cycles on the busiest SM.
Prints a table and, with ``--out``, writes the numbers, with the card's
name and power limit, as JSON.
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
SRC = os.path.join(ROOT, "x265_tpu_torch", "csrc", "k2_subpel_refine.cu")
STAMPS, STAMP_BLOCKS = 8, 8192     # K2_STAMPS, K2_STAMP_BLOCKS in SRC


def _label(src, line):
    """The comment or statement above barrier ``line``, shortened."""
    if line == 0:
        return "launch to the block's start"
    if line == -1:
        return "to the block's end (argmin, output)"
    for k in range(line - 2, max(line - 12, 0), -1):
        text = src[k].strip()
        if text and not text.startswith("}"):
            return text[:70]
    return ""


def main():
    import numpy as np
    import torch

    import chip_smoke
    from x265_tpu_torch import build
    from x265_tpu_torch.encoder import me_cuda

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the numbers here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_k2_stages: no CUDA device", file=sys.stderr)
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
        [nvcc], build.NVCC_FLAGS + ["-DK2_STAGE_CLOCKS"], "sm90a_k2clocks"))
    clib.k2_stage_clocks.argtypes = [ctypes.c_void_p] * 3
    clib.k2_stage_clocks.restype = ctypes.c_int
    with open(SRC) as f:
        src = f.read().splitlines()

    B, mrq = 8160, 57
    W, ob, mvi, pmv, lam = chip_smoke.k2_case("random", B, mrq, 2, dev)
    ms = {name: chip_smoke._events_ms(
        lambda lb=lb: me_cuda.launch(lb, W, ob, mvi, pmv, lam, 2, mrq), 20)
        for name, lb in (("normal", lib), ("stamped", clib))}
    me_cuda.launch(clib, W, ob, mvi, pmv, lam, 2, mrq)
    torch.cuda.synchronize()
    lines = np.zeros(STAMP_BLOCKS * STAMPS, np.int32)
    clocks = np.zeros(STAMP_BLOCKS * STAMPS, np.int64)
    sms = np.zeros(STAMP_BLOCKS, np.int32)
    rc = clib.k2_stage_clocks(lines.ctypes.data, clocks.ctypes.data,
                              sms.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"reading the stage clocks failed: rc {rc}")
    n = min(B, STAMP_BLOCKS)
    lines = lines[:n * STAMPS].reshape(n, STAMPS)
    clocks = clocks[:n * STAMPS].reshape(n, STAMPS)
    per_line = defaultdict(float)
    totals, spans = [], defaultdict(list)
    for b in range(n):
        end = list(lines[b]).index(-1)
        for i in range(1, end + 1):
            per_line[int(lines[b, i])] += float(clocks[b, i]
                                                - clocks[b, i - 1]) / n
        totals.append(float(clocks[b, end] - clocks[b, 0]))
        spans[int(sms[b])].append((int(clocks[b, 0]), int(clocks[b, end])))
    # clock64 is per SM: residency and the launch's length within each SM
    resident, lengths = [], []
    for sm, sp in spans.items():
        t0 = min(a for a, _ in sp)
        t1 = max(e for _, e in sp)
        lengths.append(t1 - t0)
        resident.append(sum(e - a for a, e in sp) / max(t1 - t0, 1))
    total = sum(per_line.values())
    print(f"K2 B={B} subme 2 merange {mrq}: one launch {ms['normal']:.4f} ms,"
          f" stamped {ms['stamped']:.4f} ms; block cycles mean "
          f"{np.mean(totals):.0f}, max {max(totals):.0f}; blocks resident "
          f"on an SM {np.mean(resident):.2f}; busiest SM "
          f"{max(lengths)} cycles, {max(len(s) for s in spans.values())} "
          f"blocks", flush=True)
    rows = []
    for line in sorted(per_line, key=lambda k: -per_line[k]):
        rows.append(dict(line=line, cycles=per_line[line],
                         share=per_line[line] / total,
                         stage=_label(src, line)))
        print(f"  :{line:<5} {per_line[line]:10.0f} cyc "
              f"{100 * per_line[line] / total:5.1f}%  {rows[-1]['stage']}",
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(device=smi, ms=ms["normal"],
                           ms_stamped=ms["stamped"], block_cycles=totals,
                           resident=float(np.mean(resident)),
                           busiest_sm_cycles=max(lengths), stages=rows), f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
