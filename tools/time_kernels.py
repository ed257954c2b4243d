"""One-launch times of K1 and K2 at the 1080p shapes for a checkout, so
that two commits can be compared in one call on one card:

    python3 tools/time_kernels.py [CHECKOUT] [--label NAME]

CHECKOUT (default: this one) supplies the kernels' sources and the
``chip_smoke.py`` helpers that make the inputs and time the launches, so an
older commit unpacked with ``git archive`` is timed with its own code.
K1: the busiest level of ``chip_smoke.k1_inputs``'s random 1080p scan (P,
psy-rd 2.0, one frame, 15 lanes), each launch alone on a fresh copy of the
level's carry, 50 launches.  K2: B = 8160, subme 2, merange 57, on
``chip_smoke.k2_case``'s random set, three runs of 50 launches.  Prints
the card's name and power limit and ptxas's register report.
"""

import argparse
import os
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("checkout", nargs="?", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.checkout)
    label = args.label or root
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA device")
    import chip_smoke
    from x265_tpu_torch import build
    from x265_tpu_torch.encoder import me_cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{label}: {smi}", flush=True)
    dev = torch.device("cuda")
    lib = build.load_library()
    for line in build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            print(f"{label} ptxas: {line.strip()}", flush=True)
    scan, li, _n, go = chip_smoke.k1_inputs(dev)
    _out, lvl = chip_smoke._capture_level(li, lambda: go("P", "kernel"))
    ms = chip_smoke.k1_launch_ms(lib, scan, True, lvl["xs"], lvl["carry"],
                                 50)
    print(f"{label} K1 P level {li} L={lvl['xs']['cx'].shape[0]}: "
          f"{ms:.4f} ms", flush=True)
    W, ob, mvi, pmv, lam = chip_smoke.k2_case("random", 8160, 57, 2, dev)
    for _ in range(3):
        ms = chip_smoke._events_ms(lambda: me_cuda.launch(
            lib, W, ob, mvi, pmv, lam, 2, 57), 50)
        print(f"{label} K2 B=8160: {ms:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
