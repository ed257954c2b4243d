"""GOP-parallel encoding on every card of the machine, against one card:

    python3 tools/gop_shards.py [--reps N]

Runs ``chip_smoke.py``'s phase 17 on the gop_parallel slice (24 frames as
8 closed IPPP GOPs of 3): one warm and one timed encode on cuda:0, then N
timed sharded encodes (default 2), each after its own warm encode, through
``check_gop_parallel_sharded``: one shard a card when the machine has two
or more (8 / D GOPs a shard), else two shards on cuda:0. Each run checks
the stream against ``golden_1080p_gop_parallel.json`` and the K1 / K2
launch counts, and prints the fps and each shard's round walls beside the
one-card run's. Prints every card's name and power limit first.
"""

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("gop_shards: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from x265_tpu_torch import build

    smi = " | ".join(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines())
    print(f"{smi}; {torch.cuda.device_count()} cards", flush=True)
    t0 = time.time()
    build.load_library()
    print(f"kernel build: {time.time() - t0:.1f} s", flush=True)
    _n1, _n2, fps, rounds = chip_smoke.check_gop_parallel(
        torch.device("cuda:0"), smi, 0.0)
    for _ in range(args.reps):
        chip_smoke.check_gop_parallel_sharded(smi, fps, rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
