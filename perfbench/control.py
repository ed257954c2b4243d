"""Readings of the check on many seeds in one process: the program as it
is, the control, or a planted fault (``faults.FAULTS``).

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 \
        --seconds 8 [--fault <name in faults.FAULTS>] [--warmup N] \
        [--out readings.jsonl]

Each seed is one run of the cell (a short window at the cell's own sizes
and load) and prints one JSON line: the seed, the fault, ``correct``, the
window's fps and every number compared.  ``--warmup`` codes N frames
before the window (``gop_parallel``: N frames of each GOP) instead of the
traffic's ``warmup_frames`` (the control runs the reference steps in
the program's place, some seconds a frame).  The
benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--fault", default="none")
    ap.add_argument("--out", default=None)
    ap.add_argument("--warmup", type=int, default=None)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from perfbench import faults, harness
    fault = None if args.fault == "none" else faults.FAULTS[args.fault]
    over = (None if args.warmup is None
            else {"traffic": {"warmup_frames": args.warmup}})
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        try:
            res = harness.run_cell(args.workload, seed, args.seconds, False,
                                   t0, fault=fault, overrides=over)
            line = dict(seed=seed, fault=args.fault, correct=res["correct"],
                        fps=res["metrics"].get("fps", {}).get("value"),
                        checks={k: v["value"]
                                for k, v in res["checks"].items()},
                        seconds=time.perf_counter() - t0)
        except Exception as exc:  # a fault that crashes the run has failed
            traceback.print_exc()
            line = dict(seed=seed, fault=args.fault, correct=False,
                        error=repr(exc)[:500])
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
