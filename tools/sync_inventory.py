"""Every point where the encoder waits for the card, checked on the card.

    python3 tools/sync_inventory.py [--workload ultrafast-1080p.live]
                                    [--frames 48] [--warmup 12]
                                    [--seed 2718281828]

Encodes ``--frames`` frames of a benchmark cell's configuration and
traffic (``BENCHMARK.json``, ``perfbench/``) on the card after
``--warmup`` frames, with ``torch.cuda.set_sync_debug_mode("error")``
everywhere except inside the encoder's ``sync`` spans
(``x265_tpu_torch.trace.start(guard_syncs=True)``): a call that
synchronises the device anywhere else raises, and the script prints its
traceback and exits 1.  Otherwise it prints the ``sync`` spans a frame by
the span they were opened in, and exits 0.  Set-up (the first frames,
which build the pipelines and fill the constant tables) is outside the
check.  The CPU cannot run it: it shows no synchronisation.
"""

import argparse
import os
import subprocess
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="ultrafast-1080p.live")
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--warmup", type=int, default=12)
    ap.add_argument("--seed", type=int, default=2718281828)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("sync_inventory: no CUDA device")
    from perfbench import content, harness
    from x265_tpu_torch import trace
    from x265_tpu_torch.build import load_library
    from x265_tpu_torch.encoder.intra_encoder import Encoder

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    c = harness.find_cell(bench, ROOT, args.workload)
    params = harness.make_params(c.config)
    n = args.warmup + args.frames
    pool = content.generate(dict(c.traffic, pool_frames=n),
                            params.source_width, params.source_height,
                            args.seed, device="cuda")
    load_library()
    enc = Encoder(params, device="cuda")
    for planes in pool[:args.warmup]:
        enc.push_frame(planes)
    torch.cuda.synchronize()
    returned = 0
    trace.start(guard_syncs=True)
    try:
        for planes in pool[args.warmup:]:
            returned += len(enc.push_frame(planes))
    except RuntimeError:
        spans = trace.stop()
        traceback.print_exc()
        print(f"{smi}: a synchronisation outside the sync spans, after "
              f"{returned} AUs ({len(spans)} spans)")
        return 1
    spans = trace.stop()
    by_parent = {}
    for s in spans:
        if s[0] == "sync":
            p = spans[s[3]][0] if s[3] >= 0 else "no span"
            by_parent[p] = by_parent.get(p, 0) + 1
    total = sum(by_parent.values())
    print(f"{smi}: {args.workload}, {args.frames} frames pushed, "
          f"{returned} AUs, no synchronisation outside the sync spans; "
          f"sync spans a frame {total / max(1, returned):.2f}, by the span "
          f"they were opened in:")
    for k, v in sorted(by_parent.items(), key=lambda kv: -kv[1]):
        print(f"  {v / max(1, returned):8.2f}  {k}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
