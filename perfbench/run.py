"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared, with its limit.  The same numbers end standard error.
Without the CUDA devices the cell needs it exits non-zero and prints no
result; so it does if, once the run is over and just before the result
would be printed, ``sys.modules`` holds JAX, ``jaxlib``, ``flax`` or the
JAX package (``x265_tpu``), compared by whole top-level names.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None, root: str = ROOT, device: str = "cuda",
         overrides: dict | None = None) -> int:
    """One run; ``root``, ``device`` and ``overrides`` (a test's small
    sizes on the CPU) serve the benchmark's own tests."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # caches of the libraries below, at fixed paths inside the checkout
    cache = os.path.join(root, ".perfbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    if root not in sys.path:
        sys.path.insert(0, root)
    from perfbench import harness
    try:
        res = harness.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), T_START, root=root,
                               device=device, overrides=overrides)
    except harness.HarnessError as exc:
        print(f"perfbench: {exc}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print("perfbench: the run loaded " + ", ".join(found),
              file=sys.stderr)
        return 3
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
