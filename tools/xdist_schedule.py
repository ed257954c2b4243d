"""Replay pytest-xdist's ``--dist loadfile`` schedule from a junit XML.

    python3 tools/xdist_schedule.py RUN.xml [--workers 6] [--drop TEXT]
                                    [--until SECONDS] [--show]

Reads the per-test times of a tier-1 run (``--junitxml``) and replays how
xdist 3.x hands test files to the workers: files are queued by their
number of tests, most first (ties in collection order), every worker gets
one file, then another while it has at most two tests left, and each
worker runs its tests one after another.  Prints the replayed wall (test
time only: the run's own wall adds collection and start-up) and, with
``--show``, each worker's files with their start times.  ``--drop TEXT``
replays the run without the files whose module name contains TEXT, e.g.
``--drop test_torch_`` for the schedule of the JAX package's tests alone.
``--until SECONDS`` also prints how many tests the replay has finished by
then (what a run cut at that time limit would count, before start-up).
"""

import argparse
import collections
import xml.etree.ElementTree as ET


def load(path):
    """{module: [test seconds, in the run's order]} from a junit XML."""
    files = collections.OrderedDict()
    for tc in ET.parse(path).getroot().iter("testcase"):
        module = ".".join(tc.get("classname").split(".")[:2])
        files.setdefault(module, []).append(float(tc.get("time", 0)))
    return files


def replay(files, workers=6):
    """The replayed wall, per worker its (module, start) in order, and every
    test's end time."""
    queue = collections.deque(sorted(sorted(files),
                                     key=lambda f: -len(files[f])))
    pending = [collections.deque() for _ in range(workers)]
    clock = [0.0] * workers
    given = [[] for _ in range(workers)]
    start, ends = {}, []

    def assign(w):
        if queue:
            f = queue.popleft()
            given[w].append(f)
            pending[w].extend((f, t) for t in files[f])

    for w in range(workers):
        assign(w)
    for w in range(workers):
        if len(pending[w]) <= 2:
            assign(w)
    while any(pending):
        end, w = min((clock[w] + pending[w][0][1], w)
                     for w in range(workers) if pending[w])
        f, _t = pending[w].popleft()
        start.setdefault(f, clock[w])
        clock[w] = end
        ends.append(end)
        if len(pending[w]) <= 2:
            assign(w)
    return max(clock), [[(f, start[f]) for f in g] for g in given], ends


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("xml")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--drop", default=None)
    ap.add_argument("--until", type=float, default=None)
    ap.add_argument("--show", action="store_true")
    args = ap.parse_args()
    files = load(args.xml)
    if args.drop:
        files = {f: t for f, t in files.items() if args.drop not in f}
    wall, given, ends = replay(files, args.workers)
    work = sum(sum(t) for t in files.values())
    print(f"{len(files)} files, {sum(len(t) for t in files.values())} "
          f"tests, {work:.1f} s of test work: replayed wall {wall:.1f} s")
    if args.until is not None:
        print(f"  tests finished by {args.until:.0f} s: "
              f"{sum(e <= args.until for e in ends)}")
    if args.show:
        for w, g in enumerate(given):
            print(f"  worker {w}: " + ", ".join(
                f"{f.split('.')[-1]} @{s:.0f}" for f, s in g))


if __name__ == "__main__":
    main()
