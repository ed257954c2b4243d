"""A seeded sample of a run's CTU-step (K1) and subpel-refine (K2) calls,
recorded for the check, and the check itself.

``StepRecorder.install`` wraps the port's two step seams before the
encoder builds its pipelines: ``ctu_scan_cuda.ctu_step`` (one wavefront
level: K1 on the card, the plain step elsewhere) and the refine's two
paths, ``me_cuda.launch`` (K2) and ``me_cuda.refine_plain``.  The calls
are grouped by shape (K1: intra or inter, the frames and lanes a call
carries, with or without the split; K2: the blocks a call carries and its
lambdas), and each group keeps a uniform sample of its calls over the
whole run, warm-up and flush included (reservoir sampling with a
generator drawn from the seed), so a run checks every shape it drove.  A
kept call's inputs are cloned on the device before it runs and its
outputs after, without a host synchronisation.

``differing`` runs the benchmark's frozen plain copies of the two steps
(``refenc``) on each kept call's inputs, with the settings that the
stream's parameter sets and the configuration give, and counts the output
elements that differ: the modes, splits, levels and reconstruction of K1,
the vectors, predictions and costs of K2.
"""

from __future__ import annotations

import importlib
import random

import torch

from .content import sub_seed

PACKAGE = "x265_tpu_torch"


def _clone(v):
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, (tuple, list)):
        return type(v)(_clone(x) for x in v)
    if isinstance(v, dict):
        return {k: _clone(x) for k, x in v.items()}
    return v


class StepRecorder:
    """Keeps ``k1_keep`` calls of each K1 shape and ``k2_keep`` of each
    K2 shape."""

    def __init__(self, seed: int, k1_keep: int, k2_keep: int):
        self.rng = random.Random(sub_seed(seed, "steps"))
        self.keep = dict(k1=k1_keep, k2=k2_keep)
        self.seen = {}      # (kind, shape) -> calls so far
        self.kept = {}      # (kind, shape) -> [record]

    def _slot(self, key):
        """The reservoir slot of this call, or None."""
        n = self.seen.get(key, 0) + 1
        self.seen[key] = n
        kept = self.kept.setdefault(key, [])
        if len(kept) < self.keep[key[0]]:
            kept.append(None)
            return len(kept) - 1
        j = self.rng.randrange(n)
        return j if j < len(kept) else None

    def install(self):
        """Wrap the seams; returns the function that puts them back."""
        k1 = importlib.import_module(f"{PACKAGE}.encoder.ctu_scan_cuda")
        k2 = importlib.import_module(f"{PACKAGE}.encoder.me_cuda")
        undo = []

        def patch(owner, attr, new):
            undo.append((owner, attr, getattr(owner, attr)))
            setattr(owner, attr, new)

        ctu_step = k1.ctu_step

        def k1_step(scan, inter, decide32, carry, xs, plain):
            key = ("k1", (bool(inter), int(carry[0].shape[0]),
                          int(xs["cx"].shape[0]), "rqt_ok" in xs))
            slot = self._slot(key)
            if slot is None:
                return ctu_step(scan, inter, decide32, carry, xs, plain)
            rec = dict(carry=_clone(carry), xs=_clone(xs))
            carry, ys = ctu_step(scan, inter, decide32, carry, xs, plain)
            rec.update(carry_out=_clone(carry), ys=_clone(ys))
            self.kept[key][slot] = rec
            return carry, ys
        patch(k1, "ctu_step", k1_step)

        def k2_wrap(fn, lead):
            def refine(*a):
                args = a[lead:]
                W, lam = args[0], args[4]
                key = ("k2", (int(W.shape[0]),
                              int(torch.as_tensor(lam).numel())))
                slot = self._slot(key)
                if slot is None:
                    return fn(*a)
                rec = dict(args=_clone(args[:5]))
                out = fn(*a)
                rec["out"] = _clone(out)
                self.kept[key][slot] = rec
                return out
            return refine
        patch(k2, "launch", k2_wrap(k2.launch, 1))
        patch(k2, "refine_plain", k2_wrap(k2.refine_plain, 0))

        def restore():
            for owner, attr, orig in reversed(undo):
                setattr(owner, attr, orig)
        return restore

    def records(self, kind: str) -> list:
        return [(key[1], r) for key, rs in sorted(self.kept.items())
                if key[0] == kind for r in rs if r is not None]


def _count(a, b) -> int:
    """Elements of ``b`` (the program's) that ``a`` (the reference's) does
    not reproduce; a missing or misshapen output counts whole."""
    if a is None and b is None:
        return 0
    if a is None or b is None:
        return int((a if b is None else b).numel())
    if tuple(a.shape) != tuple(b.shape):
        return int(max(a.numel(), b.numel()))
    a = a.to(b.device)
    if a.dtype.is_floating_point or b.dtype.is_floating_point:
        return int((a.float() != b.float()).sum())
    return int((a.long() != b.long()).sum())


def differing(recorder: StepRecorder, settings, inter_pictures: bool,
              log: list | None = None, low_precision: bool = False) -> dict:
    """{"k1_outputs_differing", "k2_outputs_differing"}: output elements
    of the kept calls that the reference steps do not reproduce from the
    same inputs.  ``log`` gets (kind, shape, calls kept, elements
    compared) per shape."""
    from .refenc.refine import refine
    from .refenc.step import make_step
    has32 = settings.log2_ctb >= 5
    out = dict(k1_outputs_differing=0, k2_outputs_differing=0)
    steps = {}
    stats = {}
    for shape, r in recorder.records("k1"):
        xs = r["xs"]
        inter, rqt = "inter" in xs, "rqt_ok" in xs
        if (inter, rqt) not in steps:
            steps[inter, rqt] = make_step(settings, inter, has32, rqt,
                                          low_precision)
        with torch.no_grad():
            carry, ys = steps[inter, rqt](_clone(r["carry"]), xs)
        n = sum(_count(a, b) for a, b in zip(carry, r["carry_out"]))
        n += sum(_count(a, b) for a, b in zip(ys, r["ys"]))
        out["k1_outputs_differing"] += n
        s = stats.setdefault(("k1", shape), [0, 0])
        s[0] += 1
        s[1] += sum(int(b.numel()) for b in tuple(r["carry_out"])
                    + tuple(r["ys"]) if b is not None)
    mrq = max(1, min(64, settings.me_range))
    for shape, r in recorder.records("k2"):
        W, ob, mvi, pmv, lam = r["args"]
        with torch.no_grad():
            got = refine(W, ob, mvi, pmv, lam, settings.subme, mrq,
                         settings.bit_depth, low_precision)
        out["k2_outputs_differing"] += sum(
            _count(a, b) for a, b in zip(got, r["out"]))
        s = stats.setdefault(("k2", shape), [0, 0])
        s[0] += 1
        s[1] += sum(int(b.numel()) for b in r["out"])
    # a run whose calls never reached the seams checked nothing: that
    # reads as one element differing (a stream with only I pictures runs
    # no K2)
    if not recorder.records("k1"):
        out["k1_outputs_differing"] += 1
    if not recorder.records("k2") and inter_pictures:
        out["k2_outputs_differing"] += 1
    if log is not None:
        log.extend([k, list(sh), n, m] for (k, sh), (n, m) in stats.items())
    return out
