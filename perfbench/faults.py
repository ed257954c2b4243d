"""Faults planted in the program, to show that the check catches them.

Each function plants one fault by patching the port before its encoder
is built and returns the function that takes it out again.

* ``control``: the control run.  The encoder's RD costs are float32
  (the reconstruction itself is integer-exact); the control puts the
  benchmark's own reference steps (``refenc``) in the place of K1 and K2
  with every RD cost computed in bfloat16, the precision below, and the
  reference's SAO statistics (``refenc.sao``) in the place of the
  encoder's, with each SAO cost (the filter stage's fused multiply-adds)
  rounded to bfloat16.
* ``deblock_skipped``: the configurations' guarantee that every picture
  decodes to the reconstruction whose MD5 its hash SEI carries, broken the
  way a later change might be tempted to: the deblocking filter is left
  out of the encoder's own reconstruction while the stream still signals
  it.
* ``state_unchanged``: each CTU-scan step (K1 on the card) returns the
  wavefront's carry as it got it.
* ``half_dropped``: every second AU that the encoder finishes
  (``Encoder._finish_one``, on every path) comes back empty;
* ``sao_skipped``: the SAO decision finds no gain anywhere (every
  option's distortion change 0), so every CTB's SAO is off while the
  slices still enable it: a stream that decodes to its own MD5, with SAO's
  work left out;
* ``token_altered``: one byte of each picture's slice data is altered
  where the entropy coder produces it;
* ``scenecut_missed``: the lookahead never reports a scene cut (a fault
  of the configurations with scene-cut detection).
"""

from __future__ import annotations

import dataclasses
import importlib

PACKAGE = "x265_tpu_torch"


def _patch(mod: str, owner: str | None, attr: str, make):
    m = importlib.import_module(f"{PACKAGE}.{mod}")
    o = getattr(m, owner) if owner else m
    orig = getattr(o, attr)
    setattr(o, attr, make(orig))
    return lambda: setattr(o, attr, orig)


def control():
    import torch

    from .refenc import sao
    from .refenc.refine import refine
    from .refenc.settings import StepSettings
    from .refenc.step import make_step
    steps = {}

    def k1(orig):
        def step(scan, inter, decide32, carry, xs, plain):
            key = (id(scan), inter, decide32, "rqt_ok" in xs)
            if key not in steps:
                g = scan.geom
                s = StepSettings(
                    width=g.width, height=g.height, log2_ctb=g.log2_ctb,
                    bit_depth=scan.bit_depth, sign_hide=scan.sign_hide,
                    strong_intra_smoothing=scan.strong, rdoq=scan.rdoq,
                    noise_reduction=scan.noise_reduction,
                    psy_rd=scan.psy_rd, psy_rdoq=scan.psy_rdoq, subme=0,
                    me_range=0)
                steps[key] = make_step(s, inter, decide32, key[3], True)
            return steps[key](carry, xs)
        return step

    def k2(orig, lead):
        def ref(*a):
            W, ob, mvi, pmv, lam, subme, mrq = a[lead:lead + 7]
            bd = a[lead + 7] if len(a) > lead + 7 else 8
            return refine(W, ob, mvi, pmv, lam, subme, mrq, bd, True)
        return ref

    def sao_estimate(orig):
        def est(o, rec, ctbs_h, ctbs_w, ctb, eo_valid, inside,
                bit_depth=8):
            h, w = int(inside[:, 0].sum()), int(inside[0].sum())
            dist, offs, pos, bits = sao.estimate(
                o[:h, :w].cpu().numpy(), rec[:h, :w].cpu().numpy(), ctb,
                bit_depth)

            def dev(x, dtype):
                return torch.from_numpy(x.reshape(
                    ctbs_h, ctbs_w, *x.shape[1:])).to(rec.device, dtype)
            return (dev(dist, torch.float32), dev(offs, torch.float32),
                    dev(pos, torch.int32), dev(bits, torch.float32))
        return est

    def bf16_fma(orig):
        return lambda a, b, c: orig(a, b, c).to(torch.bfloat16).float()

    undo = [_patch("encoder.device_pipeline", None, "sao_estimate_plane",
                   sao_estimate),
            _patch("encoder.device_pipeline", None, "fma32", bf16_fma),
            _patch("encoder.ctu_scan_cuda", None, "ctu_step", k1),
            _patch("encoder.me_cuda", None, "launch",
                   lambda orig: k2(orig, 1)),
            _patch("encoder.me_cuda", None, "refine_plain",
                   lambda orig: k2(orig, 0))]
    return lambda: [u() for u in reversed(undo)]


def deblock_skipped():
    return _patch("encoder.device_pipeline", None, "deblock_picture",
                  lambda orig: lambda planes, *a, **k: planes)


def state_unchanged():
    def make(orig):
        def step(scan, inter, decide32, carry, xs, plain):
            kept = tuple(c.clone() for c in carry)
            _, ys = orig(scan, inter, decide32, carry, xs, plain)
            return kept, ys
        return step
    return _patch("encoder.ctu_scan_cuda", None, "ctu_step", make)


def half_dropped():
    def make(orig):
        def finish(self, pend):
            ef = orig(self, pend)
            n = getattr(self, "_fault_count", 0)
            self._fault_count = n + 1
            return ef if n % 2 == 0 else dataclasses.replace(ef, au=b"")
        return finish
    return _patch("encoder.intra_encoder", "Encoder", "_finish_one", make)


def sao_skipped():
    def make(orig):
        def est(*a, **k):
            dist, offs, pos, bits = orig(*a, **k)
            return dist * 0, offs, pos, bits
        return est
    return _patch("encoder.device_pipeline", None, "sao_estimate_plane",
                  make)


def token_altered():
    def make(orig):
        def entropy(self, *a, **k):
            nal = orig(self, *a, **k)
            i = len(nal) * 3 // 4
            return nal[:i] + bytes([nal[i] ^ 0x10]) + nal[i + 1:]
        return entropy
    return _patch("encoder.intra_encoder", "Encoder", "_entropy_encode",
                  make)


def scenecut_missed():
    def make(orig):
        def pop(self):
            out = orig(self)
            return out[:3] + (False,) + out[4:]
        return pop
    return _patch("encoder.lookahead", "Lookahead", "_pop", make)


FAULTS = dict(control=control, deblock_skipped=deblock_skipped,
              state_unchanged=state_unchanged,
              half_dropped=half_dropped,
              sao_skipped=sao_skipped, token_altered=token_altered,
              scenecut_missed=scenecut_missed)

