"""Weighted-prediction analysis (x265 weightPrediction.cpp:222 weightAnalyse).

Luma (scale, offset) estimation for P slices, gated the way the
reference gates it: the candidate weight is only enabled when the
weighted reference predicts the frame better than the plain reference
*after motion compensation* (weightPrediction.cpp:444 compares costs on
the lowres MC'd plane).  Without the MC step a zero-MV comparison —
or a global-moments fit — misfires on ordinary displaced content and
the least-squares fit collapses toward a constant plane, wrecking
P-frame quality (the round-3 regression).

Pipeline (host numpy, on 4x-subsampled source planes — the same cost
class as the reference's lowres analysis):
  1. cheap moments pre-gate: identical global mean AND std => no fade,
     return unity immediately (most frames).
  2. block motion compensation of the subsampled reference (8x8 blocks,
     full search +-4 subsampled pels = +-16 full-pel reach).
  3. least-squares (scale, offset) fit of cur against the MC'd ref.
  4. decisive gate: the weighted MC'd SAD must beat the unweighted
     MC'd SAD by >= 1/64 — on misaligned or plain-motion content a
     global scale/offset cannot clear this bar, so the weight stays off.

The per-pixel weighted MC itself stays on device
(device_pipeline.build_p_pipeline); denominator fixed at 6 (w = 64 ==
unity), matching x265's default luma denom.
"""

from __future__ import annotations

import numpy as np

LUMA_DENOM = 6


def _block_mc(c: np.ndarray, r_search: np.ndarray, r_pick: np.ndarray,
              bs: int = 8, sr: int = 4):
    """Motion-compensate toward ``c``: per-``bs``-block full search of
    +-``sr`` pels against ``r_search`` (a brightness-matched reference,
    so fades do not bias the match), returning pixels picked at the
    winning displacements from ``r_pick`` (the original reference, so
    the subsequent fit sees unweighted pixels).  Returns (c_crop, mc)
    cropped to a block multiple."""
    H = (c.shape[0] // bs) * bs
    W = (c.shape[1] // bs) * bs
    if H == 0 or W == 0:                  # degenerate tiny planes
        return c, r_pick[:c.shape[0], :c.shape[1]]
    c = c[:H, :W]
    rs = np.pad(r_search, sr, mode="edge")
    rp = np.pad(r_pick, sr, mode="edge")
    nby, nbx = H // bs, W // bs
    n_off = 2 * sr + 1
    search = np.stack([rs[dy:dy + H, dx:dx + W]
                       for dy in range(n_off) for dx in range(n_off)])
    diffs = np.abs(c[None] - search)
    costs = diffs.reshape(-1, nby, bs, nbx, bs).sum(axis=(2, 4))
    idx = costs.argmin(axis=0)            # [nby, nbx]
    pick = np.stack([rp[dy:dy + H, dx:dx + W]
                     for dy in range(n_off) for dx in range(n_off)])
    picked = np.take_along_axis(
        pick.reshape(n_off * n_off, nby, bs, nbx, bs),
        idx[None, :, None, :, None], axis=0)[0]
    return c, picked.reshape(H, W)


def analyse_luma_weight(cur_y: np.ndarray, ref_y: np.ndarray,
                        bit_depth: int = 8):
    """(w, offset, enabled): explicit L0 luma weight for a P frame.

    w is in 1/64 units (denom 6), offset in 8-bit-domain pixel units
    (§7.4.7.3 ranges: w-64 and offset each in [-128, 127]).  Returns
    (64, 0, False) when weighting does not beat the plain MC'd
    reference.
    """
    c = cur_y[::4, ::4].astype(np.float64)
    r = ref_y[::4, ::4].astype(np.float64)
    sc = 1 << (bit_depth - 8)
    # moments pre-gate: a fade moves the global mean and/or contrast.
    # Pure motion on wrap/edge content can also move them slightly, so
    # this is only the cheap early-out — the decisive gate is the MC'd
    # SAD comparison below (x265 weightPrediction.cpp:444).
    dm = (c.mean() - r.mean()) / sc
    dsd = (c.std() - r.std()) / sc
    if abs(dm) < 0.5 and abs(dsd) < 0.5:
        return 64, 0, False
    # moment-matched initial estimate (motion-invariant: global mean/std
    # do not move under displacement) brightness-normalizes the MC
    # search, so a fade does not bias the block matching toward
    # darker/brighter regions
    s0 = c.std() / max(r.std(), 1e-3)
    o0 = c.mean() - s0 * r.mean()
    cm, mc = _block_mc(c, s0 * r + o0, r)
    vr = mc.var()
    if vr < 1.0:                          # flat reference: offset-only fit
        scale = 1.0
    else:
        scale = float(((cm - cm.mean()) * (mc - mc.mean())).mean() / vr)
    w = int(round(scale * 64))
    w = max(-64, min(127, w))
    off = float(cm.mean() - (w * mc.mean()) / 64.0) / sc
    o = int(round(off))
    o = max(-128, min(127, o))
    if w == 64 and o == 0:
        return 64, 0, False
    # decisive gate: weighted vs unweighted SAD on the MC'd pairs
    maxv = (1 << bit_depth) - 1
    wmc = np.clip(np.floor(mc * w / 64.0 + 0.5) + o * sc, 0, maxv)
    sad_un = np.abs(cm - mc).sum()
    sad_w = np.abs(cm - wmc).sum()
    if sad_w >= sad_un - sad_un / 64.0:
        return 64, 0, False
    return w, o, True
