"""The benchmark's frozen yardstick: the chip's peaks and the least time
each hand-written kernel of the port needs for one launch.

Copied from ``chip_smoke.py`` (``_bound``, ``_nbytes``,
``_butterfly_macs``, ``_tu_chain_macs``, ``k1_level_bound``,
``_k2_interp_ops``, ``k2_bound``) so that later changes to the program
cannot move it.  A bound is the larger of the bytes' time (every input
byte read once, every output byte written once, at the published HBM
bandwidth) and the operations' time at the rate of the pipe that does
them.  Two changes from the original:

* ``k2_bound`` finds round 2's candidates with the plain candidate
  selection copied below (the first half-pel round of the port's
  ``me_cuda.refine_plain``), not by calling the port, and it counts by
  ``subme``: 0 is the full-pel candidate alone, 1 the half-pel round, 2
  both rounds (the original counted both rounds for subme 1 and 2);
* a launch can be recorded while it runs (``k1_launch_record``,
  ``k2_launch_record``: shapes read on the host, device tensors kept by
  reference, nothing waits for the device) and its bound worked out later
  (``k1_record_bound``, ``k2_record_bound``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.7e12
DP2A_MAC_PER_S = 2 * INT32_OPS_PER_S
FP32_FLOPS_PER_S = 67e12
# RDOQ's float operations a coefficient (k1_rdoq_level and the passes after
# it; a fused multiply-add counts two): the dequant step 1; per candidate
# the reconstruction, error, square, scale 4 and the rate term's fma 2, 18
# for three; the first-minimum 4; the (y, x) group sums and the prefix sums
# of both costs 4; the prefix carries, the block total and the end cost
# (2 adds, a subtract, an add, an fma, the compare) 9 -- 36; psy-RDOQ on
# luma 3 more per candidate, 9
RDOQ_FLOPS = 36
PSY_FLOPS = 9


def _bound(nbytes, ops, ops_per_s):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _butterfly_macs(n):
    """Multiplies of one n-point HEVC core transform of one line through
    x265's partial butterflies: the odd half's (n/2)^2, then the even half
    as an n/2-point transform; 8 for n = 4."""
    return 8 if n == 4 else (n // 2) ** 2 + _butterfly_macs(n // 2)


def _tu_chain_macs(n):
    """Multiply-adds of one K1 chain: the forward and inverse 2-D
    transforms (two passes of n lines each) of a luma n x n block and of
    its two chroma n/2 x n/2 blocks."""
    def tu(m):
        return 4 * m * _butterfly_macs(m)
    return tu(n) + 2 * tu(n // 2)


# -- K1 -----------------------------------------------------------------------

def k1_launch_record(xs, ys, inter, scan) -> dict:
    """What the bound of one K1 launch of ``scan`` on level inputs ``xs``
    with outputs ``ys`` depends on: byte counts from the shapes, and the
    level's inter-block masks kept by reference (their sums are read
    later, so that recording waits for nothing)."""
    L = xs["cx"].shape[0]
    rqt = "rqt_ok" in xs
    t = scan.t
    has32 = t["has32"]
    ctb = 1 << t["geom"].log2_ctb
    ctbc = ctb // 2
    keys = ["cx", "cy", "m16", "qp_y", "qp_cb", "qp_cr", "l16_av", "c8_av",
            "lam", "plam"]
    keys += (["m32", "o32y", "o16cb", "o16cr", "l32_av", "c16_av",
              "quad_ok"] if has32 else ["o16y", "o8c"])
    if inter:
        keys += ["inter", "ipy", "ipc", "m32_in"]
    if rqt:
        keys += ["rqt_ok"]
    # per lane: reads 2 rows + 1 column + 1 corner of each plane's frontier,
    # writes 1 row + 1 column + 1 corner of each
    frontier = L * 4 * ((3 * ctb + 1) + (2 * ctb + 1) + 2 * (
        (3 * ctbc + 1) + (2 * ctbc + 1)))
    tables = 4 * 4 * 336     # K1's packed DCT matrices, one bulk copy
    if rqt:
        tables += 4 * 16     # and T4
    if scan.rdoq:
        tables += 4 * 2 * 64
    if scan.noise_reduction:
        tables += _nbytes([xs["nr_pack"]])
    nbytes = _nbytes([xs[k] for k in keys if k in xs]) + frontier + \
        tables + _nbytes([y for y in ys if y is not None])
    nr = scan.noise_reduction
    return dict(L=L, has32=has32, nq=t["n_quads"], spq=t["slots_per_quad"],
                nbytes=nbytes, rdoq=bool(scan.rdoq), nr=bool(nr),
                psy_rdoq=scan.psy_rdoq > 0,
                trials_mask=(xs["m32_in"] if inter and has32 and not nr
                             else None),
                trials_all=bool(inter and has32 and nr),
                splits_mask=xs["inter"] if rqt else None)


def k1_record_bound(rec: dict) -> tuple:
    """(milliseconds, "bytes" | "operations") of a recorded K1 launch: the
    multiply-adds of its transforms (per quad the 32x32 candidate and the
    16x16 slots, at CTB 16 one slot), the inter TU32 trials the level asks
    for, the RQT split's four 8x8 chains in each inter slot, at the dp2a
    rate; with RDOQ also its float operations at the float32 rate."""
    L, nq, spq, has32 = rec["L"], rec["nq"], rec["spq"], rec["has32"]
    if rec["trials_all"]:
        trials = L * nq
    elif rec["trials_mask"] is not None:
        trials = int(rec["trials_mask"].sum())
    else:
        trials = 0
    splits = (int(rec["splits_mask"].sum()) if rec["splits_mask"] is not None
              else 0)
    macs = (L * nq * ((_tu_chain_macs(32) if has32 else 0)
                      + spq * _tu_chain_macs(16))
            + trials * _tu_chain_macs(32) + splits * 4 * _tu_chain_macs(8))
    t_ops = macs / DP2A_MAC_PER_S
    if rec["rdoq"]:
        coefs = (L * nq * ((1536 if has32 else 0) + spq * 384) + trials * 1536
                 + splits * 384)
        luma = (L * nq * ((1024 if has32 else 0) + spq * 256) + trials * 1024
                + splits * 256)
        flops = coefs * RDOQ_FLOPS + (luma * PSY_FLOPS if rec["psy_rdoq"]
                                      else 0)
        t_ops = max(t_ops, flops / FP32_FLOPS_PER_S)
    t_bytes = rec["nbytes"] / HBM_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def k1_level_bound(xs, ys, inter, scan):
    """Bound of one K1 launch of ``scan`` on level inputs ``xs`` (the
    copied function, in one call)."""
    return k1_record_bound(k1_launch_record(xs, ys, inter, scan))


# -- K2 -----------------------------------------------------------------------

# nonzero taps of HEVC's 8-tap luma filter per quarter-pel phase (phase 0
# is the sample itself)
_LUMA_TAPS = ((3,), tuple(range(7)), tuple(range(8)), tuple(range(1, 8)))
_LUMA_FILTERS = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
], dtype=np.int32)
_DELTAS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
_MV_BITS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "mv_bits_f32.npy")


def _k2_interp_ops(cands, bd=8):
    """Instructions of K2's interpolation for one block's candidate qpel
    offsets ``cands`` (y, x): every horizontally filtered sample (window
    row, column, phase; two dp4a at 8 bits, four dp2a at 10) and every
    vertically filtered one (row, column, both phases; four dp2a) counted
    once, whichever candidates share it."""
    hs, vs = set(), set()
    for qy, qx in cands:
        iy1, ix1, fy, fx = (qy >> 2) + 1, (qx >> 2) + 1, qy & 3, qx & 3
        rows = {y + k for y in range(16) for k in _LUMA_TAPS[fy]}
        if fx:
            hs.update((iy1 + r, ix1 + x, fx) for r in rows for x in range(16))
        if fy:
            vs.update((iy1 + y, ix1 + x, fy, fx) for y in range(16)
                      for x in range(16))
    return (2 if bd == 8 else 4) * len(hs) + 4 * len(vs)


def _fma32(a, b, c):
    """float32 ``a * b + c`` rounded once (the port's ``_util.fma32``)."""
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32)
    c = torch.as_tensor(c, dtype=torch.float32).double()
    p = a.double() * b.double()
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    low = s.view(torch.int64) & ((1 << 29) - 1)
    tie = (low == (1 << 28)) & (err != 0)
    s = torch.where(tie, torch.nextafter(s, torch.where(
        err > 0, float("inf"), float("-inf")).to(s.dtype)), s)
    return s.float()


def _mc_luma(win, fx, fy, bd):
    """Pixel-domain 8-tap luma MC of [B, 23, 23] windows (16x16 blocks)."""
    filt = torch.as_tensor(_LUMA_FILTERS, device=win.device)
    hx, hy = filt[fx.long()], filt[fy.long()]
    w = win.to(torch.int32)
    tmp = sum(hx[:, k, None, None] * w[:, :, k:k + 16] for k in range(8))
    tmp = tmp >> (bd - 8)
    acc = sum(hy[:, k, None, None] * tmp[:, k:k + 16, :] for k in range(8))
    if bd == 8:
        return ((acc + 2048) >> 12).clamp(0, 255)
    shift1 = 14 - bd
    return (((acc >> 6) + (1 << (shift1 - 1))) >> shift1).clamp(
        0, (1 << bd) - 1)


def _satd(a, b):
    """Sum of the 4x4 Hadamard SATDs, (sum |H d H^T| + 1) >> 1 a block."""
    d = a.to(torch.int32) - b.to(torch.int32)
    B = d.shape[0]
    d = d.reshape(B, 4, 4, 4, 4).transpose(2, 3)

    def had4(x, dim):
        x0, x1, x2, x3 = x.unbind(dim)
        s01, d01 = x0 + x1, x0 - x1
        s23, d23 = x2 + x3, x2 - x3
        return torch.stack([s01 + s23, d01 + d23, s01 - s23, d01 - d23], dim)

    h = had4(had4(d, -1), -2)
    per = (h.abs().sum(dim=(-2, -1), dtype=torch.int32) + 1) >> 1
    return per.sum(dim=(-2, -1), dtype=torch.int32)


def half_pel_winner(W, ob, mvi, pmv, lam, mrq, bd=8):
    """The plain candidate selection of K2's first round: of the nine
    half-pel candidates around each block's full-pel winner (step 2 in
    quarter-pel), the one of least SATD + lam * mv bits, the first winning
    ties, candidates beyond 4 * ``mrq`` masked.  Returns q1 [B, 2]."""
    dev = W.device
    bits_t = torch.as_tensor(np.load(_MV_BITS), device=dev)
    big = torch.tensor(float(1 << 30), dtype=torch.float32, device=dev)
    lam = torch.as_tensor(lam, dtype=torch.float32, device=dev)
    best_c = best_q = None
    zero = torch.zeros_like(mvi)
    for dy, dx in _DELTAS:
        q = zero + torch.tensor((2 * dy, 2 * dx), dtype=mvi.dtype,
                                device=dev)
        oob = ((mvi * 4 + q).abs() > 4 * mrq).any(1)
        iy1 = (q[:, 0] >> 2) + 1
        ix1 = (q[:, 1] >> 2) + 1
        wr = torch.where(iy1[:, None, None] == 0, W[:, 0:23, :],
                         W[:, 1:24, :])
        win = torch.where(ix1[:, None, None] == 0, wr[:, :, 0:23],
                          wr[:, :, 1:24])
        pred = _mc_luma(win, q[:, 1] & 3, q[:, 0] & 3, bd)
        d = mvi * 4 + q - pmv
        bits = bits_t[d[:, 0].abs().long()] + bits_t[d[:, 1].abs().long()]
        c = _fma32(lam, bits, _satd(ob, pred).to(torch.float32))
        c = torch.where(oob, big, c)
        if best_c is None:
            best_c, best_q = c, q
        else:
            better = c < best_c
            best_c = torch.where(better, c, best_c)
            best_q = torch.where(better[:, None], q, best_q)
    return best_q


def k2_launch_record(W, ob, mvi, pmv, lam, outs, subme, mrq, bd) -> dict:
    """A K2 launch kept for its bound: the inputs by reference (they are
    fresh tensors each launch), the output bytes from their shapes."""
    return dict(W=W, ob=ob, mvi=mvi, pmv=pmv, lam=lam, subme=int(subme),
                mrq=int(mrq), bd=int(bd),
                out_bytes=_nbytes([o for o in outs]))


def k2_record_bound(rec: dict) -> tuple:
    """Bound of a recorded K2 launch: its bytes, and the instructions the
    candidates within the search range need -- the interpolation once per
    shared filtered sample (``_k2_interp_ops``) and per distinct candidate
    the residual and sixteen 4x4 Hadamard SATDs (256 + 16 x 96 adds).
    subme 0 evaluates the full-pel candidate alone, subme 1 the nine
    half-pel ones, subme 2 also the eight quarter-pel ones around the
    half-pel winner."""
    W, ob, mvi, pmv, lam = (rec[k] for k in ("W", "ob", "mvi", "pmv", "lam"))
    subme, mrq, bd = rec["subme"], rec["mrq"], rec["bd"]
    B = W.shape[0]
    d = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    mv = mvi.cpu().numpy()
    if subme == 0:
        cands = np.zeros((B, 1, 2), np.int64)
        q1 = np.zeros((B, 2), np.int64)
    else:
        q1 = half_pel_winner(W, ob, mvi, pmv, lam, mrq, bd).cpu().numpy()
        r1 = np.array([(2 * dy, 2 * dx) for dy, dx in d])
        cands = np.broadcast_to(r1, (B, 9, 2))
        if subme >= 2:
            r2 = q1[:, None, :] + np.array([p for p in d if p != (0, 0)])
            cands = np.concatenate([cands, r2], 1)
    inside = (np.abs(mv[:, None, :] * 4 + cands) <= 4 * mrq).all(2)
    keys = np.concatenate([q1, inside], 1)
    uniq, count = np.unique(keys, axis=0, return_counts=True)
    ops = 0
    for key, n in zip(uniq, count):
        cq = [tuple(c) for c, ok in zip(cands[np.all(keys == key, 1)][0],
                                        key[2:]) if ok]
        ops += n * (_k2_interp_ops(cq, bd) + len(cq) * (256 + 16 * 96))
    lam_t = torch.as_tensor(lam)
    # a lambda per block (blocks of several frames) is read once each
    nbytes = _nbytes([W, ob, mvi, pmv]) + rec["out_bytes"] + (
        4 * lam_t.numel() if lam_t.numel() > 1 else 0)
    return _bound(nbytes, ops, INT32_OPS_PER_S)


def k2_bound(W, ob, mvi, pmv, outs, lam, mrq, bd=8, subme=2):
    """Bound of one K2 launch (the copied function, in one call)."""
    return k2_record_bound(k2_launch_record(W, ob, mvi, pmv, lam, outs,
                                            subme, mrq, bd))
