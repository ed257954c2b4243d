"""A frozen plain copy of one level of the encoder's CTU-wavefront scan
(the step that the kernel K1 runs on the card), the benchmark's reference
for K1's mode, split and residual decisions.

Given a level's inputs (the frontier carry and the lanes' inputs: the
source tiles, predictions, modes, QPs and lambdas of the level's CTUs) it
returns what the step returns: the new carry, the levels of every TU, the
32-vs-16 and TU32 choices, the split choices and the reconstructed CTUs.
The settings come from the stream's parameter sets and the
configuration (``settings``), never from the program.

``low_precision=True`` computes every RD cost of the step (distortions,
bit estimates, ``lam * bits`` and the psy terms, and each of their sums)
rounded to bfloat16, the precision below the float32 the costs are
specified in: the benchmark's control.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ._util import fma32
from .cost import psy_cost
from .intra import filter_flag, predict_modes, substitute_references
from .quantize import _rdoq_core, dequant, quant_masked, sign_hide_diag
from .transforms import forward_transform, inverse_transform

STRONG_THRESH_SHIFT = 5   # §8.4.4.2.3: 1 << (BitDepth - 5)
# CU-syntax overhead estimates (bits) of the in-scan RD compare
OVH16, OVH32 = 9.0, 12.0
# noise-reduction categories and their TU sizes
NR_CATS = (("y16", 16), ("c8", 8), ("y32", 32), ("c16", 16))


def nr_layout():
    """{cat: (word offset, n * n)} of the packed NR statistics of one
    frame: per category [intra, inter] x [n * n |coef| sums, block count];
    and the total."""
    out, off = {}, 0
    for cat, n in NR_CATS:
        out[cat] = (off, n * n)
        off += 2 * (n * n + 1)
    return out, off


def level_bits(levels: torch.Tensor) -> torch.Tensor:
    """[L, n, n] levels -> [L] float32 estimated residual_coding bits:
    per nonzero coefficient 2*floor(log2|l|) + 3, plus 2 per coded 4x4
    group."""
    a = levels.abs()
    msb = sum((a >= (1 << k)).to(torch.int32) for k in range(1, 16))
    mag = torch.where(a > 0, 2 * msb + 3, 0)
    bits = mag.sum(dim=(-1, -2), dtype=torch.int32)
    L, n, _ = levels.shape
    g = n // 4
    grp_nz = (levels.reshape(L, g, 4, g, 4) != 0).any(4).any(2)
    bits = bits + 2 * grp_nz.sum(dim=(-1, -2), dtype=torch.int32)
    return bits.to(torch.float32)


def _substitute(samples, avail, bit_depth):
    return substitute_references(samples, avail, bit_depth)


def _predict_lanes(refs, modes, n, is_luma, bit_depth):
    return predict_modes(refs, modes, n, is_luma, bit_depth)


@functools.lru_cache(maxsize=8)
def _z_origins(count, size):
    return [(((i & 1) | ((i >> 1) & 2)) * size,
             (((i >> 1) & 1) | ((i >> 2) & 2)) * size) for i in range(count)]


def _strong_smooth_select(ref, n, bit_depth):
    """§8.4.4.2.3 strong (bilinear) smoothing for 32x32 luma TBs: returns
    the strong-filtered canonical vector and the [L] flatness condition."""
    assert n == 32
    corner = ref[:, 2 * n]
    left = ref[:, n:2 * n].flip(1)               # left[k] = p[-1][k], k < n
    bl_last = ref[:, 0]
    top = ref[:, 2 * n + 1: 3 * n + 1]
    tr_last = ref[:, 4 * n]
    thr = 1 << (bit_depth - STRONG_THRESH_SHIFT)
    cond = (((corner + tr_last - 2 * top[:, n - 1]).abs() < thr)
            & ((corner + bl_last - 2 * left[:, n - 1]).abs() < thr))
    i = torch.arange(1, 2 * n, device=ref.device, dtype=torch.int32)
    sleft = ((64 - i) * corner[:, None] + i * bl_last[:, None] + 32) >> 6
    stop = ((64 - i) * corner[:, None] + i * tr_last[:, None] + 32) >> 6
    out = ref.clone()
    out[:, :2 * n] = torch.cat([sleft, bl_last[:, None]], 1).flip(1)
    out[:, 2 * n + 1:] = torch.cat([stop, tr_last[:, None]], 1)
    return out, cond


def _split4(x, m):
    """[K, 2m, 2m] -> [4K, m, m]: the z-order quadrants, quadrant-major."""
    K = x.shape[0]
    return x.reshape(K, 2, m, 2, m).permute(1, 3, 0, 2, 4).reshape(
        4 * K, m, m)


def _join4(x, m):
    """[4K, m, m] z-order quadrants -> [K, 2m, 2m]."""
    K = x.shape[0] // 4
    return x.reshape(2, 2, K, m, m).permute(2, 0, 3, 1, 4).reshape(
        K, 2 * m, 2 * m)


def _bf16(x):
    return torch.as_tensor(x, dtype=torch.float32).to(
        torch.bfloat16).to(torch.float32)


def _f32(x):
    return x


def make_step(s, inter: bool, decide32: bool, rqt: bool = False,
              low_precision: bool = False):
    """step(carry, xs) -> (carry, ys) of one wavefront level under the
    settings ``s`` (``settings.StepSettings``).

    carry: (rowf, colf, cornf, rowfb, colfb, cornfb, rowfr, colfr, cornfr)
    frontier buffers of F frames.  xs: the level's [L, ...] lane inputs,
    frame-major.  ys: (lv16, lv8, lv32, lvc16, sel32, int_y, int_c, nr,
    tu8), None where the step has no such output."""
    lp = _bf16 if low_precision else _f32

    def fma(a, b, c):
        return lp(fma32(a, b, c))

    def psyc(a, b):
        return lp(psy_cost(a, b))

    ctb = 1 << s.log2_ctb
    has32 = ctb >= 32
    n_quads = max(1, (ctb // 32) ** 2)
    spq = (min(ctb, 32) // 16) ** 2
    cw = (s.width + ctb - 1) >> s.log2_ctb
    bd = s.bit_depth
    strong = s.strong_intra_smoothing
    sign_hide = s.sign_hide
    use_rdoq, use_nr = s.rdoq, s.noise_reduction
    psy_rdoq = s.psy_rdoq
    psy = s.psy_rd > 0.0 and (decide32 or rqt)
    rqt = rqt and inter
    maxv = (1 << bd) - 1
    ctbc = ctb // 2
    CH_ = 1 + ctb + (32 if has32 else 16)
    CW_ = 1 + 2 * ctb
    CHC = 1 + ctbc + (16 if has32 else 8)
    CWC = 1 + 2 * ctbc
    quad_orig = _z_origins(n_quads, 32) if has32 else [(0, 0)]
    slot_orig = _z_origins(spq, 16)
    filt32 = np.array([filter_flag(m, 32, True) for m in range(35)])

    def refs_from(C, lx0, ly0, nsz):
        leftc = C[:, ly0:ly0 + 2 * nsz + 1, lx0].flip(1)
        top = C[:, ly0, lx0 + 1:lx0 + 2 * nsz + 1]
        return torch.cat([leftc, top], 1)

    nr_off, nr_words = nr_layout()

    def tq(pred, orig, qp, intra_mask, n, nr_cat, nr=None, luma=True):
        """One TU stage.  With noise reduction, the category's offsets
        come off |coef| and its statistics (|coef| before that, and the
        blocks with any nonzero coefficient, by intra / inter) add to
        ``nr`` [F, W] (not for the RQT sub-TUs, ``nr_cat`` None); with
        RDOQ the levels are ``_rdoq_core``'s (psy-RDOQ on luma only)."""
        coef = forward_transform(orig - pred, bd)
        if use_nr and nr_cat is not None:
            K = coef.shape[0]
            a = coef.abs().reshape(K, n * n)
            base, nn = nr_off[nr_cat]
            pack = nr["xs"]["nr_pack"]
            off = torch.where(intra_mask[:, None],
                              pack[base:base + nn][None],
                              pack[base + nn + 1:base + 2 * nn + 1][None])
            live = (a != 0).any(1)
            # the frame of each lane (chroma lanes: cb, then cr)
            fk = nr["fi"].repeat(K // nr["fi"].shape[0])
            for cls, m in enumerate((intra_mask & live,
                                     ~intra_mask & live)):
                o = base + cls * (nn + 1)
                mi = m.to(torch.int32)
                nr["acc"][:, o:o + nn].index_add_(0, fk, a * mi[:, None])
                nr["acc"][:, o + nn].index_add_(0, fk, mi)
            coef = (coef.sign().reshape(K, n * n)
                    * (a - off).clamp(min=0)).reshape(K, n, n)
        if use_rdoq:
            levels = _rdoq_core(coef, qp, bd,
                                psy_scale=psy_rdoq if luma else 0.0)
        else:
            levels = quant_masked(coef, qp, intra_mask, bd)
        if sign_hide:
            levels = sign_hide_diag(levels)
        r2 = inverse_transform(dequant(levels, qp, bd), bd)
        has = (levels != 0).any(2).any(1)[:, None, None]
        rec = torch.where(has, pred + r2, pred).clamp(0, maxv)
        return levels, rec

    def predict32(raw, av, m32):
        ref = _substitute(raw, av, bd)
        if not strong:
            return _predict_lanes(ref, m32, 32, True, bd)
        sref, scond = _strong_smooth_select(ref, 32, bd)
        filt = torch.as_tensor(filt32, device=ref.device)[m32.long()]
        use_strong = scond & filt
        ref_sel = torch.where(use_strong[:, None], sref, ref)
        pred_f = _predict_lanes(ref_sel, m32, 32, True, bd)
        pred_u = _predict_lanes(ref_sel, m32, 32, False, bd)
        return torch.where(use_strong[:, None, None], pred_u, pred_f)

    def ssd(a, b):
        d = a - b
        return lp((d * d).sum(dim=(1, 2), dtype=torch.int32).to(
            torch.float32))

    def rd(rec_y, o_y, rec_c, o_c, lv_y, lv_c, ovh, lam, L):
        """SSD + lam * bits over the three planes (lam * bits fused
        into one rounding)."""
        sc = ssd(rec_c, o_c)
        bc = lp(level_bits(lv_c))
        bits = lp(lp(lp(lp(level_bits(lv_y)) + bc[:L]) + bc[L:]) + ovh)
        return fma(lam, bits, lp(lp(ssd(rec_y, o_y) + sc[:L]) + sc[L:]))

    def cat2(a):
        return torch.cat([a, a])

    def split_c(x):
        # [L, 2, n, n] (cb, cr) -> [2L, n, n] paired lanes
        return torch.cat([x[:, 0], x[:, 1]])

    def step(carry, xs):
        (rowf, colf, cornf, rowfb, colfb, cornfb,
         rowfr, colfr, cornfr) = carry
        cx, cy = xs["cx"].long(), xs["cy"].long()
        L = cx.shape[0]
        dev = cx.device
        qp_y = xs["qp_y"]
        qp_c2 = torch.cat([xs["qp_cb"], xs["qp_cr"]])
        if decide32 or rqt:
            lam = lp(xs["lam"])
            plam = lp(xs["plam"]) if psy else None
        ones_l = torch.ones((L,), dtype=torch.bool, device=dev)
        ones_2l = torch.ones((2 * L,), dtype=torch.bool, device=dev)
        lv16_o, lv8_o, lv32_o, lvc16_o, u32_o = [], [], [], [], []
        tu8_o = []

        fi = torch.arange(L, device=dev) // (L // rowf.shape[0])
        nr = None
        if use_nr:
            nr = dict(xs=xs, fi=fi, acc=torch.zeros(
                (rowf.shape[0], nr_words), dtype=torch.int32,
                device=dev))
        cx1 = torch.clamp(cx + 1, max=cw)
        par = (cy - 1) & 1
        C = torch.zeros((L, CH_, CW_), dtype=torch.int32, device=dev)
        C[:, 0, 1:1 + 2 * ctb] = torch.cat([rowf[fi, cx], rowf[fi, cx1]],
                                           1)
        C[:, 1:1 + ctb, 0] = colf[fi, cy]
        C[:, 0, 0] = cornf[fi, cx, par]
        Cc = torch.zeros((2 * L, CHC, CWC), dtype=torch.int32, device=dev)
        Cc[:, 0, 1:1 + 2 * ctbc] = torch.cat([
            torch.cat([rowfb[fi, cx], rowfb[fi, cx1]], 1),
            torch.cat([rowfr[fi, cx], rowfr[fi, cx1]], 1)])
        Cc[:, 1:1 + ctbc, 0] = torch.cat([colfb[fi, cy], colfr[fi, cy]])
        Cc[:, 0, 0] = torch.cat([cornfb[fi, cx, par],
                                 cornfr[fi, cx, par]])

        for q in range(n_quads):
            qx, qy = quad_orig[q]
            slot_preds, slot_predcs = [], []
            if has32:
                m32 = xs["m32"][:, q]
                o32y = xs["o32y"][:, q]
                pred32 = predict32(refs_from(C, qx, qy, 32),
                                   xs["l32_av"][:, q], m32)
                lv32, rec32 = tq(pred32, o32y, qp_y, ones_l, 32, "y32",
                                 nr)
                refc = _substitute(refs_from(Cc, qx // 2, qy // 2, 16),
                                   cat2(xs["c16_av"][:, q]), bd)
                predc = _predict_lanes(refc, cat2(m32), 16, False, bd)
                oc32 = torch.cat([xs["o16cb"][:, q], xs["o16cr"][:, q]])
                lvc32, recc32 = tq(predc, oc32, qp_c2, ones_2l, 16,
                                   "c16", nr, luma=False)
                if decide32:
                    cost32 = rd(rec32, o32y, recc32, oc32, lv32, lvc32,
                                OVH32, lam, L)
                    if psy:
                        cost32 = fma(plam, psyc(o32y, rec32),
                                       cost32)
                    cost16 = torch.zeros((L,), dtype=torch.float32,
                                         device=dev)
                    any_inter = torch.zeros((L,), dtype=torch.bool,
                                            device=dev)
            for s in range(spq):
                i = q * spq + s
                sx, sy = qx + slot_orig[s][0], qy + slot_orig[s][1]
                m = xs["m16"][:, i]
                ref = _substitute(refs_from(C, sx, sy, 16),
                                  xs["l16_av"][:, i], bd)
                pred = _predict_lanes(ref, m, 16, True, bd)
                if inter:
                    iv = xs["inter"][:, i]
                    pred = torch.where(iv[:, None, None], xs["ipy"][:, i],
                                       pred)
                    imask = ~iv
                else:
                    imask = ones_l
                o16 = xs["o16y"][:, i]
                slot_preds.append(pred)
                lv, rec = tq(pred, o16, qp_y, imask, 16, "y16", nr)
                refc = _substitute(refs_from(Cc, sx // 2, sy // 2, 8),
                                   cat2(xs["c8_av"][:, i]), bd)
                predc = _predict_lanes(refc, cat2(m), 8, False, bd)
                if inter:
                    iv2 = cat2(iv)
                    predc = torch.where(iv2[:, None, None],
                                        split_c(xs["ipc"][:, i]), predc)
                    imask2 = ~iv2
                else:
                    imask2 = ones_2l
                oc = split_c(xs["o8c"][:, i])
                slot_predcs.append(predc)
                lvc, recc = tq(predc, oc, qp_c2, imask2, 8, "c8", nr,
                               luma=False)
                if rqt:
                    # the depth-1 RQT candidate: four 8x8 luma TUs and
                    # four 4x4 TUs a chroma plane, RD-compared jointly
                    # with the TU16 configuration (x265 search.cpp:2838)
                    lv8s, rec8s = tq(_split4(pred, 8), _split4(o16, 8),
                                     qp_y.repeat(4), imask.repeat(4), 8,
                                     None)
                    lv4s, rec4s = tq(_split4(predc, 4), _split4(oc, 4),
                                     qp_c2.repeat(4), imask2.repeat(4), 4,
                                     None, luma=False)
                    rec8, rec4 = _join4(rec8s, 8), _join4(rec4s, 4)
                    c16 = rd(rec, o16, recc, oc, lv, lvc, 0.0, lam, L)
                    sc4 = ssd(rec4, oc)
                    b8 = lp(level_bits(lv8s).reshape(4, L).sum(0))
                    bc4 = lp(level_bits(lv4s).reshape(4, 2 * L).sum(0))
                    # split flag + extra cbf signalling overhead
                    c8 = fma(lam, lp(lp(lp(b8 + bc4[:L]) + bc4[L:]) + 9.0),
                             lp(lp(ssd(rec8, o16) + sc4[:L]) + sc4[L:]))
                    if psy:
                        c16 = fma(plam, psyc(o16, rec), c16)
                        c8 = fma(plam, psyc(o16, rec8), c8)
                    tu8 = iv & xs["rqt_ok"][:, i] & (c8 < c16)
                    t3 = tu8[:, None, None]
                    t3c = cat2(tu8)[:, None, None]
                    rec = torch.where(t3, rec8, rec)
                    lv = torch.where(t3, _join4(lv8s, 8), lv)
                    recc = torch.where(t3c, rec4, recc)
                    lvc = torch.where(t3c, _join4(lv4s, 4), lvc)
                    tu8_o.append(tu8)
                lv16_o.append(lv)
                lv8_o.append(lvc)
                C[:, 1 + sy:1 + sy + 16, 1 + sx:1 + sx + 16] = rec
                Cc[:, 1 + sy // 2:1 + sy // 2 + 8,
                   1 + sx // 2:1 + sx // 2 + 8] = recc
                if has32 and decide32:
                    cost16 = lp(cost16 + rd(rec, o16, recc, oc, lv, lvc,
                                            OVH16, lam, L))
                    if psy:
                        cost16 = fma(plam, psyc(o16, rec), cost16)
                    if inter:
                        any_inter = any_inter | iv
            if has32:
                if decide32:
                    u32 = xs["quad_ok"][:, q] & (cost32 < cost16)
                    if inter:
                        u32 = u32 & ~any_inter
                else:
                    u32 = xs["use32"][:, q]
                sel32, rec32f, lv32f = u32, rec32, lv32
                recc32f, lvc32f = recc32, lvc32
                if inter and decide32:
                    # inter TU32 trial of uniform-motion quads
                    ip32 = _join4(torch.cat(slot_preds), 16)
                    ipc16 = _join4(torch.cat(slot_predcs), 8)
                    lv32i, rec32i = tq(ip32, o32y, qp_y, ~ones_l, 32,
                                       "y32", nr)
                    lvc16i, recc16i = tq(ipc16, oc32, qp_c2, ~ones_2l,
                                         16, "c16", nr, luma=False)
                    c32i = rd(rec32i, o32y, recc16i, oc32, lv32i,
                              lvc16i, OVH32, lam, L)
                    if psy:
                        c32i = fma(plam, psyc(o32y, rec32i), c32i)
                    tu32 = xs["m32_in"][:, q] & (c32i < cost16)
                    t1 = tu32[:, None, None]
                    t2 = cat2(tu32)[:, None, None]
                    sel32 = u32 | tu32
                    rec32f = torch.where(t1, rec32i, rec32)
                    lv32f = torch.where(t1, lv32i, lv32)
                    recc32f = torch.where(t2, recc16i, recc32)
                    lvc32f = torch.where(t2, lvc16i, lvc32)
                u32_o.append(sel32)
                lv32_o.append(lv32f)
                lvc16_o.append(lvc32f)
                win = C[:, 1 + qy:1 + qy + 32, 1 + qx:1 + qx + 32]
                C[:, 1 + qy:1 + qy + 32, 1 + qx:1 + qx + 32] = \
                    torch.where(sel32[:, None, None], rec32f, win)
                qcx, qcy = qx // 2, qy // 2
                winc = Cc[:, 1 + qcy:1 + qcy + 16, 1 + qcx:1 + qcx + 16]
                Cc[:, 1 + qcy:1 + qcy + 16, 1 + qcx:1 + qcx + 16] = \
                    torch.where(cat2(sel32)[:, None, None], recc32f, winc)

        # frontier update (dummy lanes write the spare rows; they all
        # compute the same values, so duplicate writes agree)
        rowf, colf, cornf = rowf.clone(), colf.clone(), cornf.clone()
        rowfb, colfb, cornfb = rowfb.clone(), colfb.clone(), cornfb.clone()
        rowfr, colfr, cornfr = rowfr.clone(), colfr.clone(), cornfr.clone()
        rowf[fi, cx] = C[:, ctb, 1:1 + ctb]
        colf[fi, cy] = C[:, 1:1 + ctb, ctb]
        cornf[fi, cx + 1, cy & 1] = C[:, ctb, ctb]
        botc = Cc[:, ctbc, 1:1 + ctbc]
        rightc = Cc[:, 1:1 + ctbc, ctbc]
        cc = Cc[:, ctbc, ctbc]
        rowfb[fi, cx] = botc[:L]
        rowfr[fi, cx] = botc[L:]
        colfb[fi, cy] = rightc[:L]
        colfr[fi, cy] = rightc[L:]
        cornfb[fi, cx + 1, cy & 1] = cc[:L]
        cornfr[fi, cx + 1, cy & 1] = cc[L:]

        def stack(v):
            return torch.stack(v) if v else None

        ys = (stack(lv16_o), stack(lv8_o), stack(lv32_o),
              stack(lvc16_o), stack(u32_o),
              C[:, 1:1 + ctb, 1:1 + ctb].contiguous(),
              Cc[:, 1:1 + ctbc, 1:1 + ctbc].contiguous(),
              nr["acc"] if use_nr else None, stack(tu8_o))
        return (rowf, colf, cornf, rowfb, colfb, cornfb,
                rowfr, colfr, cornfr), ys

    return step

# -- the scan ------------------------------------------------------------
