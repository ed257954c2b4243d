"""CTU-level wavefront reconstruction scan — torch twin of
``x265_tpu.encoder.ctu_scan``.

The picture is reconstructed in WPP order at CTU granularity: level
``cx + 2*cy`` holds every CTU whose left and top-right neighbours are
done, so the scan runs ``ctbs_w + 2*(ctbs_h-1)`` levels (at 1080p 62 with
64x64 CTUs, 126 with 32x32, 254 with 16x16) with the level's CTUs as
batched lanes.  Inside a lane the
CTU's quadrant / slot structure is unrolled in z-order (32x32 intra
candidate, four 16x16 slots, the in-scan 32-vs-16 RD decision, the inter
TU32 trial).  ``lax.scan`` over levels becomes a Python loop; each level is
one call of the step, which on a CUDA device is the hand-written kernel K1
(``ctu_scan_cuda.py``) and everywhere else the plain torch step below.

Ported branches: decide32 on/off, intra and inter (with the ``m32_in``
TU32 trial), psy-rd, sign hiding, strong intra smoothing, RDOQ with
psy-RDOQ and DCT-domain noise reduction, the inter RQT split candidate
(``rqt``: four 8x8 luma and 4x4 chroma TUs against the TU16 of every inter
16x16 slot), at CTB sizes 64, 32 and 16 (at 16
one 16x16 slot a CTU and no 32x32 candidate), at bit depth 8 and 10 (the recon
planes come out uint8, or int16 holding the reference's uint16 values:
``_util.sample_dtype``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import trace
from .._util import f32, fma32, sample_dtype
from ..common.geometry import PictureGeometry, intra_neighbor_coords
from ..common.rdcost import level_bits
from ..ops.cost import psy_cost
from ..ops.intra import filter_flag
from ..ops.quantize import _rdoq_core, dequant, quant_masked, sign_hide_diag
from ..ops.transforms import forward_transform, inverse_transform
from .wavefront import _predict_lanes, _substitute

STRONG_THRESH_SHIFT = 5   # §8.4.4.2.3: 1 << (BitDepth - 5)
# CU-syntax overhead estimates (bits) of the in-scan RD compare
OVH16, OVH32 = 9.0, 12.0
# float32(1 / 0.85): XLA folds ``lam / 0.85`` into a multiply by the
# constant's inverse, so the reference's psy lambda rounds this way
_INV_085 = np.float32(1.0) / np.float32(0.85)
# noise-reduction categories (the reference's order) and their TU sizes
NR_CATS = (("y16", 16), ("c8", 8), ("y32", 32), ("c16", 16))


def nr_layout():
    """{cat: (word offset, n * n)} of the packed NR statistics of one
    frame: per category [intra, inter] x [n * n |coef| sums, block count],
    the layout of the pipelines' ``nr_<cat>`` outputs; and the total."""
    out, off = {}, 0
    for cat, n in NR_CATS:
        out[cat] = (off, n * n)
        off += 2 * (n * n + 1)
    return out, off


@functools.lru_cache(maxsize=8)
def build_ctu_tables(width: int, height: int, log2_ctb: int):
    """Static schedule + per-(CTU, slot) tables of the CTU wavefront (a
    copy of the reference's numpy builder; same keys and layout)."""
    g = PictureGeometry(width, height, log2_ctb, 3)
    ctb = 1 << log2_ctb
    cw, ch = g.ctbs_w, g.ctbs_h
    nctb = g.n_ctbs
    ph, pw = ch * ctb, cw * ctb
    cph, cpw = ph // 2, pw // 2
    lsize = ph * pw
    csize = cph * cpw
    flat_size = lsize + 2 * csize + 1
    drop = flat_size

    lvl = np.add.outer(2 * np.arange(ch), np.arange(cw))
    n_levels = int(lvl.max()) + 1
    counts = np.bincount(lvl.ravel(), minlength=n_levels)
    lmax = int(counts.max())
    lvl_ctu = np.full((n_levels, lmax), nctb, np.int32)
    fill = np.zeros(n_levels, np.int32)
    for cy in range(ch):
        for cx in range(cw):
            li = int(lvl[cy, cx])
            lvl_ctu[li, fill[li]] = cy * cw + cx
            fill[li] += 1

    n_quads = max(1, (ctb // 32) ** 2)
    slots_per_quad = (min(ctb, 32) // 16) ** 2
    nslots = n_quads * slots_per_quad
    has32 = ctb >= 32

    def z_origins(count, size):
        out = []
        for i in range(count):
            x = ((i & 1) | ((i >> 1) & 2)) * size
            y = (((i >> 1) & 1) | ((i >> 2) & 2)) * size
            out.append((x, y))
        return out

    quad_orig = z_origins(n_quads, 32) if has32 else [(0, 0)]
    slot_orig = z_origins(slots_per_quad, 16)

    gw16 = pw // 16
    b16_n = (ph // 16) * gw16
    gw32 = pw // 32 if has32 else 1
    b32_n = (ph // 32) * gw32 if has32 else 1

    b16 = np.full((nctb + 1, nslots), b16_n, np.int32)
    b32 = np.full((nctb + 1, n_quads), b32_n, np.int32)
    l16_ri = np.zeros((nctb + 1, nslots, 65), np.int32)
    l16_av = np.zeros((nctb + 1, nslots, 65), bool)
    c8_ri = np.zeros((nctb + 1, nslots, 33), np.int32)
    c8_av = np.zeros((nctb + 1, nslots, 33), bool)
    l16_base = np.full((nctb + 1, nslots), drop, np.int32)
    c8_base = np.full((nctb + 1, nslots), drop, np.int32)
    l32_ri = np.zeros((nctb + 1, n_quads, 129), np.int32)
    l32_av = np.zeros((nctb + 1, n_quads, 129), bool)
    c16_ri = np.zeros((nctb + 1, n_quads, 65), np.int32)
    c16_av = np.zeros((nctb + 1, n_quads, 65), bool)
    quad_ok = np.zeros((nctb + 1, n_quads), bool)

    def luma_tab(x0, y0, n):
        xs, ys = intra_neighbor_coords(x0, y0, n)
        av = g.avail_rows(x0, y0, xs, ys)
        ri = (np.clip(ys, 0, ph - 1) * pw + np.clip(xs, 0, pw - 1))
        return ri.astype(np.int32), av

    def chroma_tab(x0c, y0c, n):
        xs, ys = intra_neighbor_coords(x0c, y0c, n)
        av = g.avail_rows(x0c << 1, y0c << 1, xs << 1, ys << 1)
        ri = lsize + (np.clip(ys, 0, cph - 1) * cpw
                      + np.clip(xs, 0, cpw - 1))
        return ri.astype(np.int32), av

    for c in range(nctb):
        ox, oy = g.ctu_origin(c)
        for q, (qx, qy) in enumerate(quad_orig):
            if has32:
                x0, y0 = ox + qx, oy + qy
                if x0 < g.width and y0 < g.height:
                    l32_ri[c, q], l32_av[c, q] = luma_tab(x0, y0, 32)
                    c16_ri[c, q], c16_av[c, q] = chroma_tab(
                        x0 >> 1, y0 >> 1, 16)
                    quad_ok[c, q] = (x0 + 32 <= g.width
                                     and y0 + 32 <= g.height)
            for s, (sx, sy) in enumerate(slot_orig):
                i = q * slots_per_quad + s
                x0, y0 = ox + qx + sx, oy + qy + sy
                if x0 >= g.width or y0 >= g.height:
                    continue
                b16[c, i] = (y0 // 16) * gw16 + (x0 // 16)
                l16_ri[c, i], l16_av[c, i] = luma_tab(x0, y0, 16)
                c8_ri[c, i], c8_av[c, i] = chroma_tab(x0 >> 1, y0 >> 1, 8)
                l16_base[c, i] = y0 * pw + x0
                c8_base[c, i] = lsize + (y0 >> 1) * cpw + (x0 >> 1)
        if has32:
            for q, (qx, qy) in enumerate(quad_orig):
                x0, y0 = ox + qx, oy + qy
                if x0 < g.width and y0 < g.height:
                    b32[c, q] = (y0 // 32) * gw32 + (x0 // 32)

    def per_level(a):
        return a[lvl_ctu]

    cxs_t = np.full((n_levels, lmax), cw, np.int32)
    cys_t = np.full((n_levels, lmax), ch, np.int32)
    for li in range(n_levels):
        for k in range(lmax):
            c = lvl_ctu[li, k]
            if c < nctb:
                cxs_t[li, k] = c % cw
                cys_t[li, k] = c // cw

    return dict(
        geom=g, n_levels=n_levels, lmax=lmax, nctb=nctb,
        plane=(ph, pw), cplane=(cph, cpw), flat_size=flat_size,
        lsize=lsize, csize=csize, has32=has32,
        n_quads=n_quads, slots_per_quad=slots_per_quad, nslots=nslots,
        b16_n=b16_n, b32_n=b32_n, quad_ok=quad_ok[:nctb],
        xs=dict(ctu=lvl_ctu, cx=cxs_t, cy=cys_t,
                b16=per_level(b16), b32=per_level(b32),
                l16_av=per_level(l16_av),
                c8_av=per_level(c8_av),
                l32_av=per_level(l32_av),
                c16_av=per_level(c16_av),
                quad_ok=per_level(quad_ok)),
        lvl_ctu=lvl_ctu)


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


class CtuScan:
    """Whole-picture reconstruction scan at CTU granularity."""

    def __init__(self, geom: PictureGeometry, bit_depth: int = 8,
                 sign_hide: bool = False,
                 strong_intra_smoothing: bool = False,
                 rdoq: bool = False, noise_reduction: bool = False,
                 psy_rd: float = 0.0, psy_rdoq: float = 0.0):
        self.t = build_ctu_tables(geom.width, geom.height, geom.log2_ctb)
        self.bit_depth = bit_depth
        self.sign_hide = sign_hide
        self.strong = strong_intra_smoothing
        self.rdoq = rdoq
        self.noise_reduction = noise_reduction
        self.psy_rd = float(psy_rd)
        self.psy_rdoq = float(psy_rdoq)
        self.geom = geom

    # -- the per-level step (plain torch; K1's reference) -------------------

    def make_step(self, inter: bool, decide32: bool, rqt: bool = False):
        """Returns step(carry, xs) -> (carry, ys) for one wavefront level.

        carry: (rowf, colf, cornf, rowfb, colfb, cornfb, rowfr, colfr,
        cornfr) frontier buffers of F frames (rowf [F, cw + 1, ctb], colf
        [F, ch + 1, ctb], cornf [F, cw + 2, 2], the chroma planes' at
        ctb / 2).  xs: the level's [L, ...] lane inputs, frame-major (lane
        l belongs to frame l // (L / F); see ``scan_fn``).  ys: (lv16
        [nslots, L, 16, 16], lv8 [nslots, 2L, 8, 8], lv32 [nq, L, 32, 32],
        lvc16 [nq, 2L, 16, 16], sel32 [nq, L], int_y [L, ctb, ctb], int_c
        [2L, ctbc, ctbc], nr [F, W] int32 or None: with noise reduction
        the level's NR statistics of each frame, ``nr_layout()``, tu8
        [nslots, L] bool or None: with ``rqt`` in an inter scan the slots
        coded with the split tree); with noise reduction xs also holds the
        offsets ``nr_pack`` [W] int32 in the statistics' layout (the count
        words zero), with the split ``rqt_ok`` [L, nslots] bool."""
        t = self.t
        bd = self.bit_depth
        g = t["geom"]
        has32 = t["has32"]
        n_quads, spq = t["n_quads"], t["slots_per_quad"]
        strong = self.strong
        sign_hide = self.sign_hide
        psy = self.psy_rd > 0.0 and (decide32 or rqt)
        rqt = rqt and inter
        maxv = (1 << bd) - 1
        ctb = 1 << g.log2_ctb
        ctbc = ctb // 2
        cw, ch = g.ctbs_w, g.ctbs_h
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

        use_rdoq, use_nr = self.rdoq, self.noise_reduction
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
                                    psy_scale=self.psy_rdoq if luma else 0.0)
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
            return (d * d).sum(dim=(1, 2), dtype=torch.int32).to(
                torch.float32)

        def rd(rec_y, o_y, rec_c, o_c, lv_y, lv_c, ovh, lam, L):
            """SSD + lam * bits over the three planes (lam * bits fused
            into one rounding, as XLA:CPU contracts it)."""
            sc = ssd(rec_c, o_c)
            bc = level_bits(lv_c)
            bits = level_bits(lv_y) + bc[:L] + bc[L:] + ovh
            return fma32(lam, bits, ssd(rec_y, o_y) + sc[:L] + sc[L:])

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
                lam = xs["lam"]
                plam = xs["plam"] if psy else None
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
                            cost32 = fma32(plam, psy_cost(o32y, rec32),
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
                        b8 = level_bits(lv8s).reshape(4, L).sum(0)
                        bc4 = level_bits(lv4s).reshape(4, 2 * L).sum(0)
                        # split flag + extra cbf signalling overhead
                        c8 = fma32(lam, b8 + bc4[:L] + bc4[L:] + 9.0,
                                   ssd(rec8, o16) + sc4[:L] + sc4[L:])
                        if psy:
                            c16 = fma32(plam, psy_cost(o16, rec), c16)
                            c8 = fma32(plam, psy_cost(o16, rec8), c8)
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
                        cost16 = cost16 + rd(rec, o16, recc, oc, lv, lvc,
                                             OVH16, lam, L)
                        if psy:
                            cost16 = fma32(plam, psy_cost(o16, rec), cost16)
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
                            c32i = fma32(plam, psy_cost(o32y, rec32i), c32i)
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

    def scan_fn(self, inter: bool, decide32: bool = False,
                rqt: bool = False, allow_kernel: bool = True):
        """Returns run(...) -> (rec_y, rec_cb, rec_cr, lv16_y, lv8_cb,
        lv8_cr, lv32_y, lv16_cb, lv16_cr, use32, tu8, nr), the
        reference's ``scan_fn`` contract (``nr``: with noise reduction
        {cat: (s_i, c_i, s_p, c_p)} summed over the levels, else None).
        Inputs are torch tensors on
        one device, of one frame or of F frames on a leading dimension
        (the outputs then have it too; each level is one step over the
        F x L lanes); ``lam`` [nctb] float32 SSD-domain lambdas with
        decide32; ``is_inter`` / ``ipred_*`` / ``m32_in`` with ``inter``.
        ``nr_offsets`` ({"<cat>_i" / "<cat>_p": [n * n] int32}, missing
        entries zero) with noise reduction; the frames of a batched call
        share them.  With ``rqt`` (inter scans; elsewhere it changes
        nothing) every inter 16x16 slot also tries the depth-1 split and
        ``tu8`` [B16] marks the blocks coded with it, whose lv16 / lv8 rows
        hold the four sub-TUs' levels in place; ``rqt_ok`` [B16] bool (all
        true when None) masks the blocks that cannot split.
        ``allow_kernel=False`` runs the plain step on any device."""
        from .ctu_scan_cuda import ctu_step

        t = self.t
        g = t["geom"]
        ph, pw = t["plane"]
        has32 = t["has32"]
        n_quads = t["n_quads"]
        nslots = t["nslots"]
        B16, B32 = t["b16_n"], t["b32_n"]
        n_levels, lmax = t["n_levels"], t["lmax"]
        ctb = 1 << g.log2_ctb
        ctbc = ctb // 2
        cw, ch = g.ctbs_w, g.ctbs_h
        nctb = t["nctb"]
        bd = self.bit_depth
        psy = self.psy_rd > 0.0 and (decide32 or rqt)
        plain = self.make_step(inter, decide32, rqt)
        # level streams of the dummy-padded tables, plus block-raster
        # inverse permutations of the level stacks (static per geometry)
        inv16 = _inv_perm(t["xs"]["b16"], B16)
        inv32 = _inv_perm(t["xs"]["b32"], B32)
        inv_ctb = _inv_perm(t["lvl_ctu"].reshape(n_levels, lmax, 1), nctb)

        @trace.spanned("scan")
        def run(oy, ocb, ocr, mode16, mode32, use32, qp_y, qp_cb, qp_cr,
                lam=None, is_inter=None, ipred_y=None, ipred_cb=None,
                ipred_cr=None, m32_in=None, rqt_ok=None, nr_offsets=None):
            dev = oy.device
            i32 = torch.int32
            # one frame, or F frames on a leading dimension: each level is
            # one step over the F x L lanes of the frames (frame-major)
            batched = oy.dim() == 3
            F = oy.shape[0] if batched else 1

            def fr(x):
                return x if batched else x[None]

            def lev(x, tab):
                """[nl, F * L, ...] level stream of per-frame blocks x [F,
                N, ...] (row N: the zero block of dummy entries)."""
                x = torch.cat([x, torch.zeros((F, 1) + tuple(x.shape[2:]),
                                              dtype=x.dtype, device=dev)],
                              1)[:, tab]
                return x.transpose(0, 1).reshape(
                    (n_levels, F * lmax) + tuple(x.shape[3:]))

            def T(a):
                with trace.sync():
                    return torch.as_tensor(a, device=dev)

            def static(a):
                a = T(a)
                return a.repeat((1, F) + (1,) * (a.dim() - 2))

            with trace.span("scan.prep"):
                b16t = T(t["xs"]["b16"]).long()
                ctut = T(t["xs"]["ctu"]).long()
                oy, ocb, ocr = (fr(x).to(i32) for x in (oy, ocb, ocr))
                xs = {k: static(t["xs"][k]) for k in (
                    "cx", "cy", "l16_av", "c8_av", "l32_av", "c16_av",
                    "quad_ok")}
                xs["o16y"] = lev(_to_blocks(oy, 16), b16t)
                xs["o8c"] = torch.stack([lev(_to_blocks(ocb, 8), b16t),
                                         lev(_to_blocks(ocr, 8), b16t)], 3)
                xs["m16"] = lev(fr(mode16).to(i32), b16t)
                xs["qp_y"] = lev(fr(qp_y).to(i32), ctut)
                xs["qp_cb"] = lev(fr(qp_cb).to(i32), ctut)
                xs["qp_cr"] = lev(fr(qp_cr).to(i32), ctut)
                if has32:
                    b32t = T(t["xs"]["b32"]).long()
                    xs["o32y"] = lev(_to_blocks(oy, 32), b32t)
                    xs["o16cb"] = lev(_to_blocks(ocb, 16), b32t)
                    xs["o16cr"] = lev(_to_blocks(ocr, 16), b32t)
                    xs["m32"] = lev(fr(mode32).to(i32), b32t)
                    if not decide32:
                        xs["use32"] = lev(fr(use32).to(torch.bool), b32t)
                if decide32 or rqt:
                    lam_c = lev(fr(lam).to(torch.float32), ctut)
                    xs["lam"] = lam_c
                    if psy:
                        # SAD-domain psy lambda:
                        # psyRd * 0.33 * sqrt(lam / 0.85)
                        xs["plam"] = (f32(self.psy_rd * 0.33, dev)
                                      * torch.sqrt(lam_c
                                                   * f32(_INV_085, dev)))
                if inter:
                    xs["inter"] = lev(fr(is_inter).to(torch.bool), b16t)
                    xs["ipy"] = lev(fr(ipred_y).to(i32), b16t)
                    xs["ipc"] = torch.stack([lev(fr(ipred_cb).to(i32), b16t),
                                             lev(fr(ipred_cr).to(i32), b16t)],
                                            3)
                    if decide32:
                        m32b = (torch.zeros((F, B32), dtype=torch.bool,
                                            device=dev)
                                if m32_in is None
                                else fr(m32_in).to(torch.bool))
                        xs["m32_in"] = lev(m32b.reshape(F, -1), b32t)
                    if rqt:
                        rq = (torch.ones((F, B16), dtype=torch.bool,
                                         device=dev)
                              if rqt_ok is None
                              else fr(rqt_ok).to(torch.bool))
                        xs["rqt_ok"] = lev(rq.reshape(F, -1), b16t)
                xs = {k: v.contiguous() for k, v in xs.items()}
                nr_xs = {}
                if self.noise_reduction:
                    # the offsets in the statistics' layout, count words zero
                    lay, words = nr_layout()
                    pack = np.zeros((words,), np.int32)
                    for cat, (o, nn) in lay.items():
                        for cls, sfx in enumerate(("_i", "_p")):
                            v = (nr_offsets or {}).get(cat + sfx)
                            if v is not None:
                                o1 = o + cls * (nn + 1)
                                pack[o1:o1 + nn] = np.asarray(v)
                    with trace.sync():
                        nr_xs["nr_pack"] = torch.as_tensor(pack).to(dev)

                def z(*shape):
                    return torch.zeros((F,) + shape, dtype=i32, device=dev)

                carry = (z(cw + 1, ctb), z(ch + 1, ctb), z(cw + 2, 2),
                         z(cw + 1, ctbc), z(ch + 1, ctbc), z(cw + 2, 2),
                         z(cw + 1, ctbc), z(ch + 1, ctbc), z(cw + 2, 2))
            ys_all = []
            nr_sum = None
            for li in range(n_levels):
                with trace.span("scan.level"):
                    xl = {k: v[li] for k, v in xs.items()}
                    xl.update(nr_xs)
                    if allow_kernel:
                        carry, ys = ctu_step(self, inter, decide32, carry, xl,
                                             plain)
                    else:
                        carry, ys = plain(carry, xl)
                    ys_all.append(ys[:7] + ys[8:])
                    if ys[7] is not None:
                        nr_sum = ys[7] if nr_sum is None else nr_sum + ys[7]
            with trace.span("scan.unpack"):
                (lv16_s, lv8_s, lv32_s, lvc16_s, u32_s, int_y, int_c,
                 tu8_s) = (torch.stack([y[k] for y in ys_all])
                           if ys_all[0][k] is not None else None
                           for k in range(8))
                outs = [frame_outputs(
                    *(None if v is None else v.narrow(dim, f * lmax, lmax)
                      for v, dim in ((lv16_s, 2), (lv32_s, 2), (u32_s, 2),
                                     (int_y, 1), (tu8_s, 2))),
                    *(None if v is None else v.reshape(
                        v.shape[:dim] + (2, F, lmax)
                        + v.shape[dim + 1:]).select(dim + 1, f)
                      for v, dim in ((lv8_s, 2), (lvc16_s, 2), (int_c, 1))),
                    None if nr_sum is None else nr_sum[f])
                    for f in range(F)]
                if not batched:
                    return outs[0]
                return tuple(None if o[0] is None else torch.stack(o)
                             for o in list(zip(*outs))[:11]) + (
                    None if nr_sum is None else {
                        cat: tuple(torch.stack(v) for v in zip(
                            *(o[11][cat] for o in outs)))
                        for cat in outs[0][11]},)

        def frame_outputs(lv16_s, lv32_s, u32_s, int_y, tu8_s, lv8_s,
                          lvc16_s, int_c, nr):
            """One frame's outputs from its lanes of the level stacks (the
            chroma stacks as [..., 2, lmax, ...]) and its NR statistics."""
            dev = int_y.device

            def T(a):
                with trace.sync():
                    return torch.as_tensor(a, device=dev)

            def tiles_to_plane(tiles, size):
                flat = torch.cat([tiles.reshape(-1, size, size),
                                  torch.zeros((1, size, size),
                                              dtype=tiles.dtype,
                                              device=dev)])
                out = flat[T(inv_ctb).long()]
                return out.reshape(ch, cw, size, size).permute(
                    0, 2, 1, 3).reshape(ch * size, cw * size)

            out_dtype = sample_dtype(bd)
            rec_y = tiles_to_plane(int_y, ctb).to(out_dtype)
            rec_cb = tiles_to_plane(int_c[:, 0], ctbc).to(out_dtype)
            rec_cr = tiles_to_plane(int_c[:, 1], ctbc).to(out_dtype)

            def unstack(lv, inv, n):
                flat = lv.reshape(-1, n, n)
                flat = torch.cat([flat, torch.zeros((1, n, n),
                                                    dtype=flat.dtype,
                                                    device=dev)])
                return flat[T(inv).long()]

            lv16_y = unstack(lv16_s, inv16, 16)
            lv8_cb = unstack(lv8_s[:, :, 0], inv16, 8)
            lv8_cr = unstack(lv8_s[:, :, 1], inv16, 8)
            if has32:
                lv32_y = unstack(lv32_s, inv32, 32)
                lv16_cb = unstack(lvc16_s[:, :, 0], inv32, 16)
                lv16_cr = unstack(lvc16_s[:, :, 1], inv32, 16)
                use32_out = torch.cat(
                    [u32_s.reshape(-1),
                     torch.zeros((1,), dtype=torch.bool, device=dev)])[
                         T(inv32).long()]
            else:
                lv32_y = lv16_cb = lv16_cr = None
                use32_out = torch.zeros((B32,), dtype=torch.bool, device=dev)
            if tu8_s is not None:
                tu8_out = torch.cat(
                    [tu8_s.reshape(-1),
                     torch.zeros((1,), dtype=torch.bool, device=dev)])[
                         T(inv16).long()]
            else:
                tu8_out = torch.zeros((B16,), dtype=torch.bool, device=dev)
            nr_out = None
            if nr is not None:
                lay, _ = nr_layout()
                nr_out = {}
                for cat, _n in NR_CATS:
                    if not has32 and cat in ("y32", "c16"):
                        continue
                    o, nn = lay[cat]
                    nr_out[cat] = (nr[o:o + nn], nr[o + nn],
                                   nr[o + nn + 1:o + 2 * nn + 1],
                                   nr[o + 2 * nn + 1])
            return (rec_y, rec_cb, rec_cr, lv16_y, lv8_cb, lv8_cr,
                    lv32_y, lv16_cb, lv16_cr, use32_out, tu8_out, nr_out)

        return run


def _to_blocks(pl, n):
    """[..., ph, pw] planes -> [..., B, n, n] blocks in raster order."""
    ph, pw = pl.shape[-2:]
    return pl.reshape(-1, ph // n, n, pw // n, n).permute(
        0, 1, 3, 2, 4).reshape(pl.shape[:-2] + (-1, n, n))


def _split4(x, m):
    """[K, 2m, 2m] -> [4K, m, m]: the z-order quadrants, quadrant-major."""
    K = x.shape[0]
    return x.reshape(K, 2, m, 2, m).permute(1, 3, 0, 2, 4).reshape(
        4 * K, m, m)


def _join4(x, m):
    """[4K, m, m] z-order quadrants -> [K, 2m, 2m] (inverse of
    ``_split4``)."""
    K = x.shape[0] // 4
    return x.reshape(2, 2, K, m, m).permute(2, 0, 3, 1, 4).reshape(
        K, 2 * m, 2 * m)


def _inv_perm(tab_src, bn):
    """Static inverse permutation of a level stack to block raster order;
    blocks outside every level read the appended zero row."""
    flat = np.swapaxes(np.asarray(tab_src), 1, 2).reshape(-1)
    inv = np.full(bn, len(flat), np.int64)
    valid = flat < bn
    inv[flat[valid]] = np.nonzero(valid)[0]
    return inv
