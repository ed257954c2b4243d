"""Decoder-side reconstruction on the host: CU/TU traversal in decode
order and the normative prediction / dequant / inverse-transform / recon
chain, intra and inter (MC, weighted and bi-prediction) — ITU-T H.265
§8.4, §8.5.3.3, §8.6; ``x265_tpu/common/recon.py``, copied line for line.

This numpy path is the spec oracle the decoder runs for every picture that
the batched wavefront recon (``encoder/wavefront.py``) does not take.
"""

from __future__ import annotations

import numpy as np

from ..cabac.ctu import MODE_INTRA, PicSyntax, chroma_qp
from ..ops.intra import (filter_flag, filter_reference_np, predict_intra_np,
                         substitute_references_np)
from ..ops.quantize import dequant_np
from ..ops.transforms import inverse_transform_np
from .geometry import PictureGeometry, intra_neighbor_coords


def cu_leaves(ps: PicSyntax, ctu_addr: int, log2_min_cb: int = 3):
    """Yield (x0, y0, log2_size) of CUs in a CTU in z-order (decode order)."""
    g = ps.geom

    def rec(x0, y0, log2_size, depth):
        size = 1 << log2_size
        if x0 >= g.width or y0 >= g.height:
            return
        fits = x0 + size <= g.width and y0 + size <= g.height
        split = ps.depth[y0 >> 2, x0 >> 2] > depth or not fits
        if split and log2_size > log2_min_cb:
            half = size >> 1
            for i in range(4):
                rec(x0 + (i & 1) * half, y0 + (i >> 1) * half,
                    log2_size - 1, depth + 1)
        else:
            yield_list.append((x0, y0, log2_size))

    yield_list = []
    x0, y0 = g.ctu_origin(ctu_addr)
    rec(x0, y0, g.log2_ctb, 0)
    return yield_list


def tu_leaves(ps: PicSyntax, x0: int, y0: int, log2_cb: int,
              log2_max_tb: int = 5):
    """Yield (x, y, log2_tb, depth) luma TU leaves of a CU in z-order."""
    intra_split = bool(ps.part[y0 >> 2, x0 >> 2])
    out = []

    def rec(x, y, log2_size, depth):
        forced = (log2_size > log2_max_tb
                  or (intra_split and depth == 0 and log2_size > 2))
        split = forced or ps.tu_depth[y >> 2, x >> 2] > depth
        if split:
            half = 1 << (log2_size - 1)
            for i in range(4):
                rec(x + (i & 1) * half, y + (i >> 1) * half,
                    log2_size - 1, depth + 1)
        else:
            out.append((x, y, log2_size, depth))

    rec(x0, y0, log2_cb, 0)
    return out


def chroma_tu_leaves(ps: PicSyntax, x0: int, y0: int, log2_cb: int,
                     log2_max_tb: int = 5):
    """Chroma TU leaves (4:2:0): like tu_leaves but a luma 8x8 node is a
    chroma leaf (chroma 4x4 is never split).  Returns luma coords +
    log2 chroma size."""
    out = []

    def rec(x, y, log2_size, depth):
        forced = log2_size > log2_max_tb
        split = forced or ps.tu_depth[y >> 2, x >> 2] > depth
        if split and log2_size > 3:
            half = 1 << (log2_size - 1)
            for i in range(4):
                rec(x + (i & 1) * half, y + (i >> 1) * half,
                    log2_size - 1, depth + 1)
        else:
            out.append((x, y, log2_size - 1))

    rec(x0, y0, log2_cb, 0)
    return out


def gather_reference(plane: np.ndarray, geom: PictureGeometry, x0: int,
                     y0: int, n: int, bit_depth: int, *, chroma_shift: int = 0,
                     constrained: bool = False,
                     pred_mode: np.ndarray | None = None) -> np.ndarray:
    """Build the substituted canonical 4N+1 reference vector for a block at
    (x0, y0) of the given plane.  For chroma, coords/plane are in chroma
    units and ``chroma_shift=1`` maps to luma for availability."""
    xs, ys = intra_neighbor_coords(x0, y0, n)
    lx, ly = xs << chroma_shift, ys << chroma_shift
    avail = geom.avail_rows(x0 << chroma_shift, y0 << chroma_shift, lx, ly)
    if constrained and pred_mode is not None:
        lxc = np.clip(lx, 0, geom.width - 1)
        lyc = np.clip(ly, 0, geom.height - 1)
        avail &= pred_mode[lyc >> 2, lxc >> 2] == MODE_INTRA
    h, w = plane.shape
    samples = plane[np.clip(ys, 0, h - 1), np.clip(xs, 0, w - 1)]
    return substitute_references_np(samples.astype(np.int32), avail,
                                    bit_depth)


def strong_smooth_reference(ref: np.ndarray, n: int, bit_depth: int) -> np.ndarray:
    """§8.4.4.2.3 strong (bilinear) intra smoothing for 32x32 luma TBs."""
    out = ref.copy()
    bl = ref[0]           # p[-1][63]
    corner = ref[2 * n]
    tr = ref[4 * n]       # p[63][-1]
    left_mid = ref[n]     # p[-1][31]  (index: left i=31 -> 2n-1-31 = n... )
    # canonical layout: left i -> index 2n-1-i; top i -> 2n+1+i
    p_m1_31 = ref[2 * n - 1 - 31]
    p_31_m1 = ref[2 * n + 1 + 31]
    thresh = 1 << (bit_depth - 5)
    if abs(int(corner) + int(tr) - 2 * int(p_31_m1)) < thresh and \
       abs(int(corner) + int(bl) - 2 * int(p_m1_31)) < thresh:
        # top run: p[i][-1] = ((63-i)*corner + (i+1)*p[63][-1] + 32) >> 6
        i = np.arange(63)
        out[2 * n + 1: 2 * n + 1 + 63] = (
            (63 - i) * int(corner) + (i + 1) * int(tr) + 32) >> 6
        # left run: p[-1][i] = ((63-i)*corner + (i+1)*p[-1][63] + 32) >> 6
        out_idx = 2 * n - 1 - i
        out[out_idx] = ((63 - i) * int(corner) + (i + 1) * int(bl) + 32) >> 6
    else:
        out = filter_reference_np(ref)
    return out


def reconstruct_tu(plane: np.ndarray, coeff: np.ndarray,
                   geom: PictureGeometry, ps: PicSyntax, x0: int, y0: int,
                   log2_size: int, mode: int, qp: int, bit_depth: int, *,
                   is_luma: bool, chroma_shift: int = 0,
                   strong_smoothing: bool = False,
                   bypass: bool = False) -> None:
    """Predict + add residual for one TB, in place.  Coords in plane units.

    ``bypass``: cu_transquant_bypass (§8.6.6 lossless) — the coded block
    IS the residual; dequant and the inverse transform are skipped.
    Intra reference smoothing still applies (v1 has no bypass condition
    in §8.4.4.2.3; the encoder mirrors it, keeping recon bit-exact).
    """
    n = 1 << log2_size
    ref = gather_reference(plane, geom, x0, y0, n, bit_depth,
                           chroma_shift=chroma_shift)
    if filter_flag(mode, n, is_luma):
        if strong_smoothing and n == 32:
            ref = strong_smooth_reference(ref, n, bit_depth)
        else:
            ref = filter_reference_np(ref)
    pred = predict_intra_np(mode, ref, n, is_luma=is_luma,
                            bit_depth=bit_depth, already_filtered=True)
    block = coeff[y0:y0 + n, x0:x0 + n]
    if np.any(block):
        if bypass:
            resi = block
        else:
            dq = dequant_np(block, qp, bit_depth)
            resi = inverse_transform_np(dq, bit_depth,
                                        dst=(is_luma and n == 4))
        rec = np.clip(pred + resi, 0, (1 << bit_depth) - 1)
    else:
        rec = pred
    plane[y0:y0 + n, x0:x0 + n] = rec.astype(plane.dtype)


def add_residual(plane, coeff, pred, x0, y0, n, qp, bit_depth, *, dst=False,
                 bypass=False):
    """recon = clip(pred + IT(dequant(coeff block))), written into plane.
    With ``bypass`` the coeff block IS the residual (lossless)."""
    block = coeff[y0:y0 + n, x0:x0 + n]
    if np.any(block):
        if bypass:
            resi = block
        else:
            dq = dequant_np(block, qp, bit_depth)
            resi = inverse_transform_np(dq, bit_depth, dst=dst)
        rec = np.clip(pred + resi, 0, (1 << bit_depth) - 1)
    else:
        rec = pred
    plane[y0:y0 + n, x0:x0 + n] = rec.astype(plane.dtype)


def _weight_uni(ps_block, w, o, denom, bit_depth):
    """§8.5.3.3.4.2 explicit uni weighting of a 14-bit intermediate."""
    log2wd = denom + 14 - bit_depth
    obd = o << (bit_depth - 8)
    maxv = (1 << bit_depth) - 1
    v = ps_block.astype(np.int64) * w
    if log2wd >= 1:
        v = (v + (1 << (log2wd - 1))) >> log2wd
    return np.clip(v + obd, 0, maxv).astype(np.int32)


def _inter_pred(ps: PicSyntax, refs_l0, refs_l1, cx, cy, size, bit_depth,
                weights=None):
    """Uni- or bi-directional MC prediction for a 2Nx2N PU (§8.5.3.3.3):
    uni uses the pp path (or the explicit weighted ps path when a
    pred_weight_table entry applies); bi combines two 14-bit
    intermediates."""
    from ..ops.interp import (bi_avg_np, mc_chroma_np, mc_chroma_ps_np,
                              mc_luma_np, mc_luma_ps_np)

    y4, x4 = cy >> 2, cx >> 2
    d = int(ps.inter_dir[y4, x4]) or 1
    csz = size >> 1
    if d != 3:
        refs = refs_l0 if d == 1 else refs_l1
        mv = ps.mv0[y4, x4] if d == 1 else ps.mv1[y4, x4]
        ridx = int((ps.ref_idx0 if d == 1 else ps.ref_idx1)[y4, x4])
        ref = refs[ridx]
        mvx, mvy = int(mv[0]), int(mv[1])
        wl = (weights.weights_l0 if d == 1 else weights.weights_l1) \
            if weights is not None else []
        ent = wl[ridx] if ridx < len(wl) else None
        if ent is not None and ent[0]:        # luma weight flag
            py = _weight_uni(
                mc_luma_ps_np(ref[0], cx, cy, size, size, mvx, mvy,
                              bit_depth),
                ent[1], ent[2], weights.luma_log2_weight_denom, bit_depth)
        else:
            py = mc_luma_np(ref[0], cx, cy, size, size, mvx, mvy,
                            bit_depth)
        if ent is not None and ent[3]:        # chroma weight flag
            dc = weights.chroma_log2_weight_denom
            pcb = _weight_uni(
                mc_chroma_ps_np(ref[1], cx >> 1, cy >> 1, csz, csz, mvx,
                                mvy, bit_depth), ent[4], ent[5], dc,
                bit_depth)
            pcr = _weight_uni(
                mc_chroma_ps_np(ref[2], cx >> 1, cy >> 1, csz, csz, mvx,
                                mvy, bit_depth), ent[6], ent[7], dc,
                bit_depth)
        else:
            pcb = mc_chroma_np(ref[1], cx >> 1, cy >> 1, csz, csz, mvx,
                               mvy, bit_depth)
            pcr = mc_chroma_np(ref[2], cx >> 1, cy >> 1, csz, csz, mvx,
                               mvy, bit_depth)
        return py, pcb, pcr
    ri0 = int(ps.ref_idx0[y4, x4])
    ri1 = int(ps.ref_idx1[y4, x4])
    r0 = refs_l0[ri0]
    r1 = refs_l1[ri1]
    mv0, mv1 = ps.mv0[y4, x4], ps.mv1[y4, x4]
    x0i, y0i = int(mv0[0]), int(mv0[1])
    x1i, y1i = int(mv1[0]), int(mv1[1])
    e0 = e1 = None
    if weights is not None:
        wl0, wl1 = weights.weights_l0, weights.weights_l1
        e0 = wl0[ri0] if ri0 < len(wl0) else None
        e1 = wl1[ri1] if ri1 < len(wl1) else None
    out = []
    for pl, fn, (px, py, n) in (
            (0, mc_luma_ps_np, (cx, cy, size)),
            (1, mc_chroma_ps_np, (cx >> 1, cy >> 1, csz)),
            (2, mc_chroma_ps_np, (cx >> 1, cy >> 1, csz))):
        p0 = fn(r0[pl], px, py, n, n, x0i, y0i, bit_depth)
        p1 = fn(r1[pl], px, py, n, n, x1i, y1i, bit_depth)
        # explicit weighted bi-prediction (§8.5.3.3.4.3): applies when
        # either list's weight flag is set for this plane; unflagged
        # lists use the unity weight at the table's denom
        fi = 0 if pl == 0 else 3          # luma vs chroma flag index
        f0 = bool(e0 and e0[fi])
        f1 = bool(e1 and e1[fi])
        if f0 or f1:
            denom = (weights.luma_log2_weight_denom if pl == 0
                     else weights.chroma_log2_weight_denom)
            unity = 1 << denom
            if pl == 0:
                w0, o0 = (e0[1], e0[2]) if f0 else (unity, 0)
                w1, o1 = (e1[1], e1[2]) if f1 else (unity, 0)
            else:
                k = 4 if pl == 1 else 6
                w0, o0 = (e0[k], e0[k + 1]) if f0 else (unity, 0)
                w1, o1 = (e1[k], e1[k + 1]) if f1 else (unity, 0)
            log2wd = denom + 14 - bit_depth
            ob0 = o0 << (bit_depth - 8)
            ob1 = o1 << (bit_depth - 8)
            v = (p0.astype(np.int64) * w0 + p1.astype(np.int64) * w1
                 + ((ob0 + ob1 + 1) << log2wd)) >> (log2wd + 1)
            out.append(np.clip(v, 0,
                               (1 << bit_depth) - 1).astype(np.int32))
        else:
            out.append(bi_avg_np(p0, p1, bit_depth))
    return tuple(out)


def reconstruct_inter_cu(ps: PicSyntax, planes, ref_planes, cx: int, cy: int,
                         log2_cb: int, qps, bit_depth: int = 8,
                         refs_l1=None, weights=None) -> None:
    """MC prediction + residual for one 2Nx2N inter CU (uni L0/L1 or bi).
    The residual is added per TU LEAF (the TU tree may split while the
    prediction covers the whole CU).

    ``ref_planes``: either a single (Y, Cb, Cr) tuple (legacy P, one ref)
    or a list of such tuples (L0); ``refs_l1``: list for L1 (B slices).
    """
    qp_y, qp_cb, qp_cr = qps
    size = 1 << log2_cb
    refs_l0 = (ref_planes if isinstance(ref_planes, list)
               else [ref_planes])
    pred_y, pred_cb, pred_cr = _inter_pred(
        ps, refs_l0, refs_l1 or [], cx, cy, size, bit_depth,
        weights=weights)
    byp = bool(ps.tq_bypass[cy >> 2, cx >> 2])
    for (tx, ty, log2_tb, _d) in tu_leaves(ps, cx, cy, log2_cb):
        n = 1 << log2_tb
        add_residual(planes[0], ps.coeff_y,
                     pred_y[ty - cy:ty - cy + n, tx - cx:tx - cx + n],
                     tx, ty, n, qp_y, bit_depth, bypass=byp)
    for (tx, ty, clog2) in chroma_tu_leaves(ps, cx, cy, log2_cb):
        n = 1 << clog2
        ox, oy = (tx - cx) >> 1, (ty - cy) >> 1
        add_residual(planes[1], ps.coeff_cb, pred_cb[oy:oy + n, ox:ox + n],
                     (cx >> 1) + ox, (cy >> 1) + oy, n, qp_cb, bit_depth,
                     bypass=byp)
        add_residual(planes[2], ps.coeff_cr, pred_cr[oy:oy + n, ox:ox + n],
                     (cx >> 1) + ox, (cy >> 1) + oy, n, qp_cr, bit_depth,
                     bypass=byp)


def reconstruct_picture(ps: PicSyntax, planes, qp_y: int, bit_depth: int = 8,
                        cb_qp_offset: int = 0, cr_qp_offset: int = 0,
                        strong_smoothing: bool = False,
                        ref_planes=None, refs_l1=None,
                        weights=None) -> None:
    """Full decoder-side reconstruction of a picture, in place.

    ``planes`` = (Y, Cb, Cr) int16 numpy arrays at coded (padded) size;
    ``ref_planes`` = L0 reference(s): one (Y, Cb, Cr) tuple or a list of
    them; ``refs_l1`` = list of L1 references (B slices).
    """
    from ..cabac.ctu import MODE_INTRA as _INTRA

    g = ps.geom
    y_pl, cb_pl, cr_pl = planes
    bd_off = 6 * (bit_depth - 8)      # QpBdOffset (§8.6.1 Qp' derivation)
    qp_cb0 = chroma_qp(qp_y, cb_qp_offset) + bd_off
    qp_cr0 = chroma_qp(qp_y, cr_qp_offset) + bd_off
    qp_y0 = qp_y + bd_off
    for ctu in range(g.n_ctbs):
        if ps.cu_qp_delta_enabled:
            # QG == CTB: every CU in the CTB shares the signaled QP
            q = int(ps.qp_ctb[ctu])
            qp_y = q + bd_off
            qp_cb = chroma_qp(q, cb_qp_offset) + bd_off
            qp_cr = chroma_qp(q, cr_qp_offset) + bd_off
        else:
            qp_y, qp_cb, qp_cr = qp_y0, qp_cb0, qp_cr0
        for (cx, cy, log2_cb) in cu_leaves(ps, ctu):
            if ps.pred_mode[cy >> 2, cx >> 2] != _INTRA:
                reconstruct_inter_cu(ps, planes, ref_planes, cx, cy,
                                     log2_cb, (qp_y, qp_cb, qp_cr),
                                     bit_depth, refs_l1=refs_l1,
                                     weights=weights)
                continue
            byp = bool(ps.tq_bypass[cy >> 2, cx >> 2])
            for (tx, ty, log2_tb, _d) in tu_leaves(ps, cx, cy, log2_cb):
                mode = int(ps.luma_mode[ty >> 2, tx >> 2])
                reconstruct_tu(y_pl, ps.coeff_y, g, ps, tx, ty, log2_tb,
                               mode, qp_y, bit_depth, is_luma=True,
                               strong_smoothing=strong_smoothing,
                               bypass=byp)
            cmode = int(ps.chroma_mode[cy >> 2, cx >> 2])
            for (tx, ty, log2_cb_tb) in chroma_tu_leaves(ps, cx, cy, log2_cb):
                reconstruct_tu(cb_pl, ps.coeff_cb, g, ps, tx >> 1, ty >> 1,
                               log2_cb_tb, cmode, qp_cb, bit_depth,
                               is_luma=False, chroma_shift=1, bypass=byp)
                reconstruct_tu(cr_pl, ps.coeff_cr, g, ps, tx >> 1, ty >> 1,
                               log2_cb_tb, cmode, qp_cr, bit_depth,
                               is_luma=False, chroma_shift=1, bypass=byp)
