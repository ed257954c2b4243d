"""HEVC deblocking (H.265 §8.7.2) on whole padded planes — torch twin of
``x265_tpu.ops.deblock.deblock_picture_jnp``, and the decoder's deblocking.

Vertical edges on the 8-px grid tile the plane exactly, so each direction
is reshape -> batched segment filter -> reshape; the horizontal pass runs
on the transposed output.  The spec tables, the chroma QP map and the static
edge masks are copies of the reference's numpy helpers.

The decoder derives the boundary strengths and the per-edge QPs on the
host from the parsed ``PicSyntax`` (``derive_edge_flags``, ``derive_bs``,
``qp4_per_cu``: copies of the reference's, line for line) and filters the
picture's planes on their device (``deblock_decoded_picture``), with the
maps ``deblock_picture_np`` builds.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from .._util import dev_table
from ..cabac.ctu import _CHROMA_QP_MAP

# §8.7.2.5.3 Table 8-12: beta'(Q) and tc'(Q)
BETA_TABLE = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24,
     26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56,
     58, 60, 62, 64], dtype=np.int32)
TC_TABLE = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4,
     4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24],
    dtype=np.int32)


def _chroma_qp_arr(qp: np.ndarray, offset: int) -> np.ndarray:
    """Vectorized §8.6.1 chroma QP mapping (4:2:0) for per-edge QP maps."""
    qpi = np.clip(qp + offset, -12, 57)
    return np.where(qpi < 30, np.maximum(0, qpi),
                    np.where(qpi > 43, qpi - 6,
                             _CHROMA_QP_MAP[np.clip(qpi - 30, 0, 13)]))


def edge_masks_np(geom, log2_ctb: int):
    """Static 16-grid TU edge masks over the PADDED plane, with picture
    (coded-size) boundary edges excluded.  [h4p, w4p] bool x2 + a mask of
    4x4 units inside the coded picture (for BS gating)."""
    ph = geom.ctbs_h << log2_ctb
    pw = geom.ctbs_w << log2_ctb
    h4p, w4p = ph // 4, pw // 4
    x4 = np.arange(w4p)[None, :]
    y4 = np.arange(h4p)[:, None]
    inside = (x4 * 4 < geom.width) & (y4 * 4 < geom.height)
    ev = (x4 % 4 == 0) & (x4 > 0) & inside
    eh = (y4 % 4 == 0) & (y4 > 0) & inside
    return (np.broadcast_to(ev, (h4p, w4p)).copy(),
            np.broadcast_to(eh, (h4p, w4p)).copy(),
            np.broadcast_to(inside, (h4p, w4p)).copy())


def _lookup(table, name, idx):
    return dev_table(name, lambda: table, idx.device)[idx.long()]


def _luma_seg_filter(seg, bs, qp, bit_depth, beta_off, tc_off):
    """seg [E, 4, 8] int32; bs [E]; qp [E] -> filtered [E, 4, 8]."""
    shift = bit_depth - 8
    qb = (qp + beta_off * 2).clamp(0, 51)
    qt = (qp + 2 * (bs - 1) + tc_off * 2).clamp(0, 53)
    beta = (_lookup(BETA_TABLE, "beta", qb) << shift)[:, None]
    tc = (_lookup(TC_TABLE, "tc", qt) << shift)[:, None]

    p3, p2, p1, p0 = (seg[:, :, i] for i in range(4))
    q0, q1, q2, q3 = (seg[:, :, i] for i in range(4, 8))
    dp0 = (p2[:, 0] - 2 * p1[:, 0] + p0[:, 0]).abs()
    dp3 = (p2[:, 3] - 2 * p1[:, 3] + p0[:, 3]).abs()
    dq0 = (q2[:, 0] - 2 * q1[:, 0] + q0[:, 0]).abs()
    dq3 = (q2[:, 3] - 2 * q1[:, 3] + q0[:, 3]).abs()
    dpq0, dpq3 = dp0 + dq0, dp3 + dq3
    dp, dq = dp0 + dp3, dq0 + dq3
    b1 = beta[:, 0]
    t1 = tc[:, 0]
    filter_on = (dpq0 + dpq3 < b1) & (bs > 0) & (t1 > 0)

    def strong_cond(dpq, i):
        return ((2 * dpq < (b1 >> 2))
                & ((p3[:, i] - p0[:, i]).abs() + (q0[:, i] - q3[:, i]).abs()
                   < (b1 >> 3))
                & ((p0[:, i] - q0[:, i]).abs() < ((5 * t1 + 1) >> 1)))

    strong = strong_cond(dpq0, 0) & strong_cond(dpq3, 3)

    def c3(lo, hi, v):
        return torch.minimum(torch.maximum(v, lo), hi)

    sp0 = c3(p0 - 2 * tc, p0 + 2 * tc,
             (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3)
    sp1 = c3(p1 - 2 * tc, p1 + 2 * tc, (p2 + p1 + p0 + q0 + 2) >> 2)
    sp2 = c3(p2 - 2 * tc, p2 + 2 * tc,
             (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3)
    sq0 = c3(q0 - 2 * tc, q0 + 2 * tc,
             (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3)
    sq1 = c3(q1 - 2 * tc, q1 + 2 * tc, (p0 + q0 + q1 + q2 + 2) >> 2)
    sq2 = c3(q2 - 2 * tc, q2 + 2 * tc,
             (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3)

    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    w_on = delta.abs() < tc * 10
    dlt = c3(-tc, tc, delta)
    maxval = (1 << bit_depth) - 1
    wp0 = (p0 + dlt).clamp(0, maxval)
    wq0 = (q0 - dlt).clamp(0, maxval)
    side_thresh = (b1 + (b1 >> 1)) >> 3
    dEp1 = (dp < side_thresh)[:, None]
    dEq1 = (dq < side_thresh)[:, None]
    tc2 = tc >> 1
    dp1 = c3(-tc2, tc2, (((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1)
    dq1 = c3(-tc2, tc2, (((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1)
    wp1 = (p1 + dp1).clamp(0, maxval)
    wq1 = (q1 + dq1).clamp(0, maxval)

    on = filter_on[:, None]
    st = strong[:, None] & on
    wk = (~strong[:, None]) & on & w_on
    out = seg.clone()
    out[:, :, 1] = torch.where(st, sp2, p2)
    out[:, :, 2] = torch.where(st, sp1, torch.where(wk & dEp1, wp1, p1))
    out[:, :, 3] = torch.where(st, sp0, torch.where(wk, wp0, p0))
    out[:, :, 4] = torch.where(st, sq0, torch.where(wk, wq0, q0))
    out[:, :, 5] = torch.where(st, sq1, torch.where(wk & dEq1, wq1, q1))
    out[:, :, 6] = torch.where(st, sq2, q2)
    return out


def _chroma_seg_filter(seg, bs, qp, bit_depth, tc_off):
    """seg [E, 4, 4] int32 (p1 p0 q0 q1); filters only where bs == 2."""
    shift = bit_depth - 8
    qt = (qp + 2 + tc_off * 2).clamp(0, 53)
    tc = (_lookup(TC_TABLE, "tc", qt) << shift)
    tc = torch.where(bs == 2, tc, 0)[:, None]
    p1, p0, q0, q1 = (seg[:, :, i] for i in range(4))
    delta = torch.minimum(torch.maximum(
        (((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc), tc)
    maxval = (1 << bit_depth) - 1
    out = seg.clone()
    out[:, :, 1] = (p0 + delta).clamp(0, maxval)
    out[:, :, 2] = (q0 - delta).clamp(0, maxval)
    return out


def _deblock_dir(plane, bs_edge, qp, bit_depth, beta_off, tc_off, chroma):
    """Vertical edges of one plane: plane [H, W] int32, bs_edge and qp
    [H//4, nk] for the edges at x = 8(k+1)."""
    H, W = plane.shape
    G = 8
    R = 2 if chroma else 4
    nk = W // G - 1
    if nk < 1:
        return plane
    x0 = G - R
    seg = plane[:, x0:x0 + nk * G].reshape(H // 4, 4, nk, G).permute(
        0, 2, 1, 3).reshape(-1, 4, G)
    bs = bs_edge.reshape(-1)
    qp = qp.reshape(-1)
    if chroma:
        f = seg.clone()
        f[:, :, :2 * R] = _chroma_seg_filter(seg[:, :, :2 * R], bs, qp,
                                             bit_depth, tc_off)
    else:
        f = _luma_seg_filter(seg, bs, qp, bit_depth, beta_off, tc_off)
    win = f.reshape(H // 4, nk, 4, G).permute(0, 2, 1, 3).reshape(H, nk * G)
    out = plane.clone()
    out[:, x0:x0 + nk * G] = win
    return out


def deblock_plane(plane, bs_v, bs_h, qp, bit_depth=8, beta_off=0, tc_off=0,
                  *, chroma=False):
    """Both directions of one plane; qp = (qp_v, qp_h) per-edge maps
    [H//4, W//4] or one scalar QP."""
    H, W = plane.shape
    nkv = W // 8 - 1
    nkh = H // 8 - 1
    per_edge = isinstance(qp, tuple)

    def full(q, shape):
        with trace.sync():
            q = torch.as_tensor(q, dtype=torch.int32, device=plane.device)
        return q.expand(shape)

    if nkv >= 1:
        bsv = bs_v[:, 2::2][:, :nkv]
        q = qp[0][:, 2::2][:, :nkv] if per_edge else full(qp, bsv.shape)
        plane = _deblock_dir(plane, bsv, q, bit_depth, beta_off, tc_off,
                             chroma)
    if nkh >= 1:
        bsh = bs_h[2::2, :][:nkh].T
        q = qp[1][2::2, :][:nkh].T if per_edge else full(qp, bsh.shape)
        plane = _deblock_dir(plane.T.contiguous(), bsh, q, bit_depth,
                             beta_off, tc_off, chroma).T.contiguous()
    return plane


def deblock_picture(planes, intra4, cbf4, mv4, use32, static_masks,
                    qp_y, qp_cb, qp_cr, bit_depth=8, beta_off=0, tc_off=0,
                    motion_b=None):
    """Deblock a whole reconstructed picture (padded planes, int32).

    Same contract as ``deblock_picture_jnp``: intra4/cbf4 [h4p, w4p] bool,
    mv4 [h4p, w4p, 2] qpel, use32 [PH//32, PW//32] or None, static_masks
    from ``x265_tpu.ops.deblock.edge_masks_np``, motion_b the two-list
    (nmv, mva, mvb, poca, pocb) planes or None for one-list P motion."""
    dev = planes[0].device
    with trace.sync():
        ev0, eh0, _inside = (torch.as_tensor(m, device=dev)
                             for m in static_masks)
    h4p, w4p = ev0.shape
    if use32 is not None:
        u4 = use32.repeat_interleave(8, 0).repeat_interleave(8, 1)
        x4 = torch.arange(w4p, device=dev)[None, :]
        y4 = torch.arange(h4p, device=dev)[:, None]
        ev = ev0 & ~(u4 & (x4 % 8 == 4))
        eh = eh0 & ~(u4 & (y4 % 8 == 4))
    else:
        ev, eh = ev0, eh0
    mv = mv4.to(torch.int32)

    def ge4(a, b):
        return ((a - b).abs() >= 4).any(-1)

    def bs_dir(edge, axis):
        p_intra = torch.roll(intra4, 1, dims=axis)
        p_cbf = torch.roll(cbf4, 1, dims=axis)
        if motion_b is None:
            mv_big = ge4(mv, torch.roll(mv, 1, dims=axis))
        else:
            nmv, mva, mvb, poca, pocb = motion_b
            pn = torch.roll(nmv, 1, dims=axis)
            pmva = torch.roll(mva, 1, dims=axis)
            pmvb = torch.roll(mvb, 1, dims=axis)
            ppoca = torch.roll(poca, 1, dims=axis)
            ppocb = torch.roll(pocb, 1, dims=axis)
            set_eq = (((poca == ppoca) & (pocb == ppocb))
                      | ((poca == ppocb) & (pocb == ppoca)))
            aligned = ge4(mva, pmva) | ge4(mvb, pmvb)
            crossed = ge4(mva, pmvb) | ge4(mvb, pmva)
            align_ok = torch.where(poca == ppoca, aligned,
                                   torch.where(poca == ppocb, crossed, True))
            bi_diff = torch.where(poca == pocb, aligned & crossed, align_ok)
            mv_big = torch.where(nmv != pn, True,
                                 torch.where(~set_eq, True, bi_diff))
        bs = torch.where(intra4 | p_intra, 2,
                         torch.where(cbf4 | p_cbf | mv_big, 1, 0))
        return torch.where(edge, bs, 0).to(torch.int32)

    bs_v = bs_dir(ev, 1)
    bs_h = bs_dir(eh, 0)
    y = deblock_plane(planes[0].to(torch.int32), bs_v, bs_h, qp_y,
                      bit_depth, beta_off, tc_off)
    h4c, w4c = h4p // 2, w4p // 2
    cv = torch.zeros((h4c, w4c), dtype=torch.int32, device=dev)
    chm = torch.zeros((h4c, w4c), dtype=torch.int32, device=dev)
    cv[:, 0::2] = torch.where(bs_v[::2, 0::4] == 2, 2, 0).to(torch.int32)
    chm[0::2, :] = torch.where(bs_h[0::4, ::2] == 2, 2, 0).to(torch.int32)
    cb = deblock_plane(planes[1].to(torch.int32), cv, chm, qp_cb, bit_depth,
                       tc_off=tc_off, chroma=True)
    cr = deblock_plane(planes[2].to(torch.int32), cv, chm, qp_cr, bit_depth,
                       tc_off=tc_off, chroma=True)
    return y, cb, cr


def derive_edge_flags(ps):
    """TU/CU boundary flags + per-4x4 luma-cbf map at 4x4 luma granularity.

    edge_v[y4, x4] = vertical edge along the LEFT side of that 4x4 block;
    picture-boundary edges excluded (§8.7.2: not filtered).  cbf4 marks
    4x4 blocks whose containing luma TU has nonzero coefficients (used by
    the BS=1 derivation).  2Nx2N PUs: PU edges coincide with CU edges.
    """
    from ..common.recon import cu_leaves, tu_leaves

    g = ps.geom
    ev = np.zeros((g.h4, g.w4), bool)
    eh = np.zeros((g.h4, g.w4), bool)
    cbf4 = np.zeros((g.h4, g.w4), bool)
    for ctu in range(g.n_ctbs):
        for (cx, cy, log2_cb) in cu_leaves(ps, ctu):
            for (tx, ty, log2_tb, _d) in tu_leaves(ps, cx, cy, log2_cb):
                n4 = 1 << (log2_tb - 2)
                ty4, tx4 = ty >> 2, tx >> 2
                if tx > 0:
                    ev[ty4:ty4 + n4, tx4] = True
                if ty > 0:
                    eh[ty4, tx4:tx4 + n4] = True
                sz = 1 << log2_tb
                if np.any(ps.coeff_y[ty:ty + sz, tx:tx + sz]):
                    cbf4[ty4:ty4 + n4, tx4:tx4 + n4] = True
    return ev, eh, cbf4


def motion_bs_planes(ps):
    """Per-4x4 motion-comparison state for the BS derivation (§8.7.2.4):

    Returns (nmv, mva, mvb, poca, pocb) where nmv is 1/2, mva/mvb the
    (up to) two MVs with their reference POCs; uni-predicted blocks
    duplicate their single (mv, poc) into both slots.
    """
    d = np.where(ps.inter_dir == 0, 1, ps.inter_dir).astype(np.int32)
    pocs0 = np.asarray(ps.ref_pocs_l0 if len(ps.ref_pocs_l0) else [0],
                       np.int32)
    pocs1 = np.asarray(ps.ref_pocs_l1 if len(ps.ref_pocs_l1) else [0],
                       np.int32)
    poc_l0 = pocs0[np.minimum(ps.ref_idx0.astype(np.int32),
                              len(pocs0) - 1)]
    poc_l1 = pocs1[np.minimum(ps.ref_idx1.astype(np.int32),
                              len(pocs1) - 1)]
    mv0 = ps.mv0.astype(np.int32)
    mv1 = ps.mv1.astype(np.int32)
    nmv = np.where(d == 3, 2, 1)
    # slot A: L0 motion unless the block is uni-L1
    use_l1a = d == 2
    mva = np.where(use_l1a[..., None], mv1, mv0)
    poca = np.where(use_l1a, poc_l1, poc_l0)
    # slot B: L1 motion for bi, duplicate of A for uni
    mvb = np.where((d == 3)[..., None], mv1, mva)
    pocb = np.where(d == 3, poc_l1, poca)
    return nmv, mva, mvb, poca, pocb


def derive_bs(ps, ev, eh, cbf4):
    """Boundary strength per edge (§8.7.2.4): (bs_v, bs_h) uint8 arrays.

    2 = either side intra; 1 = nonzero luma coeffs in either TU, or
    motion mismatch: different MV count, different reference pictures,
    or any MV delta >= 1 luma sample (4 qpel) — with the both-orderings
    check when a bi block's two references are the same picture.
    """
    from ..cabac.ctu import MODE_INTRA as _INTRA

    intra4 = ps.pred_mode == _INTRA
    nmv, mva, mvb, poca, pocb = motion_bs_planes(ps)

    def ge4(a, b):
        return np.any(np.abs(a - b) >= 4, axis=-1)

    def bs_dir(edge, axis):
        p_intra = np.roll(intra4, 1, axis=axis)
        p_cbf = np.roll(cbf4, 1, axis=axis)
        pn = np.roll(nmv, 1, axis=axis)
        pmva = np.roll(mva, 1, axis=axis)
        pmvb = np.roll(mvb, 1, axis=axis)
        ppoca = np.roll(poca, 1, axis=axis)
        ppocb = np.roll(pocb, 1, axis=axis)
        # reference-picture set comparison (order-free)
        set_eq = (((poca == ppoca) & (pocb == ppocb))
                  | ((poca == ppocb) & (pocb == ppoca)))
        aligned = ge4(mva, pmva) | ge4(mvb, pmvb)
        crossed = ge4(mva, pmvb) | ge4(mvb, pmva)
        # when the two references differ, MVs pair by picture; when both
        # point at the same picture, BS=1 only if both orderings exceed
        same_pair = poca == pocb
        align_ok = np.where(
            poca == ppoca, aligned,
            np.where(poca == ppocb, crossed, True))
        bi_diff = np.where(same_pair, aligned & crossed, align_ok)
        mv_big = np.where(nmv != pn, True,
                          np.where(~set_eq, True, bi_diff))
        bs = np.where(intra4 | p_intra, 2,
                      np.where(cbf4 | p_cbf | mv_big, 1, 0)).astype(np.uint8)
        return np.where(edge, bs, 0).astype(np.uint8)

    return bs_dir(ev, axis=1), bs_dir(eh, axis=0)


def qp4_per_cu(ps) -> np.ndarray:
    """[h4, w4] per-4x4 QpY under cu_qp_delta (QG == CTB).

    Within a CTB, CUs preceding (z-order) the first coefficient-bearing
    CU have QpY = qPY_PRED (the previous CTB's actual QP, slice QP for
    the first); the first coded CU and all following CUs have the
    signaled QP (ps.qp_ctb).  Mirrors libde265's per-CU
    decode_quantization_parameters calls (transform.cc:31, slice.cc:4256).
    """
    from ..common.recon import cu_leaves

    g = ps.geom
    qp4 = np.zeros((g.h4, g.w4), np.int32)
    pred = ps.slice_qp
    for ctu in range(g.n_ctbs):
        q_ctb = int(ps.qp_ctb[ctu])
        delta_seen = False
        for (cx, cy, log2_cb) in cu_leaves(ps, ctu):
            sz = 1 << log2_cb
            if not delta_seen:
                if (np.any(ps.coeff_y[cy:cy + sz, cx:cx + sz])
                        or np.any(ps.coeff_cb[cy >> 1:(cy + sz) >> 1,
                                              cx >> 1:(cx + sz) >> 1])
                        or np.any(ps.coeff_cr[cy >> 1:(cy + sz) >> 1,
                                              cx >> 1:(cx + sz) >> 1])):
                    delta_seen = True
            q = q_ctb if delta_seen else pred
            qp4[cy >> 2:(cy + sz) >> 2, cx >> 2:(cx + sz) >> 2] = q
        pred = q_ctb
    return qp4


def deblock_decoded_picture(ps, planes, qp_y: int, bit_depth: int = 8,
                            beta_off: int = 0, tc_off: int = 0,
                            cb_qp_offset: int = 0, cr_qp_offset: int = 0):
    """Deblock a decoded picture on its planes' device: ``planes`` are the
    (Y, Cb, Cr) int32 tensors at the CTB-padded size of ``ps.geom``;
    returns the filtered planes.  The boundary strengths and QP maps are
    ``deblock_picture_np``'s, built on the host at the padded size (no edge
    lies outside the coded picture, so the padding is never filtered and
    never read by a filtered edge); the planes equal that function's on
    the coded-size crop."""
    from ..cabac.ctu import chroma_qp

    dev = planes[0].device
    ev, eh, cbf4 = derive_edge_flags(ps)
    bs_v, bs_h = derive_bs(ps, ev, eh, cbf4)
    lv, lh = bs_v.copy(), bs_h.copy()
    lv[:, 1::2] = 0
    lh[1::2, :] = 0

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                               device=dev)

    if ps.cu_qp_delta_enabled:
        qp4 = qp4_per_cu(ps)
        qv = (np.roll(qp4, 1, axis=1) + qp4 + 1) >> 1
        qh = (np.roll(qp4, 1, axis=0) + qp4 + 1) >> 1
        qp_l = (t(qv), t(qh))
        qp_cb = (t(_chroma_qp_arr(qv[::2, ::2], cb_qp_offset)),
                 t(_chroma_qp_arr(qh[::2, ::2], cb_qp_offset)))
        qp_cr = (t(_chroma_qp_arr(qv[::2, ::2], cr_qp_offset)),
                 t(_chroma_qp_arr(qh[::2, ::2], cr_qp_offset)))
    else:
        qp_l = qp_y
        qp_cb = chroma_qp(qp_y, cb_qp_offset)
        qp_cr = chroma_qp(qp_y, cr_qp_offset)
    y = deblock_plane(planes[0], t(lv), t(lh), qp_l, bit_depth, beta_off,
                      tc_off)
    h4c, w4c = ev.shape[0] // 2, ev.shape[1] // 2
    cv = np.zeros((h4c, w4c), np.int32)
    ch = np.zeros((h4c, w4c), np.int32)
    cv[:, 0::2] = np.where(bs_v[::2, 0::4] == 2, 2, 0)
    ch[0::2, :] = np.where(bs_h[0::4, ::2] == 2, 2, 0)
    cv, ch = t(cv), t(ch)
    cb = deblock_plane(planes[1], cv, ch, qp_cb, bit_depth, tc_off=tc_off,
                       chroma=True)
    cr = deblock_plane(planes[2], cv, ch, qp_cr, bit_depth, tc_off=tc_off,
                       chroma=True)
    return y, cb, cr
