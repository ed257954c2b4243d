"""Per-frame device pipelines for I, P and B frames — torch twin of
``x265_tpu.encoder.device_pipeline`` (``build_i_pipeline``,
``build_p_pipeline``, ``build_b_pipeline`` and their builders).

One call runs a frame's whole device work on the frame's device: 16/32
35-mode SATD intra analysis, per-reference motion search (quarter-res
seeds, full-pel SAD search, subpel refine = K2, neighbour adoption),
ref_idx selection (P) or the bi trial and direction decision (B), the
CU-merge uniformization, chroma MC, the CTU wavefront scan (K1 per
level), deblock, SAO and the picture checksums.  The host receives one
dict of small outputs.

Per-block windows are plain gathers from the extended reference planes
(the TPU's static-slice patch tensors and binary window select are not
needed on a GPU); the TPU's two-program split is one sequence of torch
calls here.  Where the reference vmaps over the frames of a batched B
dispatch, or shards the frames of a GOP-parallel round over a mesh
(``x265_tpu.parallel.gop``), the port carries a leading frame dimension:
the searches, K2 and K1 run once for all frames, the analysis and the
filters per frame.
"""

from __future__ import annotations

import numpy as np
import torch

from .._util import dev_table, f32, fma32, sample_dtype
from ..cabac.ctu import _CHROMA_QP_MAP
from ..ops.cost import satd
from ..ops.deblock import deblock_picture, edge_masks_np
from ..ops.interp import (bi_avg, mc_chroma_batch, mc_chroma_batch_ps,
                          mc_luma_batch, mc_luma_batch_ps)
from ..ops.intra import predict_all_modes, substitute_references
from ..ops.sao import (eo_valid_masks_np, sao_apply_plane,
                       sao_estimate_plane)
from .me_cuda import mv_cost, refine

# float32(1/6): XLA folds ``/ 6.0`` into a multiply by the inverse
_INV6 = np.float32(1.0) / np.float32(6.0)


def me_lambda(qp) -> torch.Tensor:
    """ME lambda 2^((qp-12)/6) as the reference's XLA program rounds it,
    computed on the host as a float32 scalar."""
    q = torch.tensor(float(qp), dtype=torch.float32)
    return torch.pow(torch.tensor(2.0), (q - 12.0) * torch.tensor(_INV6))


def _rep(a, f):
    return a.repeat_interleave(f, 0).repeat_interleave(f, 1)


def _to_plane(lv, gh, gw, bn):
    return lv.reshape(gh, gw, bn, bn).permute(0, 2, 1, 3).reshape(
        gh * bn, gw * bn)


def _clamp_pad(pl, top, bottom, left, right):
    """Edge-replicating pad by clamped indexing (any dtype)."""
    h, w = pl.shape
    ys = (torch.arange(-top, h + bottom, device=pl.device)).clamp(0, h - 1)
    xs = (torch.arange(-left, w + right, device=pl.device)).clamp(0, w - 1)
    return pl[ys[:, None], xs[None, :]]


def _windows(plane, y0, x0, size):
    """[B, size, size] windows of ``plane`` with per-block top-left:
    ``plane`` one plane [H, W] that every block reads, or F planes [F, H,
    W], one per frame of the B // F frame-major blocks of each frame."""
    ar = torch.arange(size, device=plane.device)
    rows = (y0[:, None] + ar)[:, :, None].long()
    cols = (x0[:, None] + ar)[:, None, :].long()
    if plane.dim() == 2:
        return plane[rows, cols]
    B = y0.shape[0]
    fi = torch.arange(B, device=plane.device) // (B // plane.shape[0])
    return plane[fi[:, None, None], rows, cols]


def _block_windows(S, y0, x0, size):
    """[B, size, size] windows of per-block tensors S [B, H, W]."""
    ar = torch.arange(size, device=S.device)
    b = torch.arange(S.shape[0], device=S.device)[:, None, None]
    return S[b, (y0[:, None] + ar)[:, :, None].long(),
             (x0[:, None] + ar)[:, None, :].long()]


def _filter_stage_builder(enc):
    """In-pipeline loop filters and output packing.  Returns
    finish(oy3, scan_out, qp_base, dqp_cb, dqp_cr, sao_lam, inter=None,
    mv=None, motion_b=None, qp_base_ctb=None, merged=None) ->
    (small dict, tails dict, final padded planes)."""
    g = enc.geom
    p = enc.params
    bd = enc.bit_depth
    dev = enc.device
    ctb = 1 << g.log2_ctb
    ph = g.ctbs_h << g.log2_ctb
    pw = g.ctbs_w << g.log2_ctb
    gh, gw = ph // 16, pw // 16
    has32 = ctb >= 32
    gh32, gw32 = (ph // 32, pw // 32) if has32 else (1, 1)
    masks = edge_masks_np(g, g.log2_ctb)
    eo_y, in_y = (torch.as_tensor(a, device=dev)
                  for a in eo_valid_masks_np(ph, pw, g.width, g.height))
    eo_c, in_c = (torch.as_tensor(a, device=dev)
                  for a in eo_valid_masks_np(ph // 2, pw // 2, g.width // 2,
                                             g.height // 2))
    aq = bool(p.aq_mode)
    cbo, cro = enc.pps.cb_qp_offset, enc.pps.cr_qp_offset
    chw, cww = g.ctbs_h, g.ctbs_w
    n16ctb = ctb // 16

    def _chroma_qp(qp, offset):
        qpi = (qp + offset).clamp(-12, 57)
        mapped = dev_table("cqpmap", lambda: _CHROMA_QP_MAP, qp.device)[
            (qpi - 30).clamp(0, 13).long()]
        return torch.where(qpi < 30, qpi.clamp(min=0),
                           torch.where(qpi > 43, qpi - 6, mapped))

    z16 = np.zeros((gh, gw), np.int32)
    for by in range(gh):
        for bx in range(gw):
            x, y, z = bx % n16ctb, by % n16ctb, 0
            for i in range(4):
                z |= ((x >> i) & 1) << (2 * i)
                z |= ((y >> i) & 1) << (2 * i + 1)
            z16[by, bx] = z
    z16_t = torch.as_tensor(z16, device=dev)

    def _qp_planes(cy, ccb, ccr, use32, merged, qp_base_ctb, slice_qp):
        """(actual per-CTB QP [nctb], per-4x4 QpY plane) at QG == CTB."""
        has16 = ((cy.reshape(gh, 16, gw, 16) != 0).any(3).any(1)
                 | (ccb.reshape(gh, 8, gw, 8) != 0).any(3).any(1)
                 | (ccr.reshape(gh, 8, gw, 8) != 0).any(3).any(1))
        cuz = z16_t
        has_cu = has16
        if has32:
            q32 = use32.reshape(gh32, gw32)
            if merged is not None:
                q32 = q32 | merged[0]
            zq = z16_t[0::2, 0::2]
            q_has = has16.reshape(gh32, 2, gw32, 2).any(3).any(1)
            cuz = torch.where(_rep(q32, 2), _rep(zq, 2), cuz)
            has_cu = torch.where(_rep(q32, 2), _rep(q_has, 2), has_cu)
        hasctb = has16.reshape(chw, n16ctb, cww, n16ctb).any(3).any(1)
        if merged is not None and ctb == 64:
            r64 = _rep(merged[1], n16ctb)
            cuz = torch.where(r64, 0, cuz)
            has_cu = torch.where(r64, _rep(hasctb, n16ctb), has_cu)
        # last coded CTB's QP so far (the reference's associative scan)
        hv = hasctb.reshape(-1)
        idx = torch.where(hv, torch.arange(hv.numel(), device=dev), -1)
        last = torch.cummax(idx, 0).values
        actual = torch.where(last >= 0, qp_base_ctb[last.clamp(min=0)],
                             slice_qp).to(torch.int32)
        pred = torch.cat([torch.full((1,), int(slice_qp), dtype=torch.int32,
                                     device=dev), actual[:-1]])
        zz = torch.where(has_cu, cuz, 1 << 20)
        firstz = zz.reshape(chw, n16ctb, cww, n16ctb).amin(3).amin(1)
        before16 = cuz < _rep(firstz, n16ctb)
        a16 = _rep(actual.reshape(chw, cww), n16ctb)
        p16 = _rep(pred.reshape(chw, cww), n16ctb)
        qp16 = torch.where(before16, p16, a16)
        return actual, _rep(qp16, 4)

    inb32 = np.zeros((gh32, gw32), bool)
    for qy in range(gh32):
        for qx in range(gw32):
            inb32[qy, qx] = (qx * 32 + 32 <= g.width
                             and qy * 32 + 32 <= g.height)
    inb64 = np.zeros((chw, cww), bool)
    for cy2 in range(chw):
        for cx2 in range(cww):
            inb64[cy2, cx2] = (((cx2 + 1) << g.log2_ctb) <= g.width
                               and ((cy2 + 1) << g.log2_ctb) <= g.height)
    inb32_t = torch.as_tensor(inb32, device=dev)
    inb64_t = torch.as_tensor(inb64, device=dev)

    def merged_masks(inter, fields):
        """(m32 [gh32, gw32], m64 [chw, cww]): aligned quads of inter
        blocks with identical motion merge to 32/64 CUs."""
        if not has32:
            return None
        ig = inter.reshape(gh, gw)
        ff = torch.cat([f.reshape(gh, gw, -1).to(torch.int32)
                        for f in fields], -1)
        q = ff.reshape(gh32, 2, gw32, 2, -1)
        same32 = (q == q[:, :1, :, :1]).all(4).all(3).all(1)
        i32 = ig.reshape(gh32, 2, gw32, 2).all(3).all(1)
        m32 = same32 & i32 & inb32_t
        if ctb == 64:
            q6 = ff.reshape(chw, 4, cww, 4, -1)
            same64 = (q6 == q6[:, :1, :, :1]).all(4).all(3).all(1)
            i64 = ig.reshape(chw, 4, cww, 4).all(3).all(1)
            m64 = same64 & i64 & inb64_t
        else:
            m64 = torch.zeros((chw, cww), dtype=torch.bool, device=dev)
        return m32, m64

    def _qp_edge_maps(qp4):
        qv = (torch.roll(qp4, 1, 1) + qp4 + 1) >> 1
        qh = (torch.roll(qp4, 1, 0) + qp4 + 1) >> 1
        qvc, qhc = qv[::2, ::2], qh[::2, ::2]
        return ((qv, qh),
                (_chroma_qp(qvc, cbo), _chroma_qp(qhc, cbo)),
                (_chroma_qp(qvc, cro), _chroma_qp(qhc, cro)))

    cw0, cr0, ct0, cb0 = getattr(enc.sps, "conf_win", (0, 0, 0, 0))
    wl = g.width - 2 * (cw0 + cr0)
    hl = g.height - 2 * (ct0 + cb0)

    def finish(oy3, scan_out, qp_base, dqp_cb, dqp_cr, sao_lam,
               inter=None, mv=None, motion_b=None, qp_base_ctb=None,
               merged=None):
        (rec_y, rec_cb, rec_cr, lv16_y, lv8_cb, lv8_cr,
         lv32_y, lv16_cb, lv16_cr, use32, _tu8, _nr) = scan_out
        cy = _to_plane(lv16_y, gh, gw, 16)
        ccb = _to_plane(lv8_cb, gh, gw, 8)
        ccr = _to_plane(lv8_cr, gh, gw, 8)
        if has32:
            u = use32.reshape(gh32, gw32)
            cy = torch.where(_rep(u, 32), _to_plane(lv32_y, gh32, gw32, 32),
                             cy)
            mc = _rep(u, 16)
            ccb = torch.where(mc, _to_plane(lv16_cb, gh32, gw32, 16), ccb)
            ccr = torch.where(mc, _to_plane(lv16_cr, gh32, gw32, 16), ccr)
        planes = tuple(x.to(torch.int32) for x in (rec_y, rec_cb, rec_cr))

        if aq:
            qp_actual, qp4 = _qp_planes(cy, ccb, ccr,
                                        use32 if has32 else None, merged,
                                        qp_base_ctb, qp_base)
            dqp_y, dqp_cb, dqp_cr = _qp_edge_maps(qp4)
        else:
            qp_actual = torch.full((g.n_ctbs,), int(qp_base),
                                   dtype=torch.int32, device=dev)
            dqp_y = int(qp_base)
            dqp_cb, dqp_cr = int(dqp_cb), int(dqp_cr)

        if p.deblock:
            if inter is not None:
                intra4 = _rep(~inter.reshape(gh, gw), 4)
                mv4 = mv.reshape(gh, gw, 2).repeat_interleave(
                    4, 0).repeat_interleave(4, 1).to(torch.int32)
            else:
                intra4 = torch.ones((ph // 4, pw // 4), dtype=torch.bool,
                                    device=dev)
                mv4 = torch.zeros((ph // 4, pw // 4, 2), dtype=torch.int32,
                                  device=dev)
            cbf4 = _rep((lv16_y != 0).any(2).any(1).reshape(gh, gw), 4)
            if has32:
                cbf32 = (lv32_y != 0).any(2).any(1).reshape(gh32, gw32)
                cbf4 = torch.where(_rep(u, 8), _rep(cbf32, 8), cbf4)
            planes = deblock_picture(
                planes, intra4, cbf4, mv4, u if has32 else None, masks,
                dqp_y, dqp_cb, dqp_cr, bd, p.deblock_beta_offset,
                p.deblock_tc_offset, motion_b=motion_b)

        nctb = g.n_ctbs
        small = {}
        if p.sao:
            oy, ocb, ocr = (x.to(torch.int32) for x in oy3)
            lam_t = f32(sao_lam, dev)
            dist, offs, bpos, bits = sao_estimate_plane(
                oy, planes[0], chw, cww, ctb, eo_y, in_y, bd)
            cost = fma32(lam_t, bits, dist)
            cost[..., 0] = 0.0
            best = torch.argmin(cost, -1).to(torch.int32)
            db, ob_, pb, bb = sao_estimate_plane(
                ocb, planes[1], chw, cww, ctb // 2, eo_c, in_c, bd)
            dr, orr, pr, br = sao_estimate_plane(
                ocr, planes[2], chw, cww, ctb // 2, eo_c, in_c, bd)
            cost_c = fma32(lam_t, bb + br, db + dr)
            cost_c[..., 0] = 0.0
            best_c = torch.argmin(cost_c, -1).to(torch.int32)

            def params_of(best_, offs_, bpos_):
                types = torch.where(best_ == 0, 0,
                                    torch.where(best_ == 5, 1, 2))
                klass = (best_ - 1).clamp(0, 3)
                osel = torch.gather(
                    offs_, -2, best_.long()[..., None, None].expand(
                        *best_.shape, 1, 4))[..., 0, :]
                return types, klass, osel.to(torch.int32), bpos_

            ty, ky, oy_sel, by_ = params_of(best, offs, bpos)
            tc_, kc, ob_sel, bb_ = params_of(best_c, ob_, pb)
            _, _, or_sel, br_ = params_of(best_c, orr, pr)
            planes = (
                sao_apply_plane(planes[0], chw, cww, ctb, ty, ky, by_,
                                oy_sel, eo_y, bd),
                sao_apply_plane(planes[1], chw, cww, ctb // 2, tc_, kc, bb_,
                                ob_sel, eo_c, bd),
                sao_apply_plane(planes[2], chw, cww, ctb // 2, tc_, kc, br_,
                                or_sel, eo_c, bd))
            small["sao_type"] = torch.stack([ty.reshape(-1),
                                             tc_.reshape(-1)], 1)
            small["sao_class"] = torch.stack([ky.reshape(-1),
                                              kc.reshape(-1)], 1)
            small["sao_bpos"] = torch.stack([by_.reshape(-1),
                                             bb_.reshape(-1),
                                             br_.reshape(-1)], 1)
            small["sao_offs"] = torch.stack([oy_sel.reshape(-1, 4),
                                             ob_sel.reshape(-1, 4),
                                             or_sel.reshape(-1, 4)], 1)
        else:
            zi = torch.zeros
            small["sao_type"] = zi((nctb, 2), dtype=torch.int32, device=dev)
            small["sao_class"] = zi((nctb, 2), dtype=torch.int32, device=dev)
            small["sao_bpos"] = zi((nctb, 3), dtype=torch.int32, device=dev)
            small["sao_offs"] = zi((nctb, 3, 4), dtype=torch.int32,
                                   device=dev)
        small.update(cy=cy.to(torch.int16), ccb=ccb.to(torch.int16),
                     ccr=ccr.to(torch.int16),
                     qp_actual=qp_actual.to(torch.int32),
                     checksums=_plane_checksums(planes, bd, g))
        if merged is not None:
            small["m32"], small["m64"] = merged
        out_planes = tuple(pl.to(sample_dtype(bd)) for pl in planes)
        y, cb_, cr_ = out_planes
        tails = dict(
            rec_coded=(y[:g.height, :g.width],
                       cb_[:g.height // 2, :g.width // 2],
                       cr_[:g.height // 2, :g.width // 2]),
            rec_conf=(y[2 * ct0:2 * ct0 + hl, 2 * cw0:2 * cw0 + wl],
                      cb_[ct0:ct0 + hl // 2, cw0:cw0 + wl // 2],
                      cr_[ct0:ct0 + hl // 2, cw0:cw0 + wl // 2]))
        return small, tails, out_planes

    finish.merged_masks = merged_masks
    return finish


def _plane_checksums(planes, bit_depth, g):
    """H.265 D.3.19 picture checksums: the 32-bit position-masked byte sum
    of each plane's coded area, as int64 [3] (mod 2^32)."""
    def one(pl, h, w):
        p = pl[:h, :w].to(torch.int64)
        xs = torch.arange(w, device=pl.device)
        ys = torch.arange(h, device=pl.device)
        mask = (((xs & 0xFF) ^ (xs >> 8))[None, :]
                ^ ((ys & 0xFF) ^ (ys >> 8))[:, None])
        s = ((p & 0xFF) ^ mask).sum()
        if bit_depth > 8:
            s = s + ((p >> 8) ^ mask).sum()
        return s & 0xFFFFFFFF

    return torch.stack([one(planes[0], g.height, g.width),
                        one(planes[1], g.height // 2, g.width // 2),
                        one(planes[2], g.height // 2, g.width // 2)])


def _analyse_builder(enc, n, gh, gw, ph, pw):
    """Open-loop 35-mode SATD analysis at block size n: returns
    analyse(y) -> (best mode [B] int32, best cost [B] int32)."""
    dev = enc.device
    _, avails = enc._mode_gather_tables(n, gh, gw, ph, pw)
    avails = torch.as_tensor(avails, device=dev)
    r = (torch.arange(gh, device=dev) * n)[:, None, None]
    c = (torch.arange(gw, device=dev) * n)[None, :, None]
    k = torch.arange(2 * n + 1, device=dev)[None, None, :]
    lrow, lcol = r + k, c
    trow, tcol = r, c + 1 + k[..., :2 * n]

    def analysis_refs(y):
        """[B, 4n+1] canonical open-loop references (reversed left column
        incl. corner + top row) of the edge-padded source plane."""
        ypad = _clamp_pad(y.to(torch.int32), 1, 2 * n, 1, 2 * n)
        lc = ypad[lrow, lcol]                       # [gh, gw, 2n+1]
        top = ypad[trow, tcol]                      # [gh, gw, 2n]
        return torch.cat([lc.flip(-1), top], -1).reshape(gh * gw, 4 * n + 1)

    def analyse(y):
        refs = substitute_references(analysis_refs(y), avails,
                                     enc.bit_depth)
        preds = predict_all_modes(refs, n, True, enc.bit_depth)
        blocks = y.to(torch.int32).reshape(gh, n, gw, n).permute(
            0, 2, 1, 3).reshape(-1, n, n)
        costs = satd(blocks[:, None], preds)
        return torch.argmin(costs, 1).to(torch.int32), costs.amin(1)

    return analyse


def _extend_builder(enc):
    """Reference extension: crop the recon to the coded picture, then
    edge-replicate to the padded plane plus the ME/MC margin."""
    g = enc.geom
    M = enc.me_range + 8
    CM = enc.me_range // 2 + 4
    ph = g.ctbs_h << g.log2_ctb
    pw = g.ctbs_w << g.log2_ctb
    cw, ch = enc.sps.pic_width, enc.sps.pic_height

    def extend(planes3):
        y, cb, cr = planes3
        return (_clamp_pad(y[:ch, :cw], M, M + ph - ch, M, M + pw - cw),
                _clamp_pad(cb[:ch // 2, :cw // 2], CM, CM + (ph - ch) // 2,
                           CM, CM + (pw - cw) // 2),
                _clamp_pad(cr[:ch // 2, :cw // 2], CM, CM + (ph - ch) // 2,
                           CM, CM + (pw - cw) // 2))

    return extend


def _frames(x) -> list:
    """Per-frame host values as a list (one value, or one per frame)."""
    if torch.is_tensor(x):
        return x.reshape(-1).tolist()
    return np.ravel(np.asarray(x)).tolist()


def _frame_scan_out(out, f):
    """Frame ``f``'s outputs of a batched scan, NR sums included."""
    nr = out[11]
    return tuple(None if x is None else x[f] for x in out[:11]) + (
        None if nr is None else {c: tuple(v[f] for v in t)
                                 for c, t in nr.items()},)


def _stack_frames(res):
    """Per-frame (small, tails, ext) results stacked on a leading frame
    dimension (``ext`` None stays None)."""
    small = {k: torch.stack([r[0][k] for r in res]) for k in res[0][0]}
    tails = {k: tuple(torch.stack(p) for p in zip(*(r[1][k] for r in res)))
             for k in res[0][1]}
    ext = (None if res[0][2] is None
           else tuple(torch.stack(p) for p in zip(*(r[2] for r in res))))
    return small, tails, ext


def nr_outputs(nr) -> dict:
    """The scan's noise-reduction statistics as small outputs:
    ``nr_<cat>`` = [s_i (n * n), c_i, s_p (n * n), c_p] int32."""
    if nr is None:
        return {}
    return {"nr_" + cat: torch.cat([si, ci.reshape(1), sp, cp.reshape(1)])
            for cat, (si, ci, sp, cp) in nr.items()}


def build_i_pipeline(enc, batch: int | None = None):
    """I-frame program: 16/32 intra analysis, the CTU scan with the
    in-scan 32-vs-16 RD decision, loop filters, DPB extension.
    run(oy, ocb, ocr, qpy, qpb, qpr, lam, qp_base, dqp_cb, dqp_cr,
    sao_lam, qp_base_ctb[, nr_offsets]) -> (small, tails, ext).

    ``batch=G``: the first frames of G closed GOPs on a leading frame
    dimension of every per-frame input and output (the reference shards
    them over a mesh axis): each scan level is one K1 launch over their G
    x L lanes, the analysis, filters and extension run per frame, and
    ``qp_base``, ``dqp_*`` and ``sao_lam`` are one value per frame."""
    g = enc.geom
    n = 16
    ph = g.ctbs_h << g.log2_ctb
    pw = g.ctbs_w << g.log2_ctb
    gh, gw = ph // n, pw // n
    scan = enc._get_ctu_scan()
    decide = bool(scan.t["has32"])
    run_scan = scan.scan_fn(inter=False, decide32=decide)
    B32 = scan.t["b32_n"]
    dev = enc.device
    analyse = _analyse_builder(enc, n, gh, gw, ph, pw)
    analyse32 = (_analyse_builder(enc, 32, ph // 32, pw // 32, ph, pw)
                 if decide else None)
    finish = _filter_stage_builder(enc)
    extend = _extend_builder(enc)
    F = batch or 1

    def run(oy, ocb, ocr, qpy, qpb, qpr, lam, qp_base, dqp_cb, dqp_cr,
            sao_lam, qp_base_ctb, nr_offsets=None):
        args = [oy, ocb, ocr, qpy, qpb, qpr, lam, qp_base_ctb]
        if not batch:
            args = [x[None] for x in args]
        oy, ocb, ocr, qpy, qpb, qpr, lam, qp_base_ctb = args
        qp_base, dqp_cb, dqp_cr, sao_lam = (
            _frames(x) for x in (qp_base, dqp_cb, dqp_cr, sao_lam))
        modes = torch.stack([analyse(oy[f])[0] for f in range(F)])
        if decide:
            mode32 = torch.stack([analyse32(oy[f])[0] for f in range(F)])
        else:
            mode32 = torch.zeros((F, B32), dtype=torch.int32, device=dev)
        out = run_scan(oy, ocb, ocr, modes, mode32,
                       torch.zeros((F, B32), dtype=torch.bool, device=dev),
                       qpy, qpb, qpr, lam=lam, nr_offsets=nr_offsets)
        res = []
        for f in range(F):
            out_f = _frame_scan_out(out, f)
            small, tails, fplanes = finish(
                (oy[f], ocb[f], ocr[f]), out_f, qp_base[f], dqp_cb[f],
                dqp_cr[f], sao_lam[f], qp_base_ctb=qp_base_ctb[f])
            small = dict(small, modes=modes[f], mode32=mode32[f],
                         use32=out_f[9], **nr_outputs(out_f[11]))
            res.append((small, tails, extend(fplanes)))
        return _stack_frames(res) if batch else res[0]

    return run


def _inter_tools_builder(enc):
    """Motion search (quarter-res seeds, full-pel SAD search, subpel
    refine, neighbour adoption) and luma/chroma MC at per-block MVs."""
    g = enc.geom
    dev = enc.device
    n = 16
    R = enc.me_range
    RF = enc.me_fine
    RC = enc.me_coarse
    RS = 4 * RC
    MRQ = max(1, min(64, enc.params.me_range))
    M = R + 8
    CM = R // 2 + 4
    ph = g.ctbs_h << g.log2_ctb
    pw = g.ctbs_w << g.log2_ctb
    gh, gw = ph // n, pw // n
    nb = gh * gw
    cn = n // 2
    bd = enc.bit_depth
    offs_f = torch.tensor([(dy, dx) for dy in range(-RF, RF + 1)
                           for dx in range(-RF, RF + 1)], dtype=torch.int32,
                          device=dev)
    offs_c = 4 * torch.tensor([(dy, dx) for dy in range(-RC, RC + 1)
                               for dx in range(-RC, RC + 1)],
                              dtype=torch.int32, device=dev)
    by0 = (torch.arange(gh, device=dev) * n).repeat_interleave(gw)
    bx0 = (torch.arange(gw, device=dev) * n).repeat(gh)
    cby0, cbx0 = by0 // 2, bx0 // 2
    row_ok = torch.arange(nb, device=dev) // gw > 0
    col_ok = torch.arange(nb, device=dev) % gw > 0

    def coarse_seeds(orig, ref_ext):
        """Quarter-res full search: per-block full-pel seeds, multiples
        of 4 pels within +-RS (zero-motion bias 2 per quarter-pel step).
        ``orig`` [F, ph, pw]; returns [F * nb, 2]."""
        def box4(pl):
            h, w = pl.shape[-2:]
            return (pl.to(torch.int32).reshape(-1, h // 4, 4, w // 4, 4).sum(
                (2, 4), dtype=torch.int32) + 8) >> 4

        oq = box4(orig)                                     # [F, qh, qw]
        # [1 or F, ...]: the shared reference, or each frame's own
        rq = box4(ref_ext[..., M - RS:M - RS + ph + 2 * RS,
                          M - RS:M - RS + pw + 2 * RS])
        F = oq.shape[0]
        qh, qw = ph // 4, pw // 4
        span = 2 * RC + 1
        ar = torch.arange(-RC, RC + 1, device=dev).abs()
        bias = 2 * (ar[:, None] + ar[None, :])
        cs = torch.empty((span, span, F, gh, gw), dtype=torch.int32,
                         device=dev)
        for dy in range(span):
            rows = rq[:, dy:dy + qh, :]
            cand = rows.unfold(2, qw, 1).permute(0, 2, 1, 3)[:, :span]
            d = (oq[:, None] - cand).abs()
            cs[dy] = d.reshape(F, span, gh, 4, gw, 4).sum(
                (3, 5), dtype=torch.int32).transpose(0, 1)
        cs = cs + bias[:, :, None, None, None]
        costs = cs.permute(2, 3, 4, 0, 1).reshape(F * nb, -1)
        return offs_c[torch.argmin(costs, 1)]

    def _tile(a, B):
        """Per-block constants of one frame repeated for B // nb frames."""
        return a if B == nb else a.repeat(B // nb)

    def me(orig, ref_ext, ob, lam):
        """Per-block motion for one reference: returns (mv [B, 2] (x, y)
        qpel, cost [B] float32, pred [B, 16, 16]).  ``orig`` is one frame
        [ph, pw] or F frames [F, ph, pw], ``ref_ext`` one extended
        reference plane [H, W] that they all search or one per frame [F,
        H, W], ``ob`` their blocks [F * nb, 16, 16], ``lam`` a float32
        scalar or one per frame [F]: one K2 launch serves all F frames.
        The MC helpers below take references the same two ways."""
        orig = orig.reshape(-1, ph, pw)
        F = orig.shape[0]
        B = F * nb
        lam_f = torch.as_tensor(lam, dtype=torch.float32,
                                device=dev).reshape(-1)
        lam_b = (lam_f.expand(B) if lam_f.numel() == 1
                 else lam_f.repeat_interleave(nb))
        if RC:
            seed = coarse_seeds(orig, ref_ext).clamp(-(MRQ - RF), MRQ - RF)
        else:
            seed = torch.zeros((B, 2), dtype=torch.int32, device=dev)
        # lambda * mv-bits anchor: median of the west / north / own seeds
        sg = seed.reshape(F, gh, gw, 2)
        sw_ = torch.roll(sg, 1, 2)
        sn_ = torch.roll(sg, 1, 1)
        sw_[:, :, 0] = sg[:, :, 0]
        sn_[:, 0, :] = sg[:, 0, :]
        pmv = 4 * (sg + sw_ + sn_ - torch.maximum(torch.maximum(sg, sw_),
                                                  sn_)
                   - torch.minimum(torch.minimum(sg, sw_), sn_)).reshape(
                       B, 2)

        # full-pel SAD search over the (2RF+1)^2 grid around each seed
        PSF = n + 2 * RF + 9
        S = _windows(ref_ext, _tile(by0, B) + M - RF - 4 + seed[:, 0],
                     _tile(bx0, B) + M - RF - 4 + seed[:, 1],
                     PSF).to(torch.int32)
        span = 2 * RF + 1
        cs = torch.empty((B, span, span), dtype=torch.int32, device=dev)
        for dy in range(span):
            rows = S[:, 4 + dy:4 + dy + n, 4:4 + span + n - 1]
            cand = rows.unfold(2, n, 1)              # [B, n, span, n]
            cs[:, dy] = (ob[:, :, None, :] - cand).abs().sum(
                (1, 3), dtype=torch.int32)
        cand_q = 4 * (seed[:, None, :] + offs_f[None])
        costs = mv_cost(lam_b[:, None], cand_q, pmv[:, None],
                        cs.reshape(B, -1).to(torch.float32))
        idx = torch.argmin(costs, 1)
        dl = offs_f[idx]
        mvi = seed + dl
        W = _block_windows(S, dl[:, 0] + RF, dl[:, 1] + RF, n + 9)

        # K2 takes one lambda, or one per block for several frames
        q0, pred, cost = refine(W.contiguous(), ob.contiguous(),
                                mvi.contiguous(), pmv.contiguous(),
                                lam_f if lam_f.numel() == 1 else lam_b,
                                int(enc.params.subme), MRQ, bd)
        mvq = mvi * 4 + q0

        # MV coherence: adopt the west / north neighbour's MV when its
        # total cost wins within a bonus of 4 * lambda
        merge_bonus = 4.0 * lam_b
        pmv_xy = pmv.flip(1)
        valids = ((_tile(col_ok, B), 2), (_tile(row_ok, B), 1))

        def adopt2(mvq, pred, cost):
            # both candidate fields come from the MVs entering the pass
            # (the north candidates do not see the west adoptions)
            g2 = mvq.reshape(F, gh, gw, 2)
            cands = [(torch.roll(g2, 1, axis).reshape(-1, 2), valid)
                     for valid, axis in valids]
            for cand, valid in cands:
                cand = cand.clamp(-4 * MRQ, 4 * MRQ)
                p1 = eval_mv(ref_ext, cand)
                c = mv_cost(lam_b, cand, pmv_xy,
                            satd(ob, p1).to(torch.float32))
                better = (c < cost + merge_bonus) & valid
                mvq = torch.where(better[:, None], cand, mvq)
                pred = torch.where(better[:, None, None], p1, pred)
                cost = torch.where(better, c, cost)
            return mvq, pred, cost

        mvxy = mvq.flip(1)
        for _ in range(2):
            mvxy, pred, cost = adopt2(mvxy, pred, cost)
        return mvxy, cost, pred

    def _luma_windows(ref_ext, mv):
        B = mv.shape[0]
        return _windows(ref_ext, _tile(by0, B) + M - 3 + (mv[:, 1] >> 2),
                        _tile(bx0, B) + M - 3 + (mv[:, 0] >> 2), n + 7)

    def eval_mv_ps(ref_ext, mv):
        """14-bit luma prediction at per-block (x, y) qpel MVs."""
        return mc_luma_batch_ps(_luma_windows(ref_ext, mv), mv[:, 0] & 3,
                                mv[:, 1] & 3, n, n, bd)

    def eval_mv(ref_ext, mv):
        """Pixel-domain luma prediction at per-block (x, y) qpel MVs."""
        return mc_luma_batch(_luma_windows(ref_ext, mv), mv[:, 0] & 3,
                             mv[:, 1] & 3, n, n, bd)

    def _chroma_windows(ref_c, mv):
        B = mv.shape[0]
        return _windows(ref_c, _tile(cby0, B) + CM - 1 + (mv[:, 1] >> 3),
                        _tile(cbx0, B) + CM - 1 + (mv[:, 0] >> 3), cn + 3)

    def chroma_pred(ref_c, mv):
        return mc_chroma_batch(_chroma_windows(ref_c, mv), mv[:, 0] & 7,
                               mv[:, 1] & 7, cn, cn, bd)

    def chroma_pred_ps(ref_c, mv):
        return mc_chroma_batch_ps(_chroma_windows(ref_c, mv), mv[:, 0] & 7,
                                  mv[:, 1] & 7, cn, cn, bd)

    return dict(me=me, eval_mv_ps=eval_mv_ps, eval_mv=eval_mv,
                chroma_pred=chroma_pred, chroma_pred_ps=chroma_pred_ps,
                satd=satd, bi_avg=lambda a, b: bi_avg(a, b, bd), R=R, M=M,
                CM=CM)


def _quad_helpers(g, F, dev):
    """The uniformization's quad helpers over F frames' 16x16 blocks
    (frame-major, raster within a frame) in aligned quads of bs x bs
    blocks: (inbounds(bs) [F * nb] quads inside the picture, qsum(a, bs)
    per-quad sums broadcast to the blocks, top_left(a, bs) each quad's
    top-left value broadcast, all_of(m, bs) per-quad all)."""
    gh = (g.ctbs_h << g.log2_ctb) // 16
    gw = (g.ctbs_w << g.log2_ctb) // 16

    def inbounds(bs):
        by = (np.arange(gh) // bs) * bs * 16
        bx = (np.arange(gw) // bs) * bs * 16
        return torch.as_tensor((by[:, None] + bs * 16 <= g.height)
                               & (bx[None, :] + bs * 16 <= g.width),
                               device=dev).reshape(-1).repeat(F)

    def qsum(a, bs):
        # in row-major order of the quad's blocks: the reference's reduce
        # order
        q = a.reshape(F, gh // bs, bs, gw // bs, bs)
        s = None
        for i in range(bs):
            for j in range(bs):
                s = q[:, :, i, :, j] if s is None else s + q[:, :, i, :, j]
        return s.repeat_interleave(bs, 1).repeat_interleave(bs, 2).reshape(-1)

    def top_left(a, bs):
        q = a.reshape((F, gh, gw) + tuple(a.shape[1:]))[:, ::bs, ::bs]
        return q.repeat_interleave(bs, 1).repeat_interleave(bs, 2).reshape(
            a.shape)

    def all_of(m, bs):
        return m.reshape(F, gh // bs, bs, gw // bs, bs).all(4).all(
            2).repeat_interleave(bs, 1).repeat_interleave(bs, 2).reshape(-1)

    return inbounds, qsum, top_left, all_of


def _rep4(a, gh, gw):
    """Per-16x16-block values [gh * gw, ...] -> the 4x4 grid [4 gh, 4 gw,
    -1]."""
    return a.reshape(gh, gw, -1).repeat_interleave(4, 0).repeat_interleave(
        4, 1)


def ref_idx_bits(nr: int, n_act: int) -> np.ndarray:
    """Per-slot ref_idx bit cost [nr]: TR bits + a merge-risk bias of 6
    for non-zero refs; padding slots cost 1e9 (never win)."""
    out = np.full((nr,), 1e9, np.float32)
    for r in range(min(nr, n_act)):
        tr = 0.0 if n_act == 1 else float(
            r + 1 if r < n_act - 1 else n_act - 1)
        out[r] = tr + (6.0 if r > 0 else 0.0)
    return out


def build_p_pipeline(enc, nr: int = 1, batch: int | None = None):
    """P-frame program: intra analysis, per-reference ME (K2 inside),
    ref_idx argmin, CU-merge uniformization, chroma MC, the CTU scan (K1)
    with the inter TU32 trial, loop filters and DPB extension.

    ``batch=G``: one P frame of each of G closed GOPs on a leading frame
    dimension of every per-frame input and output (the reference shards
    them over a mesh axis).  Each frame has its own references (each slot
    [G, H, W]), weights, QPs and lambdas; each slot's search is one K2
    launch over the G x nb blocks and each scan level one K1 launch over
    the G x L lanes.  ``batch=None``: one frame, no frame dimension.

    run(oy, ocb, ocr, refs_y, refs_cb, refs_cr, qpy, qpb, qpr, lam,
    qp_base, dqp_cb, dqp_cr, sao_lam, qp_base_ctb, ref_pocs, wy, wo, n_act)
    -> (small, tails, ext); ``qp_base``, ``dqp_*``, ``sao_lam``, ``wy`` and
    ``wo`` are one value per frame, ``ref_pocs`` and ``n_act`` shared."""
    g = enc.geom
    dev = enc.device
    n = 16
    ph = g.ctbs_h << g.log2_ctb
    pw = g.ctbs_w << g.log2_ctb
    gh, gw = ph // n, pw // n
    nb = gh * gw
    scan = enc._get_ctu_scan()
    decide = bool(scan.t["has32"])
    run_scan = scan.scan_fn(inter=True, decide32=decide)
    B32 = scan.t["b32_n"]
    analyse16 = _analyse_builder(enc, n, gh, gw, ph, pw)
    finish = _filter_stage_builder(enc)
    tools = _inter_tools_builder(enc)
    extend = _extend_builder(enc)
    weightp = bool(enc.params.weightp)
    bd = enc.bit_depth
    maxv = (1 << bd) - 1
    log2wd = 6 + 14 - bd
    F = batch or 1
    quad_inbounds, qsum, top_left, all_of = _quad_helpers(g, F, dev)

    def per_frame(x):
        """One int32 value per frame -> [F, 1, 1] and per block [F*nb, 1,
        1]."""
        t = torch.tensor(_frames(x), dtype=torch.int32, device=dev)
        return t[:, None, None], t.repeat_interleave(nb)[:, None, None]

    def prep(oy, refs_y, refs_cb, refs_cr, qp_base, rbits, wy, wo):
        """``oy`` [F, ph, pw], each reference slot [F, H, W]; returns
        (modes, mode32, mv, rsel, inter, pred_y, pred_cb, pred_cr) with a
        leading frame dimension and the frames' costs (cost_p, cost_i)
        [F]."""
        an = [analyse16(oy[f]) for f in range(F)]
        modes = torch.stack([a[0] for a in an])
        icost = torch.cat([a[1] for a in an])
        oy32 = oy.to(torch.int32)
        ob = oy32.reshape(F, gh, n, gw, n).permute(0, 1, 3, 2, 4).reshape(
            -1, n, n)
        if decide:
            mode32 = modes.reshape(F, gh, gw)[:, 0::2, 0::2].reshape(F, -1)
        else:
            mode32 = torch.zeros((F, B32), dtype=torch.int32, device=dev)
        lam_f = torch.stack([me_lambda(q) for q in _frames(qp_base)]).to(dev)
        lam = lam_f.repeat_interleave(nb)              # [F * nb]
        (wy_f, wy_b), (wo_f, wo_b) = per_frame(wy), per_frame(wo)
        scale = 1 << (bd - 8)

        def weighted(ps_pred):
            return (((ps_pred * wy_b + (1 << (log2wd - 1))) >> log2wd)
                    + wo_b * scale).clamp(0, maxv)

        mvs, preds, totals = [], [], []
        for r in range(nr):
            ry = refs_y[r]
            if weightp and r == 0:
                me_ref = (((ry.to(torch.int32) * wy_f + 32) >> 6)
                          + wo_f * scale).clamp(0, maxv).to(ry.dtype)
            else:
                me_ref = ry
            mv_r, pcost_r, pred_r = tools["me"](oy32, me_ref, ob, lam_f)
            if weightp and r == 0:
                pred_r = weighted(tools["eval_mv_ps"](ry, mv_r))
            totals.append(fma32(lam, f32(float(rbits[r]), dev), pcost_r))
            mvs.append(mv_r)
            preds.append(pred_r)
        if nr == 1:
            rsel = torch.zeros((mvs[0].shape[0],), dtype=torch.int32,
                               device=dev)
            pcost, mv, pred_y = totals[0], mvs[0], preds[0]
        else:
            tc = torch.stack(totals)
            rsel = torch.argmin(tc, 0).to(torch.int32)
            pcost = tc.amin(0)
            mv = torch.stack(mvs).gather(
                0, rsel.long()[None, :, None].expand(1, -1, 2))[0]
            pred_y = torch.stack(preds).gather(
                0, rsel.long()[None, :, None, None].expand(1, -1, n, n))[0]
        # intra blocks cost more bits than SATD shows: bias toward inter
        # (x64 is off in the reference: the int64 casts there are int32)
        inter = pcost.to(torch.int32) <= (icost.to(torch.int32) * 9) // 8

        def eval_sel(mv_c, rsel_c):
            out = None
            for r in range(nr):
                if weightp and r == 0:
                    p_r = weighted(tools["eval_mv_ps"](refs_y[0], mv_c))
                else:
                    p_r = tools["eval_mv"](refs_y[r], mv_c)
                out = p_r if out is None else torch.where(
                    (rsel_c == r)[:, None, None], p_r, out)
            return out

        def uniform_pass(mv, rsel, pred_y, pcost, inter, bs, inb):
            tl_mv, tl_r = top_left(mv, bs), top_left(rsel, bs)
            cand_pred = eval_sel(tl_mv, tl_r)
            cand_cost = satd(ob, cand_pred).to(torch.float32)
            nb2 = float(bs * bs)
            cand_cost_q = qsum(cand_cost, bs)
            accept = (cand_cost_q + lam * 4.0
                      < qsum(pcost, bs) + (lam * 6.0) * nb2)
            accept = accept & all_of(inter, bs) & inb
            mv = torch.where(accept[:, None], tl_mv, mv)
            rsel = torch.where(accept, tl_r, rsel)
            pred_y = torch.where(accept[:, None, None], cand_pred, pred_y)
            pcost = torch.where(accept, cand_cost_q * (1.0 / nb2), pcost)
            return mv, rsel, pred_y, pcost

        if gh % 2 == 0 and gw % 2 == 0 and g.log2_ctb >= 5:
            mv, rsel, pred_y, pcost = uniform_pass(
                mv, rsel, pred_y, pcost, inter, 2, quad_inbounds(2))
            if gh % 4 == 0 and gw % 4 == 0 and g.log2_ctb == 6:
                mv, rsel, pred_y, pcost = uniform_pass(
                    mv, rsel, pred_y, pcost, inter, 4, quad_inbounds(4))

        def sel_chroma(refs_c):
            pc = [tools["chroma_pred"](refs_c[r], mv) for r in range(nr)]
            if nr == 1:
                return pc[0]
            return torch.stack(pc).gather(
                0, rsel.long()[None, :, None, None].expand(
                    1, -1, n // 2, n // 2))[0]

        pred_cb = sel_chroma(refs_cb)
        pred_cr = sel_chroma(refs_cr)
        # frame-level costs for the scenecut decision
        cmin = torch.minimum(pcost, icost.to(torch.float32)).double()
        cost_p = torch.stack([cmin[f * nb:(f + 1) * nb].sum()
                              for f in range(F)])
        cost_i = torch.stack([icost[f * nb:(f + 1) * nb].to(
            torch.float64).sum() for f in range(F)])
        out = tuple(x.reshape((F, nb) + tuple(x.shape[1:])) for x in (
            mv, rsel, inter, pred_y, pred_cb, pred_cr))
        return (modes, mode32) + out + (cost_p, cost_i)

    def main(oy, ocb, ocr, modes, mode32, mv, rsel, inter, pred_y, pred_cb,
             pred_cr, qpy, qpb, qpr, lam, qp_base, dqp_cb, dqp_cr, sao_lam,
             qp_base_ctb, ref_pocs, nr_offsets=None):
        """Every per-frame input with its leading frame dimension;
        ``ref_pocs`` [nr] shared."""
        qp_base, dqp_cb, dqp_cr, sao_lam = (
            _frames(x) for x in (qp_base, dqp_cb, dqp_cr, sao_lam))
        merged = [finish.merged_masks(inter[f], (mv[f], rsel[f]))
                  for f in range(F)]
        m32_in = None
        if merged[0] is not None:
            m32_in = torch.stack([
                m32q | _rep(m64q, m32q.shape[0] // m64q.shape[0])
                for m32q, m64q in merged])
        out = run_scan(oy, ocb, ocr, modes, mode32,
                       torch.zeros((F, B32), dtype=torch.bool, device=dev),
                       qpy, qpb, qpr, lam=lam, is_inter=inter,
                       ipred_y=pred_y, ipred_cb=pred_cb, ipred_cr=pred_cr,
                       m32_in=m32_in, nr_offsets=nr_offsets)
        res = []
        for f in range(F):
            poc4 = _rep4(ref_pocs[rsel[f].long()], gh, gw)[:, :, 0]
            mv4 = _rep4(mv[f], gh, gw).to(torch.int32)
            motion_b = (torch.ones((gh * 4, gw * 4), dtype=torch.int32,
                                   device=dev), mv4, mv4, poc4, poc4)
            out_f = _frame_scan_out(out, f)
            small, tails, fplanes = finish(
                (oy[f], ocb[f], ocr[f]), out_f, qp_base[f], dqp_cb[f],
                dqp_cr[f], sao_lam[f], inter=inter[f], mv=mv[f],
                motion_b=motion_b, qp_base_ctb=qp_base_ctb[f],
                merged=merged[f])
            small = dict(small, use32=out_f[9], **nr_outputs(out_f[11]))
            res.append((small, tails, extend(fplanes)))
        return _stack_frames(res)

    def run(oy, ocb, ocr, refs_y, refs_cb, refs_cr, qpy, qpb, qpr, lam,
            qp_base, dqp_cb, dqp_cr, sao_lam, qp_base_ctb, ref_pocs,
            wy=64, wo=0, n_act=None, nr_offsets=None):
        if n_act is None:
            n_act = len(refs_y)
        refs_y, refs_cb, refs_cr = (tuple(refs) for refs in (
            refs_y, refs_cb, refs_cr))
        args = [oy, ocb, ocr, qpy, qpb, qpr, lam, qp_base_ctb]
        if not batch:
            args = [x[None] for x in args]
            refs_y, refs_cb, refs_cr = (tuple(r[None] for r in refs)
                                        for refs in (refs_y, refs_cb,
                                                     refs_cr))
        oy, ocb, ocr, qpy, qpb, qpr, lam, qp_base_ctb = args
        rbits = ref_idx_bits(nr, n_act)
        (modes, mode32, mv, rsel, inter, pred_y, pred_cb, pred_cr,
         cost_p, cost_i) = prep(oy, refs_y, refs_cb, refs_cr, qp_base, rbits,
                                wy, wo)
        small, tails, ext = main(
            oy, ocb, ocr, modes, mode32, mv, rsel, inter, pred_y, pred_cb,
            pred_cr, qpy, qpb, qpr, lam, qp_base, dqp_cb, dqp_cr, sao_lam,
            qp_base_ctb, torch.as_tensor(np.asarray(ref_pocs, np.int32),
                                         device=dev), nr_offsets)
        small = dict(small, modes=modes, mode32=mode32, mv=mv.to(torch.int16),
                     ref_idx=rsel, inter=inter, cost_p=cost_p, cost_i=cost_i)
        if not batch:
            small = {k: v[0] for k, v in small.items()}
            tails = {k: tuple(p[0] for p in v) for k, v in tails.items()}
            ext = tuple(p[0] for p in ext)
        return small, tails, ext

    run.prep = prep
    run.main = main
    run.nr = nr
    return run


def build_b_pipeline(enc, batch: int | None = None, make_ext: bool = False):
    """B-frame program: intra analysis, ME per list (K2 inside), the bi
    trial at the two uni winners, the direction decision, full-motion
    neighbour adoption, CU-merge uniformization, chroma per direction, the
    CTU scan (K1) with the inter TU32 trial, loop filters and, with
    ``make_ext`` (the b-pyramid's reference B), the DPB extension.

    ``batch=F``: F independent B frames of one mini-GOP against the same
    two references, on a leading frame dimension of every per-frame input
    and output (the reference vmaps ``prep`` / ``main``): each list's
    search is one K2 launch for all F frames, and each scan level one K1
    launch over their F x L lanes.  ``batch=None``: one frame, no frame
    dimension.

    run(oy, ocb, ocr, r0y, r0cb, r0cr, r1y, r1cb, r1cr, qpy, qpb, qpr, lam,
    qp_base, dqp_cb, dqp_cr, sao_lam, poc_l0, poc_l1, qp_base_ctb) ->
    (small, tails, ext); ``qp_base``, ``dqp_*`` and ``sao_lam`` are one
    value per frame."""
    g = enc.geom
    dev = enc.device
    n = 16
    ph = g.ctbs_h << g.log2_ctb
    pw = g.ctbs_w << g.log2_ctb
    gh, gw = ph // n, pw // n
    nb = gh * gw
    scan = enc._get_ctu_scan()
    decide = bool(scan.t["has32"])
    run_scan = scan.scan_fn(inter=True, decide32=decide)
    B32 = scan.t["b32_n"]
    analyse16 = _analyse_builder(enc, n, gh, gw, ph, pw)
    finish = _filter_stage_builder(enc)
    tools = _inter_tools_builder(enc)
    extend = _extend_builder(enc) if make_ext else None
    me, eval_mv = tools["me"], tools["eval_mv"]
    eval_mv_ps = tools["eval_mv_ps"]
    satd_, bi = tools["satd"], tools["bi_avg"]
    col_ok = torch.arange(nb, device=dev) % gw > 0
    row_ok = torch.arange(nb, device=dev) // gw > 0
    F = batch or 1
    quad_inbounds, qsum, top_left, all_of = _quad_helpers(g, F, dev)

    def prep(oy, r0y, r0cb, r0cr, r1y, r1cb, r1cr, qp_base):
        """Returns (modes, mode32, mv0, mv1, d, inter, pred_y, pred_cb,
        pred_cr), each with a leading frame dimension when batched."""
        oy = oy.reshape(F, ph, pw)
        lam_f = torch.stack([me_lambda(q) for q in _frames(qp_base)]).to(dev)
        lam = lam_f.repeat_interleave(nb)              # [F * nb]
        an = [analyse16(oy[f]) for f in range(F)]
        modes = torch.stack([a[0] for a in an])
        icost = torch.cat([a[1] for a in an])
        oy32 = oy.to(torch.int32)
        ob = oy32.reshape(F, gh, n, gw, n).permute(0, 1, 3, 2, 4).reshape(
            -1, n, n)
        if decide:
            mode32 = modes.reshape(F, gh, gw)[:, 0::2, 0::2].reshape(F, -1)
        else:
            mode32 = torch.zeros((F, B32), dtype=torch.int32, device=dev)
        mv0, c0, p0 = me(oy32, r0y, ob, lam_f)
        mv1, c1, p1 = me(oy32, r1y, ob, lam_f)
        c0 = c0.to(torch.int32)
        c1 = c1.to(torch.int32)
        # bi trial at the two uni winners
        pbi = bi(eval_mv_ps(r0y, mv0), eval_mv_ps(r1y, mv1))
        cbi = satd_(ob, pbi).to(torch.int32)
        # direction decision with a bits bias: bi codes two mvd/mvp sets
        cbi_b = cbi + (8.0 * lam).to(torch.int32)
        c01 = torch.minimum(c0, c1)
        d = torch.where(cbi_b <= c01, 3, torch.where(c0 <= c1, 1, 2)).to(
            torch.int32)
        best = torch.where(d == 3, cbi_b, c01)
        # (x64 is off in the reference: the int64 casts there are int32)
        inter = best <= (icost.to(torch.int32) * 9) // 8
        pred_y = torch.where((d == 3)[:, None, None], pbi,
                             torch.where((d == 1)[:, None, None], p0, p1))

        def eval_b(m0, m1, dd):
            e0 = eval_mv(r0y, m0)
            e1 = eval_mv(r1y, m1)
            eb = bi(eval_mv_ps(r0y, m0), eval_mv_ps(r1y, m1))
            return torch.where((dd == 3)[:, None, None], eb,
                               torch.where((dd == 1)[:, None, None], e0, e1))

        def grid(a):
            return a.reshape((F, gh, gw) + tuple(a.shape[1:]))

        # full-motion coherence: a neighbour's (mv0, mv1, dir) within a
        # merge bonus of 16 * lambda; the north pass reads the motion the
        # west pass left
        bonus = (16.0 * lam).to(torch.int32)
        cost = best
        for axis, valid in ((2, col_ok.repeat(F)), (1, row_ok.repeat(F))):
            def rl(a):
                return torch.roll(grid(a), 1, axis).reshape(a.shape)

            c0r, c1r, cdr = rl(mv0), rl(mv1), rl(d)
            cp = eval_b(c0r, c1r, cdr)
            cc = satd_(ob, cp).to(torch.int32)
            better = (cc < cost + bonus) & valid & rl(inter)
            mv0 = torch.where(better[:, None], c0r, mv0)
            mv1 = torch.where(better[:, None], c1r, mv1)
            d = torch.where(better, cdr, d)
            pred_y = torch.where(better[:, None, None], cp, pred_y)
            cost = torch.where(better, cc, cost)

        def uniform_pass_b(mv0, mv1, d, pred_y, cost, bs, inb):
            tl0, tl1, tld = (top_left(a, bs) for a in (mv0, mv1, d))
            cand_pred = eval_b(tl0, tl1, tld)
            cand_cost = satd_(ob, cand_pred).to(torch.float32)
            nb2 = float(bs * bs)
            cq = qsum(cand_cost, bs)
            accept = (cq + lam * 4.0
                      < qsum(cost.to(torch.float32), bs) + (lam * 6.0) * nb2)
            accept = accept & all_of(inter, bs) & inb
            mv0 = torch.where(accept[:, None], tl0, mv0)
            mv1 = torch.where(accept[:, None], tl1, mv1)
            d = torch.where(accept, tld, d)
            pred_y = torch.where(accept[:, None, None], cand_pred, pred_y)
            cost = torch.where(accept, (cq * (1.0 / nb2)).to(torch.int32),
                               cost)
            return mv0, mv1, d, pred_y, cost

        if gh % 2 == 0 and gw % 2 == 0 and g.log2_ctb >= 5:
            mv0, mv1, d, pred_y, cost = uniform_pass_b(
                mv0, mv1, d, pred_y, cost, 2, quad_inbounds(2))
            if gh % 4 == 0 and gw % 4 == 0 and g.log2_ctb == 6:
                mv0, mv1, d, pred_y, cost = uniform_pass_b(
                    mv0, mv1, d, pred_y, cost, 4, quad_inbounds(4))
        d3 = (d == 3)[:, None, None]
        d1 = (d == 1)[:, None, None]

        def chroma(r0c, r1c):
            pb = bi(tools["chroma_pred_ps"](r0c, mv0),
                    tools["chroma_pred_ps"](r1c, mv1))
            return torch.where(d3, pb, torch.where(
                d1, tools["chroma_pred"](r0c, mv0),
                tools["chroma_pred"](r1c, mv1)))

        out = (modes, mode32, mv0, mv1, d, inter, pred_y, chroma(r0cb, r1cb),
               chroma(r0cr, r1cr))
        out = tuple(x.reshape((F, -1) + tuple(x.shape[1:])) if i >= 2 else x
                    for i, x in enumerate(out))
        return out if batch else tuple(x[0] for x in out)

    def main(oy, ocb, ocr, modes, mode32, mv0, mv1, d, inter, pred_y,
             pred_cb, pred_cr, qpy, qpb, qpr, lam, qp_base, dqp_cb, dqp_cr,
             sao_lam, poc_l0, poc_l1, qp_base_ctb, nr_offsets=None):
        args = [oy, ocb, ocr, modes, mode32, mv0, mv1, d, inter, pred_y,
                pred_cb, pred_cr, qpy, qpb, qpr, lam, qp_base_ctb]
        if not batch:
            args = [x[None] for x in args]
        (oy, ocb, ocr, modes, mode32, mv0, mv1, d, inter, pred_y, pred_cb,
         pred_cr, qpy, qpb, qpr, lam, qp_base_ctb) = args
        qp_base, dqp_cb, dqp_cr, sao_lam = (
            _frames(x) for x in (qp_base, dqp_cb, dqp_cr, sao_lam))
        merged = [finish.merged_masks(inter[f], (mv0[f], mv1[f], d[f]))
                  for f in range(F)]
        m32_in = None
        if merged[0] is not None:
            m32_in = torch.stack([
                m32q | _rep(m64q, m32q.shape[0] // m64q.shape[0])
                for m32q, m64q in merged])
        out = run_scan(oy, ocb, ocr, modes, mode32,
                       torch.zeros((F, B32), dtype=torch.bool, device=dev),
                       qpy, qpb, qpr, lam=lam, is_inter=inter,
                       ipred_y=pred_y, ipred_cb=pred_cb, ipred_cr=pred_cr,
                       m32_in=m32_in, nr_offsets=nr_offsets)
        res = []
        for f in range(F):
            # normalised per-4x4 two-list motion for the deblock
            dir_eff = torch.where(inter[f], d[f], 1)
            nmv = torch.where(dir_eff == 3, 2, 1).to(torch.int32)
            mva = torch.where((dir_eff == 2)[:, None], mv1[f], mv0[f])
            poca = torch.where(dir_eff == 2, int(poc_l1), int(poc_l0))
            mvb = torch.where((dir_eff == 3)[:, None], mv1[f], mva)
            pocb = torch.where(dir_eff == 3, int(poc_l1), poca)
            motion_b = (_rep4(nmv, gh, gw)[:, :, 0],
                        _rep4(mva, gh, gw).to(torch.int32),
                        _rep4(mvb, gh, gw).to(torch.int32),
                        _rep4(poca.to(torch.int32), gh, gw)[:, :, 0],
                        _rep4(pocb.to(torch.int32), gh, gw)[:, :, 0])
            out_f = _frame_scan_out(out, f)
            small, tails, fplanes = finish(
                (oy[f], ocb[f], ocr[f]), out_f, qp_base[f], dqp_cb[f],
                dqp_cr[f], sao_lam[f], inter=inter[f], mv=mv0[f],
                motion_b=motion_b, qp_base_ctb=qp_base_ctb[f],
                merged=merged[f])
            small = dict(small, use32=out_f[9], **nr_outputs(out_f[11]))
            res.append((small, tails,
                        extend(fplanes) if make_ext else None))
        return _stack_frames(res) if batch else res[0]

    def run(oy, ocb, ocr, r0y, r0cb, r0cr, r1y, r1cb, r1cr, qpy, qpb, qpr,
            lam, qp_base, dqp_cb, dqp_cr, sao_lam, poc_l0, poc_l1,
            qp_base_ctb, nr_offsets=None):
        (modes, mode32, mv0, mv1, d, inter, pred_y, pred_cb,
         pred_cr) = prep(oy, r0y, r0cb, r0cr, r1y, r1cb, r1cr, qp_base)
        small, tails, ext = main(oy, ocb, ocr, modes, mode32, mv0, mv1, d,
                                 inter, pred_y, pred_cb, pred_cr, qpy, qpb,
                                 qpr, lam, qp_base, dqp_cb, dqp_cr, sao_lam,
                                 poc_l0, poc_l1, qp_base_ctb, nr_offsets)
        small = dict(small, modes=modes, mode32=mode32,
                     mv0=mv0.to(torch.int16), mv1=mv1.to(torch.int16),
                     dirs=d.to(torch.uint8), inter=inter)
        return small, tails, ext

    run.prep = prep
    run.main = main
    return run
