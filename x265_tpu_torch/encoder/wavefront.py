"""Wavefront intra reconstruction of one plane at a fixed block size —
torch twin of ``x265_tpu.encoder.wavefront``.

The host levelizes the block grid's dependency DAG (normative z-scan
availability, §6.4.1) into a static schedule (``build_schedule``, cached
per geometry): every block whose reference samples are ready runs in the
same level, with gather, availability and scatter index tables.  The
device runs one batched step a level: gather -> reference substitution ->
the lane's intra mode -> residual -> transform -> quant -> dequant ->
inverse -> clip -> scatter.  Encoder and decoder share the step; the
encoder quantizes, the decoder reads the coefficient levels.

Where the reference selects each lane's mode by a one-hot contraction with
its 35-mode weight tensor (the MXU's way), the port predicts with the
angular formula of ``ops.intra`` (the same samples).  The scan is a torch
loop over the levels, as ``ctu_scan``'s plain scan is.  Blocks crossing
the picture's edge and their dependents are left to the caller
(``host_mask``), as in the reference.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..common.geometry import PictureGeometry, intra_neighbor_coords
from ..ops.intra import predict_modes, substitute_references
from ..ops.quantize import dequant, quant, quant_masked, sign_hide_diag
from ..ops.transforms import forward_transform, inverse_transform


def _substitute(samples, avail, bit_depth):
    """§8.4.4.2.2 substitution for [lanes, R] reference vectors."""
    return substitute_references(samples, avail, bit_depth)


def _predict_lanes(refs, modes, n, is_luma, bit_depth):
    """One intra mode per lane: refs [Lx, 4n+1] substituted, modes [Lx]
    -> pred [Lx, n, n] int32 (luma filters and edge post-filters as the
    spec and ``_predict_lanes`` apply them)."""
    return predict_modes(refs, modes, n, is_luma, bit_depth)


@functools.lru_cache(maxsize=8)
def build_schedule(width: int, height: int, log2_ctb: int, n: int,
                   chroma_shift: int = 0):
    """Static wavefront schedule for an n-sized block grid.

    For chroma (chroma_shift=1): n is the CHROMA block size, the grid is the
    chroma plane's, and availability is evaluated in luma coords (as the
    spec does).  Returns a dict of numpy arrays:
      lvl_blk   [L, Lmax]       flat block index (B = dummy for idle lanes)
      ref_idx   [L, Lmax, R]    gather indices into the flat plane
      ref_avail [L, Lmax, R]    availability mask
      sct_idx   [L, Lmax, n*n]  scatter indices (H*W = dummy slot)
      n_levels, lane count, grid shape
    """
    g = PictureGeometry(width, height, log2_ctb, 3)
    pw = (g.ctbs_w << log2_ctb) >> chroma_shift
    ph = (g.ctbs_h << log2_ctb) >> chroma_shift
    assert pw % n == 0 and ph % n == 0
    gw, gh = pw // n, ph // n
    nblocks = gw * gh
    r = 4 * n + 1

    lvl = np.zeros((gh, gw), np.int32)
    ref_x = np.zeros((gh * gw, r), np.int64)
    ref_y = np.zeros((gh * gw, r), np.int64)
    avail = np.zeros((gh * gw, r), bool)
    # levelize in decode (z-scan) order: every dependency has a smaller z
    # index, so its level is final when read (raster order is not safe:
    # below-left dependencies point to blocks later in raster order)
    order = sorted(
        ((by, bx) for by in range(gh) for bx in range(gw)),
        key=lambda p: int(g.zscan[((p[0] * n) << chroma_shift) >> 2,
                                  ((p[1] * n) << chroma_shift) >> 2]))
    # blocks fully outside the picture (CTB padding) are not coded; blocks
    # crossing its edge are coded as smaller CUs and left to the caller,
    # as is (transitively) any block whose available reference samples
    # touch one of them (the fixpoint below)
    in_pic = np.zeros((gh, gw), bool)
    crossing = np.zeros((gh, gw), bool)
    dep_list = [[] for _ in range(gh * gw)]
    for (by, bx) in order:
        b = by * gw + bx
        x0, y0 = bx * n, by * n
        if (x0 << chroma_shift) >= g.width or \
           (y0 << chroma_shift) >= g.height:
            lvl[by, bx] = -1
            continue
        if ((x0 + n) << chroma_shift) > g.width or \
           ((y0 + n) << chroma_shift) > g.height:
            crossing[by, bx] = True
        in_pic[by, bx] = True
        xs, ys = intra_neighbor_coords(x0, y0, n)
        av = g.avail_rows(x0 << chroma_shift, y0 << chroma_shift,
                          xs << chroma_shift, ys << chroma_shift)
        ref_x[b] = np.clip(xs, 0, pw - 1)
        ref_y[b] = np.clip(ys, 0, ph - 1)
        avail[b] = av
        deps = set()
        for a, X, Y in zip(av, xs, ys):
            if a:
                deps.add((int(Y) // n) * gw + int(X) // n)
        deps.discard(b)
        dep_list[b] = sorted(deps)
        m = 0
        for d in deps:
            dy, dx = d // gw, d % gw
            if 0 <= dy < gh and 0 <= dx < gw:
                m = max(m, lvl[dy, dx] + 1)
        lvl[by, bx] = m

    # fixpoint: unschedule any block depending on an unscheduled in-picture
    # block
    scheduled = in_pic & ~crossing
    changed = True
    while changed:
        changed = False
        for (by, bx) in order:
            b = by * gw + bx
            if not scheduled[by, bx]:
                continue
            for d in dep_list[b]:
                if in_pic[d // gw, d % gw] and not scheduled[d // gw, d % gw]:
                    scheduled[by, bx] = False
                    changed = True
                    break

    host_mask = in_pic & ~scheduled
    if not scheduled.any():
        return dict(n_levels=0, host_mask=host_mask, grid=(gh, gw),
                    plane=(ph, pw), n=n, lmax=0)

    n_levels = int(lvl[scheduled].max()) + 1
    counts = np.bincount(lvl[scheduled].ravel(), minlength=n_levels)
    lmax = int(counts.max())

    lvl_blk = np.full((n_levels, lmax), nblocks, np.int32)     # dummy = B
    ref_idx = np.zeros((n_levels, lmax, r), np.int32)
    ref_avail = np.zeros((n_levels, lmax, r), bool)
    sct_idx = np.full((n_levels, lmax, n * n), pw * ph, np.int32)
    fill = np.zeros(n_levels, np.int32)
    oy, ox = np.mgrid[0:n, 0:n]
    for by in range(gh):
        for bx in range(gw):
            if not scheduled[by, bx]:
                continue
            b = by * gw + bx
            li = int(lvl[by, bx])
            k = fill[li]
            fill[li] = k + 1
            lvl_blk[li, k] = b
            ref_idx[li, k] = (ref_y[b] * pw + ref_x[b]).astype(np.int32)
            ref_avail[li, k] = avail[b]
            sct_idx[li, k] = ((by * n + oy) * pw + bx * n + ox).ravel()

    return dict(lvl_blk=lvl_blk, ref_idx=ref_idx, ref_avail=ref_avail,
                sct_idx=sct_idx, n_levels=n_levels, lmax=lmax,
                grid=(gh, gw), plane=(ph, pw), n=n, host_mask=host_mask)


class WavefrontIntraRecon:
    """Wavefront reconstruction of one plane at a fixed block size, on
    ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, width: int, height: int, log2_ctb: int, n: int, *,
                 is_luma: bool, chroma_shift: int = 0, bit_depth: int = 8,
                 sign_hide: bool = False, device="cuda"):
        self.sched = build_schedule(width, height, log2_ctb, n, chroma_shift)
        self.n = n
        self.is_luma = is_luma
        self.bit_depth = bit_depth
        self.sign_hide = sign_hide
        self.device = torch.device(device)
        self._encode_fn = None
        self._decode_fn = None

    def _tables(self, paired: bool):
        """The schedule's level tables on the device; ``paired``: each
        level's lanes doubled for two planes in one flat buffer of two
        planes (lane order blk0 a, blk0 b, blk1 a, ...)."""
        s, n = self.sched, self.n
        if not paired:
            ridx, ravail, sidx = s["ref_idx"], s["ref_avail"], s["sct_idx"]
        else:
            flat = s["plane"][0] * s["plane"][1] + 1
            nl = s["n_levels"]
            ridx = np.stack([s["ref_idx"], s["ref_idx"] + flat],
                            axis=2).reshape(nl, -1, 4 * n + 1)
            ravail = np.repeat(s["ref_avail"], 2, axis=1)
            sidx = np.stack([s["sct_idx"], s["sct_idx"] + flat],
                            axis=2).reshape(nl, -1, n * n)
        dev = self.device
        return tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev)
                     for a in (s["lvl_blk"].astype(np.int64),
                               ridx.astype(np.int64), ravail,
                               sidx.astype(np.int64)))

    def _padded(self, x, dtype):
        """``x`` on the device as ``dtype`` with one zero row appended: the
        row the dummy lanes read."""
        x = torch.as_tensor(x, device=self.device).to(dtype)
        return torch.cat([x, torch.zeros((1,) + tuple(x.shape[1:]),
                                         dtype=dtype, device=self.device)])

    def _recon(self, levels, pred, qp, use_dst):
        """Dequant, inverse transform and clip of one level's lanes."""
        bd = self.bit_depth
        r2 = inverse_transform(dequant(levels, qp, bd), bd, dst=use_dst)
        has_coef = (levels != 0).any(2).any(1)[:, None, None]
        return torch.where(has_coef, pred + r2, pred).clamp(0, (1 << bd) - 1)

    def _levels_out(self, levels, lvl_blk):
        """[nl, Lmax, n, n] level stacks -> [B, n, n] int16 in block
        order (the dummy lanes write the dropped last row)."""
        n = self.n
        nblocks = self.sched["grid"][0] * self.sched["grid"][1]
        out = torch.zeros((nblocks + 1, n, n), dtype=torch.int16,
                          device=self.device)
        out[lvl_blk.reshape(-1)] = levels.reshape(-1, n, n).to(torch.int16)
        return out[:-1]

    # -- public --------------------------------------------------------------

    def scan_fn(self, encode: bool, inter: bool = False):
        """run(data, modes, qp[, inter_pred, is_inter]): ``data`` [B, n, n]
        originals (encode) or levels (decode), ``modes`` [B]; returns the
        recon plane [ph, pw] (uint8 at 8 bits, else int16 holding the
        reference's uint16 values) and, encoding, the levels [B, n, n]
        int16."""
        s = self.sched
        n, bd, is_luma = self.n, self.bit_depth, self.is_luma
        ph, pw = s["plane"]
        use_dst = is_luma and n == 4
        dev = self.device
        lvl_blk, ridx_all, ravail_all, sidx_all = self._tables(False)

        def run(data, modes, qp, inter_pred=None, is_inter=None):
            data = self._padded(data, torch.int32)
            modes = self._padded(modes, torch.int32)
            if inter:
                ipred = self._padded(inter_pred, torch.int32)
                ov = self._padded(is_inter, torch.bool)
            qp = torch.as_tensor(qp, dtype=torch.int32, device=dev)
            plane = torch.zeros((ph * pw + 1,), dtype=torch.int32,
                                device=dev)
            lv_all = []
            for li in range(s["n_levels"]):
                blk, sidx = lvl_blk[li], sidx_all[li]
                ref = _substitute(plane[ridx_all[li]], ravail_all[li], bd)
                pred = _predict_lanes(ref, modes[blk], n, is_luma, bd)
                if inter:
                    use_ov = ov[blk]
                    pred = torch.where(use_ov[:, None, None], ipred[blk],
                                       pred)
                if encode:
                    coef = forward_transform(data[blk] - pred, bd,
                                             dst=use_dst)
                    levels = (quant_masked(coef, qp, ~use_ov, bd) if inter
                              else quant(coef, qp, bd, intra=True))
                    if self.sign_hide:
                        # TU scans on this path are always diagonal
                        levels = sign_hide_diag(levels)
                    lv_all.append(levels)
                else:
                    levels = data[blk]
                rec = self._recon(levels, pred, qp, use_dst)
                plane[sidx.reshape(-1)] = rec.reshape(-1)
            out = plane[:-1].reshape(ph, pw).to(
                torch.uint8 if bd == 8 else torch.int16)
            if encode:
                return out, self._levels_out(torch.stack(lv_all), lvl_blk)
            return out

        return run

    def paired_scan_fn(self, encode: bool, inter: bool = False):
        """A scan of TWO planes sharing this schedule (Cb and Cr) in one
        loop: the lanes are doubled and one flat buffer holds both planes.

        run2((data_a, data_b), modes, (qp_a, qp_b)[, (ipred_a, ipred_b),
        is_inter]) -> ((plane_a, levels_a), (plane_b, levels_b)) encoding,
        (plane_a, plane_b) decoding."""
        s = self.sched
        n, bd, is_luma = self.n, self.bit_depth, self.is_luma
        assert not (is_luma and n == 4)
        ph, pw = s["plane"]
        flat = ph * pw + 1
        dev = self.device
        lvl_blk, ridx_all, ravail_all, sidx_all = self._tables(True)

        def ilv(a, b):
            """The two planes' block data interleaved: [2B + 2, n, n]."""
            return torch.stack([self._padded(x, torch.int32)
                                for x in (a, b)], 1).reshape(-1, n, n)

        def run2(datas, modes, qps, ipreds=None, is_inter=None):
            data = ilv(*datas)
            modes = self._padded(modes, torch.int32)
            if inter:
                ipred = ilv(*ipreds)
                ov = self._padded(is_inter, torch.bool)
            qps_v = torch.tensor([int(q) for q in qps], dtype=torch.int32,
                                 device=dev)
            planes = torch.zeros((2 * flat,), dtype=torch.int32, device=dev)
            lv_all = []
            for li in range(s["n_levels"]):
                blk2 = lvl_blk[li].repeat_interleave(2)
                lanes = blk2.shape[0]
                ref = _substitute(planes[ridx_all[li]], ravail_all[li], bd)
                pred = _predict_lanes(ref, modes[blk2], n, is_luma, bd)
                # per-lane plane id: 0, 1, 0, 1, ...
                pid = torch.arange(2, device=dev).repeat(lanes // 2)
                lane_qp = qps_v[pid]
                data_idx = blk2 * 2 + pid
                if inter:
                    use_ov = ov[blk2]
                    pred = torch.where(use_ov[:, None, None],
                                       ipred[data_idx], pred)
                if encode:
                    coef = forward_transform(data[data_idx] - pred, bd)
                    imask = (~use_ov if inter else
                             torch.ones((lanes,), dtype=torch.bool,
                                        device=dev))
                    levels = quant_masked(coef, lane_qp, imask, bd)
                    if self.sign_hide:
                        levels = sign_hide_diag(levels)
                    lv_all.append(levels)
                else:
                    levels = data[data_idx]
                rec = self._recon(levels, pred, lane_qp, False)
                planes[sidx_all[li].reshape(-1)] = rec.reshape(-1)
            out_dt = torch.uint8 if bd == 8 else torch.int16
            outs = []
            for p_i in range(2):
                pl = planes[p_i * flat:(p_i + 1) * flat - 1].reshape(
                    ph, pw).to(out_dt)
                if encode:
                    lv = torch.stack(lv_all).reshape(
                        s["n_levels"], -1, 2, n, n)[:, :, p_i]
                    outs.append((pl, self._levels_out(lv, lvl_blk)))
                else:
                    outs.append(pl)
            return tuple(outs)

        return run2

    def encode(self, orig_blocks, modes, qp):
        """orig_blocks [B, n, n], modes [B] int32, qp int -> (recon plane
        [ph, pw], levels [B, n, n] int16) on the device."""
        if self._encode_fn is None:
            self._encode_fn = self.scan_fn(encode=True)
        return self._encode_fn(orig_blocks, modes, qp)

    def decode(self, levels, modes, qp):
        """levels [B, n, n], modes [B] -> recon plane on the device."""
        if self._decode_fn is None:
            self._decode_fn = self.scan_fn(encode=False)
        return self._decode_fn(levels, modes, qp)
