"""Sample Adaptive Offset (H.265 §8.7.3) estimation and apply on padded
planes — torch twin of ``x265_tpu.ops.sao`` (``sao_estimate_plane_jnp``,
``sao_apply_plane_jnp``), and the decoder's apply
(``sao_apply_decoded_plane``, equal to ``sao_apply_plane_np`` on the
coded-size crop).

Every float sum here is integer-valued and below 2^24 (per-CTB counts and
difference sums, offset-walk deltas), exactly as in the reference, so the
summation order cannot change a result.
"""

from __future__ import annotations

import numpy as np
import torch

from .._util import dev_table

# EO neighbor offsets per class: ((dy0, dx0), (dy1, dx1))
EO_NEIGHBORS = [((0, -1), (0, 1)), ((-1, 0), (1, 0)),
                ((-1, -1), (1, 1)), ((-1, 1), (1, -1))]


def eo_valid_masks_np(ph, pw, coded_w, coded_h):
    """Static per-class EO validity masks on the padded plane: the sample
    and both its neighbors must lie inside the CODED picture (a copy of
    the reference's numpy helper)."""
    out = []
    xx = np.arange(pw)[None, :]
    yy = np.arange(ph)[:, None]
    inside = (xx < coded_w) & (yy < coded_h)
    for (dy0, dx0), (dy1, dx1) in EO_NEIGHBORS:
        v = inside.copy()
        for (dy, dx) in ((dy0, dx0), (dy1, dx1)):
            if dy == -1:
                v &= yy > 0
            if dy == 1:
                v &= yy < coded_h - 1
            if dx == -1:
                v &= xx > 0
            if dx == 1:
                v &= xx < coded_w - 1
        out.append(np.broadcast_to(v, (ph, pw)).copy())
    return np.stack(out), np.broadcast_to(inside, (ph, pw)).copy()


def _eo_category(p, klass, valid):
    """Per-sample EO category on a padded plane (0 = unfiltered)."""
    (dy0, dx0), (dy1, dx1) = EO_NEIGHBORS[klass]
    n0 = torch.roll(p, (-dy0, -dx0), dims=(0, 1))
    n1 = torch.roll(p, (-dy1, -dx1), dims=(0, 1))
    s = torch.sign(p - n0) + torch.sign(p - n1)
    cat = torch.where(s < 0, s + 3, torch.where(s > 0, s + 2, 0))
    return torch.where(valid, cat, 0)


def _best_offsets(cnt, dsum, lo, hi):
    """Vectorized x265 estIterOffset walk: (offset, dist_delta), float32."""
    o0 = torch.where(cnt > 0, torch.round(dsum / cnt.clamp(min=1.0)), 0.0)
    o0 = torch.minimum(torch.maximum(o0, lo), hi)
    best_o = torch.zeros_like(o0)
    best_d = torch.zeros_like(o0)
    for mag in range(7, 0, -1):
        for sgn in (-1.0, 1.0):
            o = sgn * mag
            valid = (torch.sign(o0) == sgn) & (o0.abs() >= mag)
            d = cnt * o * o - 2.0 * o * dsum
            take = valid & (d < best_d)
            best_d = torch.where(take, d, best_d)
            best_o = torch.where(take, torch.full_like(o0, o), best_o)
    return best_o, best_d


def sao_estimate_plane(orig, rec, ctbs_h, ctbs_w, ctb, eo_valid, inside,
                       bit_depth=8):
    """Per-CTB SAO statistics for one padded plane: (dist [ch, cw, 6],
    offs [ch, cw, 6, 4], band_pos [ch, cw] int32, bits [ch, cw, 6]);
    option 0 = off, 1..4 = EO class, 5 = BO."""
    dev = rec.device
    f32 = torch.float32
    diff = (orig - rec).to(f32)
    shift = bit_depth - 5

    def ctb_sum_k(x):
        k = x.shape[-1]
        return x.reshape(ctbs_h, ctb, ctbs_w, ctb, k).sum(dim=(1, 3))

    dist = [torch.zeros((ctbs_h, ctbs_w), dtype=f32, device=dev)]
    offs = [torch.zeros((ctbs_h, ctbs_w, 4), dtype=f32, device=dev)]
    bits = [torch.zeros((ctbs_h, ctbs_w), dtype=f32, device=dev)]
    lo = torch.tensor([0.0, 0.0, -7.0, -7.0], device=dev)
    hi = torch.tensor([7.0, 7.0, 0.0, 0.0], device=dev)
    ar4 = torch.arange(1, 5, device=dev)
    for k in range(4):
        cat = _eo_category(rec, k, eo_valid[k])
        oh = (cat[..., None] == ar4).to(f32)
        cnt = ctb_sum_k(oh)
        dsum = ctb_sum_k(oh * diff[..., None])
        o, dd = _best_offsets(cnt, dsum, lo, hi)
        dist.append(dd.sum(-1))
        offs.append(o)
        bits.append(2.0 + (o.abs() + 1.0).sum(-1))

    band = rec >> shift
    oh = ((band[..., None] == torch.arange(32, device=dev))
          & inside[..., None]).to(f32)
    bcnt = ctb_sum_k(oh)
    bsum = ctb_sum_k(oh * diff[..., None])
    bo, bdd = _best_offsets(bcnt, bsum, torch.tensor(-7.0, device=dev),
                            torch.tensor(7.0, device=dev))
    wnd_dd = torch.stack(
        [sum(bdd[..., (pos + i) & 31] for i in range(4))
         for pos in range(32)], -1)
    best_pos = torch.argmin(wnd_dd, -1).to(torch.int32)
    best_dd = torch.clamp(wnd_dd.amin(-1), max=0.0)
    wnd_idx = (best_pos[..., None] + torch.arange(4, device=dev)) & 31
    bo_sel = torch.gather(bo, -1, wnd_idx.long())
    dist.append(best_dd)
    offs.append(bo_sel)
    bits.append(2.0 + 5.0 + bo_sel.abs().sum(-1) + 8.0)
    return (torch.stack(dist, -1), torch.stack(offs, -2), best_pos,
            torch.stack(bits, -1))


def sao_apply_plane(plane, ctbs_h, ctbs_w, ctb, types, classes, band_pos,
                    offsets, eo_valid, bit_depth=8):
    """SAO apply on a padded plane; per-CTB types/classes/band_pos [ch, cw]
    and signed offsets [ch, cw, 4]."""
    maxval = (1 << bit_depth) - 1

    def rep(a):
        return a.to(torch.int32).repeat_interleave(ctb, 0).repeat_interleave(
            ctb, 1)

    kmap = rep(classes)
    cat = sum(torch.where(kmap == k, _eo_category(plane, k, eo_valid[k]), 0)
              for k in range(4))
    offp = [rep(offsets[..., i]) for i in range(4)]
    eo_off = sum(torch.where(cat == i + 1, offp[i], 0) for i in range(4))
    band = plane >> (bit_depth - 5)
    bo_off = sum(torch.where(band == rep((band_pos + i) & 31), offp[i], 0)
                 for i in range(4))
    tmap = rep(types)
    off = torch.where(tmap == 2, eo_off, torch.where(tmap == 1, bo_off, 0))
    return (plane + off).clamp(0, maxval)


def sao_apply_decoded_plane(plane, ps, c_idx: int, ctb: int, coded_w: int,
                            coded_h: int, bit_depth: int = 8):
    """SAO of one decoded plane on its device: ``plane`` [ph, pw] int32 at
    the CTB-padded size (``ctb`` in this plane's samples), the per-CTB
    parameters of component ``c_idx`` (0 = Y, 1 = Cb, 2 = Cr; Cb and Cr
    share the type and class) from ``ps``; the samples inside the coded
    ``coded_w`` x ``coded_h`` picture equal ``sao_apply_plane_np`` on the
    coded-size crop."""
    g = ps.geom
    ch, cw = g.ctbs_h, g.ctbs_w
    sel = 0 if c_idx == 0 else 1
    dev = plane.device
    ph, pw = plane.shape

    def t(a, *shape):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32).reshape(
            ch, cw, *shape), device=dev)

    valid = dev_table(("eo_valid", ph, pw, coded_w, coded_h),
                      lambda: eo_valid_masks_np(ph, pw, coded_w, coded_h)[0],
                      dev)
    return sao_apply_plane(plane, ch, cw, ctb, t(ps.sao_type[:, sel]),
                           t(ps.sao_eo_class[:, sel]),
                           t(ps.sao_band_pos[:, c_idx]),
                           t(ps.sao_offsets[:, c_idx], 4), valid, bit_depth)
