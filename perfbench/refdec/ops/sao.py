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
