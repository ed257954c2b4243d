"""A frozen plain copy of the encoder's SAO decision (H.265 §7.4.9.3),
the benchmark's reference for the SAO parameters that a stream carries.

Given a picture's source planes, its deblocked planes before SAO (the
reference decoder's) and the lambda of its slice QP, it works out each
CTB's statistics (per edge class and category, and per band: the count
of samples and the sum of their differences from the source), the best
offsets by x265's walk from the rounded mean towards 0, the distortion
change and the bits of each of the six options (off, the four edge
classes, the band offset), and the option of least ``lambda * bits +
distortion``: luma alone, the two chroma planes together.  Only samples
inside the coded picture count; an edge sample counts only where both of
its neighbours lie inside too.  Every sum and product here is an exact
integer; the cost is a float32 fused multiply-add, rounded once.
"""

from __future__ import annotations

import numpy as np

# edge-offset neighbours per class: ((dy0, dx0), (dy1, dx1))
EO_NEIGHBORS = [((0, -1), (0, 1)), ((-1, 0), (1, 0)),
                ((-1, -1), (1, 1)), ((-1, 1), (1, -1))]


def sao_lambda(slice_qp: int) -> np.float32:
    """The SAO decision's lambda of a slice QP, as float32."""
    return np.float32(0.72 * 2.0 ** ((slice_qp - 12) / 3.0))


def _shifted(p: np.ndarray, dy: int, dx: int) -> np.ndarray:
    """``p`` read at (y + dy, x + dx), edge samples repeated outside."""
    h, w = p.shape
    q = np.pad(p, 1, mode="edge")
    return q[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def _edge_valid(h: int, w: int, klass: int) -> np.ndarray:
    yy = np.arange(h)[:, None]
    xx = np.arange(w)[None, :]
    v = np.ones((h, w), bool)
    for dy, dx in EO_NEIGHBORS[klass]:
        if dy == -1:
            v &= yy > 0
        if dy == 1:
            v &= yy < h - 1
        if dx == -1:
            v &= xx > 0
        if dx == 1:
            v &= xx < w - 1
    return v


def _best_offsets(cnt, dsum, lo, hi):
    """x265's offset walk: from the rounded mean (float32, half to even,
    clipped to [lo, hi]) towards 0, the offset of least ``cnt * o * o - 2 *
    o * dsum``; returns (offsets, distortion change), both integer."""
    c32 = cnt.astype(np.float32)
    d32 = dsum.astype(np.float32)
    q = d32 / np.maximum(c32, np.float32(1.0))
    o0 = np.where(cnt > 0, np.round(q), np.float32(0.0))
    o0 = np.minimum(np.maximum(o0, lo), hi)
    best_o = np.zeros(cnt.shape, np.int64)
    best_d = np.zeros(cnt.shape, np.int64)
    for mag in range(7, 0, -1):
        for sgn in (-1, 1):
            o = sgn * mag
            valid = (np.sign(o0) == sgn) & (np.abs(o0) >= mag)
            d = cnt * o * o - 2 * o * dsum
            take = valid & (d < best_d)
            best_d = np.where(take, d, best_d)
            best_o = np.where(take, o, best_o)
    return best_o, best_d


def estimate(orig: np.ndarray, rec: np.ndarray, ctb: int, bit_depth: int):
    """One plane's statistics on its coded size: (dist [n, 6], offs [n, 6,
    4], band_pos [n], bits [n, 6]), n the CTBs in raster order; option 0
    is off, 1-4 the edge classes, 5 the band offset."""
    h, w = rec.shape
    ch, cw = -(-h // ctb), -(-w // ctb)
    n = ch * cw
    rec = rec.astype(np.int64)
    diff = orig.astype(np.int64) - rec
    ctb_id = ((np.arange(h) // ctb)[:, None] * cw
              + (np.arange(w) // ctb)[None, :])
    dist = [np.zeros(n, np.int64)]
    offs = [np.zeros((n, 4), np.int64)]
    bits = [np.zeros(n, np.int64)]
    lo = np.array([0, 0, -7, -7], np.float32)
    hi = np.array([7, 7, 0, 0], np.float32)
    for k in range(4):
        (dy0, dx0), (dy1, dx1) = EO_NEIGHBORS[k]
        s = (np.sign(rec - _shifted(rec, dy0, dx0))
             + np.sign(rec - _shifted(rec, dy1, dx1)))
        cat = np.where(s < 0, s + 3, np.where(s > 0, s + 2, 0))
        sel = _edge_valid(h, w, k) & (cat > 0)
        idx = ctb_id[sel] * 4 + cat[sel] - 1
        cnt = np.bincount(idx, minlength=n * 4).reshape(n, 4)
        dsum = np.bincount(idx, weights=diff[sel],
                           minlength=n * 4).astype(np.int64).reshape(n, 4)
        o, dd = _best_offsets(cnt, dsum, lo, hi)
        dist.append(dd.sum(-1))
        offs.append(o)
        bits.append(2 + (np.abs(o) + 1).sum(-1))
    band = rec >> (bit_depth - 5)
    idx = (ctb_id * 32 + band).ravel()
    bcnt = np.bincount(idx, minlength=n * 32).reshape(n, 32)
    bsum = np.bincount(idx, weights=diff.ravel(),
                       minlength=n * 32).astype(np.int64).reshape(n, 32)
    bo, bdd = _best_offsets(bcnt, bsum, np.float32(-7), np.float32(7))
    wnd = (np.arange(32)[:, None] + np.arange(4)[None, :]) & 31
    wnd_dd = bdd[:, wnd].sum(-1)                       # [n, 32]
    best_pos = np.argmin(wnd_dd, -1)
    dist.append(np.minimum(wnd_dd.min(-1), 0))
    sel = np.take_along_axis(bo, wnd[best_pos], -1)
    offs.append(sel)
    bits.append(2 + 5 + np.abs(sel).sum(-1) + 8)
    return (np.stack(dist, -1), np.stack(offs, -2), best_pos,
            np.stack(bits, -1))


def _cost(lam: np.float32, bits, dist) -> np.ndarray:
    """float32 ``lam * bits + dist`` rounded once (exact in float64
    first: the product of a float32 by a small integer, plus an integer
    under 2^25); off costs 0."""
    c = (np.float64(lam) * bits + dist).astype(np.float32)
    c[..., 0] = 0.0
    return c


def decide(orig3, rec3, ctb: int, lam: np.float32,
           bit_depth: int = 8) -> dict:
    """A picture's SAO parameters a CTB, as a decoder reads them:
    ``type`` [n, 2] (luma, chroma: 0 off, 1 band, 2 edge), ``eo_class``
    [n, 2], ``band_pos`` [n, 3] and signed ``offsets`` [n, 3, 4].  The
    source planes are padded to the coded size of ``rec3`` by repeating
    their last row and column, as the encoder pads its input."""
    orig3 = [np.pad(o, ((0, r.shape[0] - o.shape[0]),
                        (0, r.shape[1] - o.shape[1])), mode="edge")
             for o, r in zip(orig3, rec3)]
    est = [estimate(o, r, c, bit_depth)
           for o, r, c in zip(orig3, rec3, (ctb, ctb // 2, ctb // 2))]
    (dy, oy, py, by), (db, ob, pb, bb), (dr, orr, pr, br) = est
    best_y = np.argmin(_cost(lam, by, dy), -1)
    best_c = np.argmin(_cost(lam, bb + br, db + dr), -1)
    n = best_y.shape[0]
    out = dict(type=np.zeros((n, 2), np.int64),
               eo_class=np.zeros((n, 2), np.int64),
               band_pos=np.stack([py, pb, pr], 1),
               offsets=np.zeros((n, 3, 4), np.int64))
    for j, (best, planes) in enumerate(((best_y, ((0, oy),)),
                                        (best_c, ((1, ob), (2, orr))))):
        out["type"][:, j] = np.where(best == 0, 0, np.where(best == 5, 1, 2))
        out["eo_class"][:, j] = np.clip(best - 1, 0, 3)
        for c, offs in planes:
            out["offsets"][:, c] = offs[np.arange(n), best]
    return out


def ctbs_differing(ref: dict, sao_type, eo_class, band_pos, offsets) -> int:
    """CTB components (luma, chroma) whose SAO parameters in the stream
    (``sao_type`` [n, 2], ``eo_class`` [n, 2], ``band_pos`` [n, 3],
    ``offsets`` [n, 3, 4], as the decoder parsed them) differ from
    ``ref``'s: the type, and for an edge offset its class and offsets, for
    a band offset its band positions and offsets."""
    t = np.asarray(sao_type, np.int64)
    cls = np.asarray(eo_class, np.int64)
    pos = np.asarray(band_pos, np.int64)
    off = np.asarray(offsets, np.int64)
    bad = 0
    for j, comps in ((0, [0]), (1, [1, 2])):
        rt = ref["type"][:, j]
        d = t[:, j] != rt
        eo = rt == 2
        bo = rt == 1
        d |= eo & (cls[:, j] != ref["eo_class"][:, j])
        for c in comps:
            o = (off[:, c] != ref["offsets"][:, c]).any(-1)
            d |= (eo | bo) & o
            d |= bo & (pos[:, c] != ref["band_pos"][:, c])
        bad += int(d.sum())
    return bad
