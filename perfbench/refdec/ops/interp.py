"""Motion-compensation interpolation (H.265 §8.5.4.2.2): 8-tap luma and
4-tap chroma — torch twin of the batched ``x265_tpu.ops.interp`` paths.

Windows are pre-gathered per block ([B, h+7, w+7] luma with top-left at
integer position (ix-3, iy-3); [B, h+3, w+3] chroma at (ix-1, iy-1)); the
separable filters run as int32 tap sums.  The per-block numpy versions
(``mc_luma_np``, ``mc_chroma_np``, their 14-bit ``_ps_np`` variants,
``bi_avg_np``, ``uni_round_np``) are the reference's, which the decoder's
host motion compensation runs.
"""

from __future__ import annotations

import numpy as np


# Table 8-11: luma 8-tap filters per quarter-pel phase
LUMA_FILTERS = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
], dtype=np.int32)

# Table 8-12: chroma 4-tap filters per eighth-pel phase
CHROMA_FILTERS = np.array([
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2],
], dtype=np.int32)


# ---------------------------------------------------------------------------
# numpy reference (per block): the decoder's host MC
# ---------------------------------------------------------------------------

def _clip_gather(plane: np.ndarray, y0: int, x0: int, h: int, w: int):
    """Edge-clamped window gather (reference planes are edge-extended in the
    reference encoder; clamping indices is equivalent)."""
    H, W = plane.shape
    ys = np.clip(np.arange(y0, y0 + h), 0, H - 1)
    xs = np.clip(np.arange(x0, x0 + w), 0, W - 1)
    return plane[np.ix_(ys, xs)].astype(np.int32)


def mc_luma_np(ref: np.ndarray, x0: int, y0: int, w: int, h: int,
               mv_x: int, mv_y: int, bit_depth: int = 8) -> np.ndarray:
    """Luma MC for one block: mv in quarter-pel units.  §8.5.4.2.2.1."""
    ix, fx = x0 + (mv_x >> 2), mv_x & 3
    iy, fy = y0 + (mv_y >> 2), mv_y & 3
    shift1 = bit_depth - 8
    maxv = (1 << bit_depth) - 1
    if fx == 0 and fy == 0:
        return _clip_gather(ref, iy, ix, h, w)
    if fy == 0:
        win = _clip_gather(ref, iy, ix - 3, h, w + 7)
        f = LUMA_FILTERS[fx]
        acc = sum(int(f[k]) * win[:, k:k + w] for k in range(8))
        # == ps (acc >> shift1) then uni round (+off1 >> 14-bd); single-shift
        # form is exact by the no-remainder-crossing argument
        return np.clip((acc + 32) >> 6, 0, maxv)
    if fx == 0:
        win = _clip_gather(ref, iy - 3, ix, h + 7, w)
        f = LUMA_FILTERS[fy]
        acc = sum(int(f[k]) * win[k:k + h, :] for k in range(8))
        # == ps (acc >> shift1) then uni round (+off1 >> 14-bd); single-shift
        # form is exact by the no-remainder-crossing argument
        return np.clip((acc + 32) >> 6, 0, maxv)
    # separable: horizontal to intermediate (shift bit_depth-8), then vertical
    win = _clip_gather(ref, iy - 3, ix - 3, h + 7, w + 7)
    fh = LUMA_FILTERS[fx]
    tmp = sum(int(fh[k]) * win[:, k:k + w] for k in range(8)) >> shift1
    fv = LUMA_FILTERS[fy]
    acc = sum(int(fv[k]) * tmp[k:k + h, :] for k in range(8))
    return np.clip((acc + (1 << (11 - shift1))) >> (12 - shift1), 0, maxv)


def mc_chroma_np(ref: np.ndarray, x0: int, y0: int, w: int, h: int,
                 mv_x: int, mv_y: int, bit_depth: int = 8) -> np.ndarray:
    """Chroma MC: mv in eighth-pel units (luma qpel mv doubles).  Plane and
    coords in chroma samples."""
    ix, fx = x0 + (mv_x >> 3), mv_x & 7
    iy, fy = y0 + (mv_y >> 3), mv_y & 7
    shift1 = bit_depth - 8
    maxv = (1 << bit_depth) - 1
    if fx == 0 and fy == 0:
        return _clip_gather(ref, iy, ix, h, w)
    if fy == 0:
        win = _clip_gather(ref, iy, ix - 1, h, w + 3)
        f = CHROMA_FILTERS[fx]
        acc = sum(int(f[k]) * win[:, k:k + w] for k in range(4))
        # == ps (acc >> shift1) then uni round (+off1 >> 14-bd); single-shift
        # form is exact by the no-remainder-crossing argument
        return np.clip((acc + 32) >> 6, 0, maxv)
    if fx == 0:
        win = _clip_gather(ref, iy - 1, ix, h + 3, w)
        f = CHROMA_FILTERS[fy]
        acc = sum(int(f[k]) * win[k:k + h, :] for k in range(4))
        # == ps (acc >> shift1) then uni round (+off1 >> 14-bd); single-shift
        # form is exact by the no-remainder-crossing argument
        return np.clip((acc + 32) >> 6, 0, maxv)
    win = _clip_gather(ref, iy - 1, ix - 1, h + 3, w + 3)
    fh = CHROMA_FILTERS[fx]
    tmp = sum(int(fh[k]) * win[:, k:k + w] for k in range(4)) >> shift1
    fv = CHROMA_FILTERS[fy]
    acc = sum(int(fv[k]) * tmp[k:k + h, :] for k in range(4))
    return np.clip((acc + (1 << (11 - shift1))) >> (12 - shift1), 0, maxv)


# ---------------------------------------------------------------------------
# ps-domain (14-bit intermediate) variants for bi-prediction
# ---------------------------------------------------------------------------
# Spec §8.5.4.2.2: fractional interpolation keeps a 14-bit intermediate
# (shift1 = BitDepth-8 after the horizontal pass, shift2 = 6 after the
# vertical, integer positions << shift3 = 14-BitDepth); §8.5.3.3.3.2
# then combines: uni (pred + off1) >> (14-bd), bi (p0 + p1 + off2) >>
# (15-bd).  Reference embodiment: ipfilter.cpp interp_*_ps/sp/ss chains.


def mc_luma_ps_np(ref: np.ndarray, x0: int, y0: int, w: int, h: int,
                  mv_x: int, mv_y: int, bit_depth: int = 8) -> np.ndarray:
    """Luma MC to the 14-bit intermediate domain (no final round/clip)."""
    ix, fx = x0 + (mv_x >> 2), mv_x & 3
    iy, fy = y0 + (mv_y >> 2), mv_y & 3
    shift1 = bit_depth - 8
    shift3 = 14 - bit_depth
    if fx == 0 and fy == 0:
        return _clip_gather(ref, iy, ix, h, w) << shift3
    if fy == 0:
        win = _clip_gather(ref, iy, ix - 3, h, w + 7)
        f = LUMA_FILTERS[fx]
        return sum(int(f[k]) * win[:, k:k + w] for k in range(8)) >> shift1
    if fx == 0:
        win = _clip_gather(ref, iy - 3, ix, h + 7, w)
        f = LUMA_FILTERS[fy]
        return sum(int(f[k]) * win[k:k + h, :] for k in range(8)) >> shift1
    win = _clip_gather(ref, iy - 3, ix - 3, h + 7, w + 7)
    fh = LUMA_FILTERS[fx]
    tmp = sum(int(fh[k]) * win[:, k:k + w] for k in range(8)) >> shift1
    fv = LUMA_FILTERS[fy]
    return sum(int(fv[k]) * tmp[k:k + h, :] for k in range(8)) >> 6


def mc_chroma_ps_np(ref: np.ndarray, x0: int, y0: int, w: int, h: int,
                    mv_x: int, mv_y: int, bit_depth: int = 8) -> np.ndarray:
    """Chroma MC to the 14-bit intermediate domain (mv in eighth-pel)."""
    ix, fx = x0 + (mv_x >> 3), mv_x & 7
    iy, fy = y0 + (mv_y >> 3), mv_y & 7
    shift1 = bit_depth - 8
    shift3 = 14 - bit_depth
    if fx == 0 and fy == 0:
        return _clip_gather(ref, iy, ix, h, w) << shift3
    if fy == 0:
        win = _clip_gather(ref, iy, ix - 1, h, w + 3)
        f = CHROMA_FILTERS[fx]
        return sum(int(f[k]) * win[:, k:k + w] for k in range(4)) >> shift1
    if fx == 0:
        win = _clip_gather(ref, iy - 1, ix, h + 3, w)
        f = CHROMA_FILTERS[fy]
        return sum(int(f[k]) * win[k:k + h, :] for k in range(4)) >> shift1
    win = _clip_gather(ref, iy - 1, ix - 1, h + 3, w + 3)
    fh = CHROMA_FILTERS[fx]
    tmp = sum(int(fh[k]) * win[:, k:k + w] for k in range(4)) >> shift1
    fv = CHROMA_FILTERS[fy]
    return sum(int(fv[k]) * tmp[k:k + h, :] for k in range(4)) >> 6


def bi_avg_np(p0: np.ndarray, p1: np.ndarray, bit_depth: int = 8):
    """Default bi-prediction combine of two 14-bit predictions
    (§8.5.3.3.3.2): (p0 + p1 + off2) >> (15-bd), clipped."""
    shift2 = 15 - bit_depth
    off2 = 1 << (shift2 - 1)
    return np.clip((p0.astype(np.int64) + p1 + off2) >> shift2,
                   0, (1 << bit_depth) - 1).astype(np.int32)

