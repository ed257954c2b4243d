"""Intra prediction, all 35 HEVC modes, in plain torch: a frozen copy of
the encoder port's version, for the reference CTU step.  Each mode is
computed by the spec formulas (§8.4.4.2.4-6): planar and DC in closed
form, the angular modes as a two-tap gather from the canonical reference
vector with per-(mode, pixel) tap tables.  Canonical reference layout
(length 4N+1): reversed left column (below-left .. left), corner at 2N,
then the top row (top .. above-right)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ._util import dev_table

# §8.4.4.2.6: intraPredAngle for modes 2..34
ANGLES = np.array([32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17,
                   -21, -26, -32, -26, -21, -17, -13, -9, -5, -2, 0, 2, 5,
                   9, 13, 17, 21, 26, 32], dtype=np.int32)
INV_ANGLES = {-2: -4096, -5: -1638, -9: -910, -13: -630, -17: -482,
              -21: -390, -26: -315, -32: -256}

PLANAR, DC = 0, 1
HOR, VER = 10, 26


def ref_index(n: int, kind: str, i: int = 0) -> int:
    """Index into the canonical reference vector."""
    if kind == "left":     # p[-1][i], i in 0..2N-1
        return 2 * n - 1 - i
    if kind == "corner":
        return 2 * n
    if kind == "top":      # p[i][-1], i in 0..2N-1
        return 2 * n + 1 + i
    raise ValueError(kind)


def filter_flag(mode: int, n: int, is_luma: bool) -> bool:
    """§8.4.4.2.3 reference-sample filtering decision."""
    if not is_luma or mode == DC or n == 4:
        return False
    min_dist = min(abs(mode - HOR), abs(mode - VER)) if mode != PLANAR else 10
    return min_dist > {8: 7, 16: 1, 32: 0}[n]


@functools.lru_cache(maxsize=None)
def angular_taps(n: int):
    """(i0, i1, fact) [35, N*N] int32: for angular modes the two canonical
    reference indices and the fraction of §8.4.4.2.6, so that
    pred = ((32 - fact) * ref[i0] + fact * ref[i1] + 16) >> 5.
    Rows 0/1 (planar/DC) are unused zeros; fact == 0 repeats i0."""
    i0 = np.zeros((35, n * n), np.int32)
    i1 = np.zeros((35, n * n), np.int32)
    fa = np.zeros((35, n * n), np.int32)
    ci = ref_index(n, "corner")
    for mode in range(2, 35):
        a = int(ANGLES[mode - 2])
        vertical = mode >= 18

        def canon(i: int) -> int:
            # extended main reference M[i] -> canonical index
            if i == 0:
                return ci
            if i > 0:
                return (ref_index(n, "top", i - 1) if vertical
                        else ref_index(n, "left", i - 1))
            sidx = ((i * INV_ANGLES[a] + 128) >> 8) - 1
            if sidx < 0:
                return ci
            return (ref_index(n, "left", sidx) if vertical
                    else ref_index(n, "top", sidx))

        for q in range(n):
            pos = (q + 1) * a
            idx, fact = pos >> 5, pos & 31
            for p in range(n):
                y, x = (q, p) if vertical else (p, q)
                k = y * n + x
                i0[mode, k] = canon(p + idx + 1)
                i1[mode, k] = canon(p + idx + 2) if fact else i0[mode, k]
                fa[mode, k] = fact
    return i0, i1, fa


def _filt_table(n: int) -> np.ndarray:
    return np.array([filter_flag(m, n, True) for m in range(35)], bool)


def filter_refs(refs: torch.Tensor) -> torch.Tensor:
    """[1 2 1]/4 smoothing along the canonical vector, endpoints kept."""
    out = refs.clone()
    out[:, 1:-1] = (refs[:, :-2] + 2 * refs[:, 1:-1] + refs[:, 2:] + 2) >> 2
    return out


def _planar_dc(refs: torch.Tensor, n: int):
    """([B, N, N] planar, [B] dc value) from canonical refs [B, 4N+1]."""
    log2n = n.bit_length() - 1
    left = refs[:, :2 * n].flip(1)              # left[0..2N-1]
    top = refs[:, 2 * n + 1:]                   # top[0..2N-1]
    ar = torch.arange(n, device=refs.device, dtype=torch.int32)
    y = ar[:, None]
    x = ar[None, :]
    planar = ((n - 1 - x) * left[:, :n, None] + (x + 1) * top[:, n, None, None]
              + (n - 1 - y) * top[:, None, :n] + (y + 1) * left[:, n, None,
                                                                 None]
              + n) >> (log2n + 1)
    dc = (top[:, :n].sum(1) + left[:, :n].sum(1) + n) >> (log2n + 1)
    return planar.to(torch.int32), dc.to(torch.int32)


def _angular(refs: torch.Tensor, modes, n: int):
    """Angular prediction: refs [B, R] and per-row modes [B, M] (or None
    for all 35 modes on every row) -> [B, M, N*N]."""
    dev = refs.device
    i0, i1, fa = (dev_table(("ang", n, k),
                            lambda k=k: angular_taps(n)[k].astype(
                                np.int64 if k < 2 else np.int32), dev)
                  for k in range(3))
    if modes is None:
        # one index table shared by every row: plain advanced indexing
        r0, r1, f = refs[:, i0], refs[:, i1], fa[None]
    else:
        mi = modes.long()
        b = refs.shape[0]
        r0 = torch.gather(refs, 1, i0[mi].reshape(b, -1)).reshape(mi.shape
                                                                  + (-1,))
        r1 = torch.gather(refs, 1, i1[mi].reshape(b, -1)).reshape(mi.shape
                                                                  + (-1,))
        f = fa[mi]
    return ((32 - f) * r0 + f * r1 + 16) >> 5


def _edge_filters(pred, refs, modes, n, bit_depth):
    """DC boundary filter and pure H/V edge adjust (luma, N < 32).
    pred [B, M, N, N] with per-(block, slot) modes [B, M]."""
    maxval = (1 << bit_depth) - 1
    left = refs[:, n:2 * n].flip(1)
    top = refs[:, 2 * n + 1: 3 * n + 1]
    corner = refs[:, 2 * n]
    dc = (left.sum(1) + top.sum(1) + n) >> (n.bit_length())
    row0 = ((top + 3 * dc[:, None] + 2) >> 2)[:, None]        # [B, 1, N]
    col0 = ((left + 3 * dc[:, None] + 2) >> 2)[:, None]
    c00 = ((left[:, 0] + 2 * dc + top[:, 0] + 2) >> 2)[:, None]
    ver_col = (top[:, :1] + ((left - corner[:, None]) >> 1)).clamp(
        0, maxval)[:, None]
    hor_row = (left[:, :1] + ((top - corner[:, None]) >> 1)).clamp(
        0, maxval)[:, None]
    is_dc = (modes == DC)[..., None]
    pred = pred.clone()
    pred[:, :, 0, :] = torch.where(is_dc, row0, pred[:, :, 0, :])
    pred[:, :, :, 0] = torch.where(is_dc, col0, pred[:, :, :, 0])
    pred[:, :, 0, 0] = torch.where(is_dc[..., 0], c00, pred[:, :, 0, 0])
    pred[:, :, :, 0] = torch.where((modes == VER)[..., None], ver_col,
                                   pred[:, :, :, 0])
    pred[:, :, 0, :] = torch.where((modes == HOR)[..., None], hor_row,
                                   pred[:, :, 0, :])
    return pred


def _predict(refs, modes, n, is_luma, bit_depth, all_modes=False):
    """refs [B, 4N+1] substituted unfiltered, modes [B, M] -> [B, M, N, N]
    (``all_modes``: modes is arange(35) on every row)."""
    b, m = modes.shape
    if is_luma:
        filt = dev_table(("filt", n), lambda: _filt_table(n),
                         refs.device)[modes.long()]          # [B, M]
    else:
        filt = torch.zeros_like(modes, dtype=torch.bool)
    outs = []
    for use_f, r in ((False, refs), (True, filter_refs(refs))):
        planar, dc = _planar_dc(r, n)
        ang = _angular(r, None if all_modes else modes, n).reshape(
            b, m, n, n)
        p = torch.where((modes == PLANAR)[..., None, None], planar[:, None],
                        ang)
        p = torch.where((modes == DC)[..., None, None], dc[:, None, None,
                                                          None], p)
        outs.append(p)
    pred = torch.where(filt[..., None, None], outs[1], outs[0])
    if is_luma and n < 32:
        pred = _edge_filters(pred, refs, modes, n, bit_depth)
    return pred.to(torch.int32)


def predict_modes(refs: torch.Tensor, modes: torch.Tensor, n: int,
                  is_luma: bool = True, bit_depth: int = 8) -> torch.Tensor:
    """One chosen mode per block: refs [B, 4N+1], modes [B] -> [B, N, N]."""
    return _predict(refs, modes.reshape(-1, 1), n, is_luma, bit_depth)[:, 0]


def substitute_references(samples: torch.Tensor, avail: torch.Tensor,
                          bit_depth: int = 8) -> torch.Tensor:
    """Batched §8.4.4.2.2 substitution: samples [B, R] int32, avail [B, R]
    bool -> substituted [B, R] (previous-available fill, leading gap from
    the first available sample, mid-grey when none is available)."""
    b, r = samples.shape
    idx = torch.arange(r, device=samples.device, dtype=torch.int64)
    last = torch.cummax(torch.where(avail, idx, -1), dim=1).values
    first = torch.argmax(avail.to(torch.int32), dim=1)
    src = torch.where(last >= 0, last, first[:, None])
    filled = torch.gather(samples, 1, src)
    return torch.where(avail.any(1)[:, None], filled,
                       torch.full_like(filled, 1 << (bit_depth - 1)))


# ---------------------------------------------------------------------------
# numpy reference (spec oracle, per block): the decoder's host recon
# ---------------------------------------------------------------------------
