"""Intra prediction: all 35 HEVC modes — torch twin of
``x265_tpu.ops.intra``.

The reference evaluates the 35 modes as one matmul against a weight tensor
``[35, N*N, 4N+1]``.  Here each mode is computed by the spec formulas of
``predict_intra_np`` (§8.4.4.2.4-6): planar and DC in closed form, the
angular modes as a two-tap gather from the canonical reference vector
with per-(mode, pixel) tap tables.  Canonical reference layout (length
4N+1): reversed left column (below-left .. left), corner at 2N, then the
top row (top .. above-right).  The per-block numpy versions
(``predict_intra_np``, ``filter_reference_np``,
``substitute_references_np``) are the reference's spec oracle, which the
decoder's host recon runs.
"""

from __future__ import annotations


import numpy as np


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


# ---------------------------------------------------------------------------
# numpy reference (spec oracle, per block): the decoder's host recon
# ---------------------------------------------------------------------------

def angle_of(mode: int) -> int:
    return int(ANGLES[mode - 2])


def filter_reference_np(ref: np.ndarray) -> np.ndarray:
    """[1 2 1]/4 smoothing along the canonical vector, endpoints kept."""
    out = ref.copy()
    out[1:-1] = (ref[:-2] + 2 * ref[1:-1] + ref[2:] + 2) >> 2
    return out


def substitute_references_np(samples: np.ndarray, avail: np.ndarray,
                             bit_depth: int = 8) -> np.ndarray:
    """§8.4.4.2.2 reference sample substitution.

    samples/avail: [4N+1] values and per-sample availability flags.
    """
    out = samples.astype(np.int32).copy()
    if not avail.any():
        out[:] = 1 << (bit_depth - 1)
        return out
    first = int(np.argmax(avail))
    if not avail[0]:
        out[:first] = out[first]
    for i in range(first + 1, len(out)):
        if not avail[i]:
            out[i] = out[i - 1]
    return out


def predict_intra_np(mode: int, ref: np.ndarray, n: int, *,
                     is_luma: bool = True, bit_depth: int = 8,
                     already_filtered: bool = False) -> np.ndarray:
    """Predict one NxN block from an (unfiltered) canonical ref vector."""
    if filter_flag(mode, n, is_luma) and not already_filtered:
        r = filter_reference_np(ref)
    else:
        r = ref
    left = np.array([r[ref_index(n, "left", i)] for i in range(2 * n)])
    top = np.array([r[ref_index(n, "top", i)] for i in range(2 * n)])
    corner = int(r[ref_index(n, "corner")])
    pred = np.zeros((n, n), dtype=np.int32)
    log2n = n.bit_length() - 1
    maxval = (1 << bit_depth) - 1

    if mode == PLANAR:
        for y in range(n):
            for x in range(n):
                pred[y, x] = ((n - 1 - x) * left[y] + (x + 1) * top[n]
                              + (n - 1 - y) * top[x] + (y + 1) * left[n]
                              + n) >> (log2n + 1)
        return pred

    if mode == DC:
        dc = (int(top[:n].sum()) + int(left[:n].sum()) + n) >> (log2n + 1)
        pred[:, :] = dc
        if is_luma and n < 32:
            pred[0, 0] = (left[0] + 2 * dc + top[0] + 2) >> 2
            for x in range(1, n):
                pred[0, x] = (top[x] + 3 * dc + 2) >> 2
            for y in range(1, n):
                pred[y, 0] = (left[y] + 3 * dc + 2) >> 2
        return pred

    a = angle_of(mode)
    vertical = mode >= 18
    main = top if vertical else left
    side = left if vertical else top
    # build extended main reference, 1-indexed at offset n (M[i] at em[n+i])
    em = np.zeros(4 * n + 2, dtype=np.int32)
    em[n] = corner                       # M[0]
    em[n + 1: n + 1 + 2 * n] = main[:2 * n]
    if a < 0:
        inv = INV_ANGLES[a]
        lo = (n * a) >> 5                # indices lo+1 .. -1 get projected
        for k in range(-1, lo, -1):
            idx = ((k * inv + 128) >> 8) - 1
            em[n + k] = side[idx] if idx >= 0 else corner
    for q in range(n):                   # q = y (vertical) or x (horizontal)
        pos = (q + 1) * a
        idx = pos >> 5
        fact = pos & 31
        for p in range(n):               # p = x (vertical) or y (horizontal)
            s0 = em[n + p + idx + 1]
            s1 = em[n + p + idx + 2]
            v = (s0 * (32 - fact) + s1 * fact + 16) >> 5
            if vertical:
                pred[q, p] = v
            else:
                pred[p, q] = v
    if is_luma and n < 32:
        if mode == VER:
            for y in range(n):
                pred[y, 0] = np.clip(top[0] + ((left[y] - corner) >> 1),
                                     0, maxval)
        elif mode == HOR:
            for x in range(n):
                pred[0, x] = np.clip(left[0] + ((top[x] - corner) >> 1),
                                     0, maxval)
    return pred
