"""HEVC residual syntax, decode direction: the coefficient scans,
last-position and coeff_abs_level_remaining decoding and residual_coding
(ITU-T H.265 §7.3.8.11, §9.3.3, §9.3.4.2) — the decoder side of
``x265_tpu/cabac/syntax.py``, copied line for line.

Conventions: coefficient blocks are numpy [y][x] int arrays; scan tables
list (x, y) positions from DC outward; syntax processes them in reverse.
"""

from __future__ import annotations

import functools

import numpy as np

from .engine import CabacDecoder
from .tables import CTX_OFFSET

SCAN_DIAG, SCAN_HORIZ, SCAN_VERT = 0, 1, 2

# §9.3.4.2.5: sig_coeff_flag context map for 4x4 TBs, indexed (yC<<2)+xC
CTX_IDX_MAP_4x4 = np.array(
    [0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8], dtype=np.int32)

# §9.3.3.2 last-position binarization helpers
MIN_IN_GROUP = np.array([0, 1, 2, 3, 4, 6, 8, 12, 16, 24], dtype=np.int32)
GROUP_IDX = np.array([0, 1, 2, 3, 4, 4, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7,
                      8, 8, 8, 8, 8, 8, 8, 8, 9, 9, 9, 9, 9, 9, 9, 9],
                     dtype=np.int32)


@functools.lru_cache(maxsize=None)
def scan_order(size: int, scan_idx: int) -> np.ndarray:
    """[(x, y)] positions in scan order from DC outward (§6.5.3/6.5.4)."""
    pos = []
    if scan_idx == SCAN_DIAG:
        for s in range(2 * size - 1):
            for x in range(s + 1):
                y = s - x
                if x < size and y < size:
                    pos.append((x, y))
    elif scan_idx == SCAN_HORIZ:
        for y in range(size):
            for x in range(size):
                pos.append((x, y))
    else:
        for x in range(size):
            for y in range(size):
                pos.append((x, y))
    return np.array(pos, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def tb_scan(size: int, scan_idx: int) -> np.ndarray:
    """Full-TB coefficient scan: hierarchical — 4x4 subblocks in scan order,
    then the 4x4 scan within each subblock (§6.5.3 note / 7.3.8.11).
    For size 4 this equals scan_order(4, scan_idx)."""
    if size == 4:
        return scan_order(4, scan_idx)
    sb = scan_order(size // 4, scan_idx)
    inner = scan_order(4, scan_idx)
    pos = []
    for xs, ys in sb:
        for xc, yc in inner:
            pos.append((xs * 4 + xc, ys * 4 + yc))
    return np.array(pos, dtype=np.int32)


def scan_for_intra(log2_size: int, c_idx: int, intra_mode: int) -> int:
    """§7.4.9.11 mode-dependent coefficient scan selection."""
    if log2_size == 2 or (log2_size == 3 and c_idx == 0):
        if 6 <= intra_mode <= 14:
            return SCAN_VERT
        if 22 <= intra_mode <= 30:
            return SCAN_HORIZ
    return SCAN_DIAG


def _last_ctx_params(log2_size: int, c_idx: int) -> tuple[int, int]:
    if c_idx == 0:
        offset = 3 * (log2_size - 2) + ((log2_size - 1) >> 2)
        shift = (log2_size + 1) >> 2
    else:
        offset = 15
        shift = log2_size - 2
    return offset, shift


def _sig_ctx(x: int, y: int, log2_size: int, c_idx: int, scan_idx: int,
             csbf_right: int, csbf_below: int) -> int:
    """§9.3.4.2.5 context index (0-based into the 42-entry SIG_COEFF set)."""
    if log2_size == 2:
        sig = int(CTX_IDX_MAP_4x4[(y << 2) + x])
    elif x + y == 0:
        sig = 0
    else:
        prev = csbf_right + 2 * csbf_below
        xp, yp = x & 3, y & 3
        if prev == 0:
            sig = 2 if xp + yp == 0 else (1 if xp + yp < 3 else 0)
        elif prev == 1:
            sig = 2 if yp == 0 else (1 if yp == 1 else 0)
        elif prev == 2:
            sig = 2 if xp == 0 else (1 if xp == 1 else 0)
        else:
            sig = 2
        if c_idx == 0:
            if (x >> 2) + (y >> 2) > 0:
                sig += 3
            sig += (9 if scan_idx == SCAN_DIAG else 15) if log2_size == 3 else 21
        else:
            sig += 9 if log2_size == 3 else 12
    return sig if c_idx == 0 else 27 + sig


# ---------------------------------------------------------------------------
# last significant coefficient position
# ---------------------------------------------------------------------------

def _decode_last_xy(dec: CabacDecoder, log2_size: int,
                    c_idx: int) -> tuple[int, int]:
    offset, shift = _last_ctx_params(log2_size, c_idx)
    cmax = (log2_size << 1) - 1
    bx = CTX_OFFSET["LAST_X_PREFIX"]
    by = CTX_OFFSET["LAST_Y_PREFIX"]

    def prefix(base):
        p = 0
        while p < cmax and dec.decode_bin(base + offset + (p >> shift)):
            p += 1
        return p

    gx = prefix(bx)
    gy = prefix(by)
    last_x, last_y = gx, gy
    if gx > 3:
        last_x = int(MIN_IN_GROUP[gx]) + dec.decode_bypass_bins((gx >> 1) - 1)
    if gy > 3:
        last_y = int(MIN_IN_GROUP[gy]) + dec.decode_bypass_bins((gy >> 1) - 1)
    return last_x, last_y


# ---------------------------------------------------------------------------
# coeff_abs_level_remaining (§9.3.3.9)
# ---------------------------------------------------------------------------

def _decode_remaining(dec: CabacDecoder, rice: int) -> int:
    prefix = 0
    while dec.decode_bypass():
        prefix += 1
        assert prefix < 32, "corrupt coeff_abs_level_remaining"
    if prefix <= 3:
        return (prefix << rice) + (dec.decode_bypass_bins(rice) if rice else 0)
    m = prefix - 3
    return (((1 << m) + 2) << rice) + dec.decode_bypass_bins(m + rice)


# ---------------------------------------------------------------------------
# residual_coding (§7.3.8.11)
# ---------------------------------------------------------------------------

def decode_residual(dec: CabacDecoder, log2_size: int, c_idx: int,
                    scan_idx: int, *, sign_hiding: bool = False) -> np.ndarray:
    size = 1 << log2_size
    n_groups_dim = max(1, size >> 2)
    sb_scan = scan_order(n_groups_dim, scan_idx)
    coef_scan = scan_order(4, scan_idx)
    coeffs = np.zeros((size, size), dtype=np.int32)

    lx, ly = _decode_last_xy(dec, log2_size, c_idx)
    if scan_idx == SCAN_VERT:
        lx, ly = ly, lx
    full_scan = tb_scan(size, scan_idx)
    last_scan_idx = next(i for i, (x, y) in enumerate(full_scan)
                         if x == lx and y == ly)
    last_sb = last_scan_idx >> 4
    last_pos_in_sb = last_scan_idx & 15

    csbf = np.zeros((n_groups_dim, n_groups_dim), dtype=np.int32)
    sig_base = CTX_OFFSET["SIG_COEFF"]
    csb_base = CTX_OFFSET["CODED_SUB_BLOCK"]
    g1_base = CTX_OFFSET["GREATER1"]
    g2_base = CTX_OFFSET["GREATER2"]

    prev_c1 = 1
    for i in range(last_sb, -1, -1):
        xs, ys = (int(v) for v in sb_scan[i])
        infer_dc_sig = 0
        csbf_right = int(csbf[ys, xs + 1]) if xs + 1 < n_groups_dim else 0
        csbf_below = int(csbf[ys + 1, xs]) if ys + 1 < n_groups_dim else 0
        if i < last_sb and i > 0:
            ctx = csb_base + (2 if c_idx else 0) + (1 if (csbf_right or csbf_below) else 0)
            csbf[ys, xs] = dec.decode_bin(ctx)
            infer_dc_sig = 1
        else:
            csbf[ys, xs] = 1
        if not csbf[ys, xs]:
            continue

        sig_pos = []
        if i == last_sb:
            sig_pos.append(last_pos_in_sb)
        start = last_pos_in_sb - 1 if i == last_sb else 15
        for n in range(start, -1, -1):
            xc = xs * 4 + int(coef_scan[n][0])
            yc = ys * 4 + int(coef_scan[n][1])
            if n > 0 or not infer_dc_sig:
                ctx = sig_base + _sig_ctx(xc, yc, log2_size, c_idx, scan_idx,
                                          csbf_right, csbf_below)
                sig = dec.decode_bin(ctx)
                if sig:
                    infer_dc_sig = 0
            else:
                sig = 1
            if sig:
                sig_pos.append(n)

        num_sig = len(sig_pos)
        if num_sig == 0:
            continue  # inferred-csbf group that is actually empty
        ctx_set = 2 if (i > 0 and c_idx == 0) else 0
        if prev_c1 == 0:
            ctx_set += 1
        c1 = 1
        g1_flags = []
        first_g2 = -1
        for k in range(min(8, num_sig)):
            ctx = g1_base + (16 if c_idx else 0) + ctx_set * 4 + c1
            g1 = dec.decode_bin(ctx)
            g1_flags.append(g1)
            if g1:
                c1 = 0
                if first_g2 < 0:
                    first_g2 = k
            elif 0 < c1 < 3:
                c1 += 1
        g2 = 0
        if first_g2 >= 0:
            g2 = dec.decode_bin(g2_base + (4 if c_idx else 0) + ctx_set)
        prev_c1 = c1

        first_sig_scan = sig_pos[-1]
        last_sig_scan = sig_pos[0]
        hidden = sign_hiding and (last_sig_scan - first_sig_scan > 3)
        signs = []
        for k in range(num_sig):
            if hidden and k == num_sig - 1:
                signs.append(None)
            else:
                signs.append(dec.decode_bypass())

        rice = 0
        total = 0
        for k in range(num_sig):
            if k < 8:
                base = 2 + (1 if k == first_g2 else 0)
                known = 1 + g1_flags[k] + (g2 if k == first_g2 else 0)
                needs_rem = (g1_flags[k] == 1) and \
                    (k != first_g2 or g2 == 1)
            else:
                known = 1
                needs_rem = True
                base = 1
            al = known
            if needs_rem:
                al = base + _decode_remaining(dec, rice)
                if al > (3 << rice) and rice < 4:
                    rice += 1
            n = sig_pos[k]
            xc = xs * 4 + int(coef_scan[n][0])
            yc = ys * 4 + int(coef_scan[n][1])
            if signs[k] is None:
                coeffs[yc, xc] = al  # hidden sign resolved below via parity
            else:
                coeffs[yc, xc] = -al if signs[k] else al
            total += al
        if hidden:
            n = sig_pos[-1]
            xc = xs * 4 + int(coef_scan[n][0])
            yc = ys * 4 + int(coef_scan[n][1])
            if total & 1:
                coeffs[yc, xc] = -coeffs[yc, xc]
    return coeffs
