"""Motion-compensation interpolation (H.265 §8.5.4.2.2): 8-tap luma and
4-tap chroma — torch twin of the batched ``x265_tpu.ops.interp`` paths.

Windows are pre-gathered per block ([B, h+7, w+7] luma with top-left at
integer position (ix-3, iy-3); [B, h+3, w+3] chroma at (ix-1, iy-1)); the
separable filters run as int32 tap sums.
"""

from __future__ import annotations

import numpy as np
import torch

from .._util import dev_table

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


def _two_pass(windows, frac_x, frac_y, w, h, table, name, shift1):
    """Separable filter: horizontal taps >> shift1, then vertical taps
    (no final shift).  Returns the int32 accumulator [B, h, w]."""
    filt = dev_table(name, lambda: table, windows.device)
    fx = filt[frac_x.long()]                       # [B, T]
    fy = filt[frac_y.long()]
    taps = table.shape[1]
    win = windows.to(torch.int32)
    tmp = sum(fx[:, k, None, None] * win[:, :, k:k + w] for k in range(taps))
    tmp = tmp >> shift1
    return sum(fy[:, k, None, None] * tmp[:, k:k + h, :] for k in range(taps))


def mc_luma_batch_ps(windows, frac_x, frac_y, w: int, h: int,
                     bit_depth: int = 8) -> torch.Tensor:
    """Luma MC to the 14-bit domain (h-pass >> bd-8, v-pass >> 6)."""
    return _two_pass(windows, frac_x, frac_y, w, h, LUMA_FILTERS, "lumaf",
                     bit_depth - 8) >> 6


def mc_chroma_batch_ps(windows, frac_x, frac_y, w: int, h: int,
                       bit_depth: int = 8) -> torch.Tensor:
    """Chroma MC to the 14-bit domain from [B, h+3, w+3] windows."""
    return _two_pass(windows, frac_x, frac_y, w, h, CHROMA_FILTERS, "chromaf",
                     bit_depth - 8) >> 6


def uni_round(p: torch.Tensor, bit_depth: int = 8) -> torch.Tensor:
    """Uni-prediction final round of a 14-bit prediction."""
    shift1 = 14 - bit_depth
    return ((p + (1 << (shift1 - 1))) >> shift1).clamp(0, (1 << bit_depth) - 1)


def bi_avg(p0: torch.Tensor, p1: torch.Tensor,
           bit_depth: int = 8) -> torch.Tensor:
    """Default bi-prediction combine of two 14-bit predictions
    (§8.5.3.3.4.2): (p0 + p1 + off2) >> (15 - bd), clipped."""
    shift2 = 15 - bit_depth
    return ((p0 + p1 + (1 << (shift2 - 1))) >> shift2).clamp(
        0, (1 << bit_depth) - 1)


def _pp(acc, bit_depth):
    shift1 = bit_depth - 8
    return ((acc + (1 << (11 - shift1))) >> (12 - shift1)).clamp(
        0, (1 << bit_depth) - 1)


def mc_luma_batch(windows, frac_x, frac_y, w: int, h: int,
                  bit_depth: int = 8) -> torch.Tensor:
    """Pixel-domain luma MC from [B, h+7, w+7] windows, frac in 0..3."""
    if bit_depth != 8:
        return uni_round(mc_luma_batch_ps(windows, frac_x, frac_y, w, h,
                                          bit_depth), bit_depth)
    return _pp(_two_pass(windows, frac_x, frac_y, w, h, LUMA_FILTERS,
                         "lumaf", 0), bit_depth)


def mc_chroma_batch(windows, frac_x, frac_y, w: int, h: int,
                    bit_depth: int = 8) -> torch.Tensor:
    """Pixel-domain chroma MC from [B, h+3, w+3] windows, frac in 0..7."""
    if bit_depth != 8:
        return uni_round(mc_chroma_batch_ps(windows, frac_x, frac_y, w, h,
                                            bit_depth), bit_depth)
    return _pp(_two_pass(windows, frac_x, frac_y, w, h, CHROMA_FILTERS,
                         "chromaf", 0), bit_depth)
