"""Motion-compensation interpolation (H.265 §8.5.4.2.2), luma 8-tap, in
plain torch: a frozen copy of the encoder port's batched paths, for the
reference refine.  Windows are pre-gathered per block ([B, h+7, w+7] with
top-left at integer position (ix-3, iy-3)); the separable filters run as
int32 tap sums."""

from __future__ import annotations

import numpy as np
import torch

from ._util import dev_table

# Table 8-11: luma 8-tap filters per quarter-pel phase
LUMA_FILTERS = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
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


def uni_round(p: torch.Tensor, bit_depth: int = 8) -> torch.Tensor:
    """Uni-prediction final round of a 14-bit prediction."""
    shift1 = 14 - bit_depth
    return ((p + (1 << (shift1 - 1))) >> shift1).clamp(0, (1 << bit_depth) - 1)


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


# ---------------------------------------------------------------------------
# numpy reference (per block): the decoder's host MC
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# ps-domain (14-bit intermediate) variants for bi-prediction
# ---------------------------------------------------------------------------
# Spec §8.5.4.2.2: fractional interpolation keeps a 14-bit intermediate
# (shift1 = BitDepth-8 after the horizontal pass, shift2 = 6 after the
# vertical, integer positions << shift3 = 14-BitDepth); §8.5.3.3.3.2
# then combines: uni (pred + off1) >> (14-bd), bi (p0 + p1 + off2) >>
# (15-bd).  Reference embodiment: ipfilter.cpp interp_*_ps/sp/ss chains.
