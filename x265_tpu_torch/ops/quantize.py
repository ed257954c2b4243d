"""Quantization / dequantization (H.265 §8.6.3) and sign-data hiding —
torch twin of ``x265_tpu.ops.quantize`` (flat scaling lists, int32 math
split exactly as the reference splits it)."""

from __future__ import annotations

import numpy as np
import torch

from .._util import dev_table

INV_QUANT_SCALES = np.array([40, 45, 51, 57, 64, 72], dtype=np.int32)
QUANT_SCALES = np.array([26214, 23302, 20560, 18396, 16384, 14564],
                        dtype=np.int32)
QUANT_SHIFT = 14


def _diag4_rank() -> np.ndarray:
    """rank[y, x] = position of (x, y) in the 4x4 up-right diagonal scan."""
    rank = np.zeros((4, 4), np.int32)
    i = 0
    for s in range(7):
        for x in range(s + 1):
            y = s - x
            if x < 4 and y < 4:
                rank[y, x] = i
                i += 1
    return rank


DIAG4_RANK = _diag4_rank()


def _per_block(v, qp):
    return v[:, None, None] if qp.ndim else v


def quant_masked(coef: torch.Tensor, qp, intra_mask: torch.Tensor,
                 bit_depth: int = 8) -> torch.Tensor:
    """[B, N, N] int32 coefficients -> levels; qp scalar or [B];
    intra_mask [B] bool selects the rounding offset (171 intra, 85 inter)."""
    n = coef.shape[-1]
    log2n = n.bit_length() - 1
    dev = coef.device
    qp = torch.as_tensor(qp, dtype=torch.int32, device=dev)
    qbits = QUANT_SHIFT + qp // 6 + (15 - bit_depth - log2n)
    scale = dev_table("qs", lambda: QUANT_SCALES, dev)[qp % 6]
    scale, qbits = _per_block(scale, qp), _per_block(qbits, qp)
    offset_num = torch.where(intra_mask, 171, 85).to(torch.int32)[:, None,
                                                                  None]
    absc = coef.abs()
    hi = absc * (scale >> 7)
    lo = absc * (scale & 127)
    offset = offset_num << (qbits - 9)
    level = ((hi + ((lo + offset) >> 7)) >> (qbits - 7)).clamp(0, 32767)
    return torch.sign(coef) * level


def quant(coef: torch.Tensor, qp, bit_depth: int = 8,
          intra: bool = True) -> torch.Tensor:
    """Like ``quant_masked`` with one offset for the whole batch."""
    mask = torch.full((coef.shape[0],), intra, dtype=torch.bool,
                      device=coef.device)
    return quant_masked(coef, qp, mask, bit_depth)


def dequant(level: torch.Tensor, qp, bit_depth: int = 8) -> torch.Tensor:
    """Normative dequant, batched.  [B, N, N] levels, qp scalar or [B]."""
    n = level.shape[-1]
    log2n = n.bit_length() - 1
    dev = level.device
    qp = torch.as_tensor(qp, dtype=torch.int32, device=dev)
    bd_shift = bit_depth + log2n - 5
    scale16 = dev_table("iqs", lambda: INV_QUANT_SCALES, dev)[qp % 6] * 16
    scale16, per = _per_block(scale16, qp), _per_block(qp // 6, qp)
    scale_eff = scale16 << per
    # pre-clamp as the reference does (int32-safe, identical after clip)
    lmax = (32767 << bd_shift) // scale_eff + 1
    lvl = torch.maximum(torch.minimum(level, lmax), -lmax)
    d = (lvl * scale_eff + (1 << (bd_shift - 1))) >> bd_shift
    return d.clamp(-32768, 32767)


def sign_hide_diag(levels: torch.Tensor) -> torch.Tensor:
    """Sign-hiding parity fix for diagonal-scan TBs: levels [B, n, n]."""
    b, n, _ = levels.shape
    s = n // 4
    rank = dev_table("rank4", lambda: DIAG4_RANK, levels.device)
    sb = levels.reshape(b, s, 4, s, 4).permute(0, 1, 3, 2, 4)
    nz = sb != 0
    ranks = torch.where(nz, rank, 99)
    first = ranks.amin(dim=(-2, -1))
    last = torch.where(nz, rank, -1).amax(dim=(-2, -1))
    hide = (last - first) > 3
    first_mask = (rank == first[..., None, None]) & nz
    val = torch.where(first_mask, sb, 0).sum(dim=(-2, -1))
    odd = (sb.abs().sum(dim=(-2, -1)) & 1) == 1
    mismatch = hide & (odd != (val < 0))
    bump = torch.where(val > 0, 1, -1)
    sb = torch.where(first_mask & mismatch[..., None, None],
                     sb + bump[..., None, None], sb)
    return sb.permute(0, 1, 3, 2, 4).reshape(b, n, n).to(levels.dtype)
