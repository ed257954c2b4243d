"""Residual-bits model for the in-scan RD compares — torch twin of
``x265_tpu.common.rdcost.level_bits_jnp`` (integer-exact)."""

from __future__ import annotations

import torch


def level_bits(levels: torch.Tensor) -> torch.Tensor:
    """[L, n, n] levels -> [L] float32 estimated residual_coding bits:
    per nonzero coefficient 2*floor(log2|l|) + 3, plus 2 per coded 4x4
    group (the MSB index by threshold counting, as the reference)."""
    a = levels.abs()
    msb = sum((a >= (1 << k)).to(torch.int32) for k in range(1, 16))
    mag = torch.where(a > 0, 2 * msb + 3, 0)
    bits = mag.sum(dim=(-1, -2), dtype=torch.int32)
    L, n, _ = levels.shape
    g = n // 4
    grp_nz = (levels.reshape(L, g, 4, g, 4) != 0).any(4).any(2)
    bits = bits + 2 * grp_nz.sum(dim=(-1, -2), dtype=torch.int32)
    return bits.to(torch.float32)
