"""HEVC core transforms (4/8/16/32 DCT, 4x4 DST) in plain torch: a frozen
copy of the encoder port's version, for the reference CTU step.  Each
stage is a float64 matmul of integer operands: every product and partial
sum is an integer below 2^53 (|T| <= 90, N <= 32, |x| <= 2^16), so the
result is exact in any summation order, then rounded back to int32 before
the normative shifts."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ._util import dev_table
from ..refdec.ops._dct_matrix import T32

DST4 = np.array([
    [29, 55, 74, 84],
    [74, 74, 0, -74],
    [84, -29, -74, 55],
    [55, -84, 74, -29],
], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """N-point HEVC transform matrix (rows subsample T32)."""
    assert n in (4, 8, 16, 32)
    return np.ascontiguousarray(T32[:: 32 // n, :n])


def _matrix(n: int, dst: bool, device) -> torch.Tensor:
    return dev_table(("tmat", n, dst),
                     lambda: (DST4 if dst else dct_matrix(n)).astype(
                         np.float64), device)


def _rshift_round(x, shift: int):
    return (x + (1 << (shift - 1))) >> shift


def _mm(spec: str, t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """einsum(spec, t, x) exactly (float64 over integer operands)."""
    return torch.einsum(spec, t, x.double()).round().to(torch.int32)


def forward_transform(resi: torch.Tensor, bit_depth: int = 8,
                      dst: bool = False) -> torch.Tensor:
    """Batched forward transform: [B, N, N] int32 -> [B, N, N] int32."""
    n = resi.shape[-1]
    log2n = n.bit_length() - 1
    t = _matrix(n, dst, resi.device)
    shift1 = log2n + bit_depth - 9
    shift2 = log2n + 6
    tmp = _rshift_round(_mm("ki,bji->bkj", t, resi), shift1)
    return _rshift_round(_mm("ki,bji->bkj", t, tmp), shift2)


def inverse_transform(coef: torch.Tensor, bit_depth: int = 8,
                      dst: bool = False) -> torch.Tensor:
    """Batched normative inverse transform: [B, N, N] int32 -> [B, N, N]."""
    n = coef.shape[-1]
    t = _matrix(n, dst, coef.device)
    tmp = _rshift_round(_mm("ki,bkj->bij", t, coef), 7).clamp(-32768, 32767)
    out = _rshift_round(_mm("lj,bil->bij", t, tmp), 20 - bit_depth)
    return out.clamp(-32768, 32767)


# ---------------------------------------------------------------------------
# numpy reference (spec oracle): the decoder's host recon
# ---------------------------------------------------------------------------
