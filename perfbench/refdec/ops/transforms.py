"""HEVC core transforms (4/8/16/32 DCT, 4x4 DST) — torch twin of
``x265_tpu.ops.transforms``.

The reference evaluates each stage as an exact float32 matmul (``_mm_f32``).
CUDA has no integer matmul, so here each stage is a float64 matmul of
integer operands: every product and partial sum is an integer below 2^53
(|T| <= 90, N <= 32, |x| <= 2^16), so the result is exact in any summation
order, then rounded back to int32 before the normative shifts.
``inverse_transform_np`` is the reference's numpy spec oracle, which the
decoder's host recon runs.
"""

from __future__ import annotations

import functools

import numpy as np

from ._dct_matrix import T32

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


# ---------------------------------------------------------------------------
# numpy reference (spec oracle): the decoder's host recon
# ---------------------------------------------------------------------------

def inverse_transform_np(coef: np.ndarray, bit_depth: int = 8,
                         dst: bool = False) -> np.ndarray:
    """Normative inverse transform (§8.6.4): returns NxN int32 residual."""
    n = coef.shape[-1]
    t = (DST4 if dst else dct_matrix(n)).astype(np.int64)
    shift1 = 7
    shift2 = 20 - bit_depth
    # stage 1 vertical: E = clip16((T^T C + 64) >> 7)
    tmp = (t.T @ coef.astype(np.int64) + (1 << (shift1 - 1))) >> shift1
    tmp = np.clip(tmp, -32768, 32767)
    # stage 2 horizontal: R = clip16((E T + add) >> shift2)
    out = (tmp @ t + (1 << (shift2 - 1))) >> shift2
    return np.clip(out, -32768, 32767).astype(np.int32)
