"""SSIM metric — x265's ssim kernel family, batched: a copy of
``x265_tpu/ops/ssim.py``'s numpy half, and ``ssim_plane``, the torch twin
of its ``ssim_plane_jnp``.

4x4 integer block moments are combined into overlapping 8x8 windows at
stride 4, with the x264-lineage constants c1 = (.01*max)^2*64 and
c2 = (.03*max)^2*64*63.  The metric is a reporting path (the CLI's
``--ssim``), not in the RD loop.
"""

from __future__ import annotations

import numpy as np
import torch


def _block_moments_np(a, b):
    """4x4 block sums: s1=Σa, s2=Σb, ss=Σa²+Σb², s12=Σab (int64)."""
    h4, w4 = a.shape[0] // 4, a.shape[1] // 4
    a = a[:h4 * 4, :w4 * 4].astype(np.int64)
    b = b[:h4 * 4, :w4 * 4].astype(np.int64)

    def bsum(x):
        return x.reshape(h4, 4, w4, 4).sum(axis=(1, 3))

    return bsum(a), bsum(b), bsum(a * a + b * b), bsum(a * b)


def _ssim_end_np(s1, s2, ss, s12, bit_depth):
    """Combine 2x2 neighborhoods of 4x4 moments (= overlapping 8x8
    windows at stride 4) exactly as x265's ssim_end_4."""
    maxv = (1 << bit_depth) - 1
    c1 = (0.01 * maxv) ** 2 * 64
    c2 = (0.03 * maxv) ** 2 * 64 * 63

    def win(x):
        return (x[:-1, :-1] + x[:-1, 1:] + x[1:, :-1] + x[1:, 1:]) \
            .astype(np.float64)

    f1, f2, fss, f12 = win(s1), win(s2), win(ss), win(s12)
    vars_ = fss * 64 - f1 * f1 - f2 * f2
    covar = f12 * 64 - f1 * f2
    num = (2 * f1 * f2 + c1) * (2 * covar + c2)
    den = (f1 * f1 + f2 * f2 + c1) * (vars_ + c2)
    return num / den


def ssim_plane_np(a: np.ndarray, b: np.ndarray,
                  bit_depth: int = 8) -> float:
    """Mean SSIM of plane ``b`` (recon) vs ``a`` (source)."""
    s1, s2, ss, s12 = _block_moments_np(a, b)
    m = _ssim_end_np(s1, s2, ss, s12, bit_depth)
    return float(m.mean()) if m.size else 1.0


def ssim_plane(a: torch.Tensor, b: torch.Tensor,
               bit_depth: int = 8) -> torch.Tensor:
    """Device variant: [H, W] planes -> scalar mean SSIM (float32), in
    ``ssim_plane_jnp``'s operation order."""
    h4, w4 = a.shape[0] // 4, a.shape[1] // 4
    af = a[:h4 * 4, :w4 * 4].to(torch.float32)
    bf = b[:h4 * 4, :w4 * 4].to(torch.float32)

    def bsum(x):
        return x.reshape(h4, 4, w4, 4).sum(dim=(1, 3))

    s1, s2 = bsum(af), bsum(bf)
    ss = bsum(af * af + bf * bf)
    s12 = bsum(af * bf)

    def win(x):
        return x[:-1, :-1] + x[:-1, 1:] + x[1:, :-1] + x[1:, 1:]

    maxv = (1 << bit_depth) - 1
    c1 = (0.01 * maxv) ** 2 * 64
    c2 = (0.03 * maxv) ** 2 * 64 * 63
    f1, f2, fss, f12 = win(s1), win(s2), win(ss), win(s12)
    vars_ = fss * 64 - f1 * f1 - f2 * f2
    covar = f12 * 64 - f1 * f2
    m = ((2 * f1 * f2 + c1) * (2 * covar + c2)
         / ((f1 * f1 + f2 * f2 + c1) * (vars_ + c2)))
    return torch.mean(m)


def ssim_db(ssim: float) -> float:
    """x265's SSIM-in-dB convention (printSummary): -10*log10(1-ssim)."""
    return float(-10.0 * np.log10(max(1.0 - ssim, 1e-10)))
