"""Dequantization (H.265 §8.6.3, flat scaling lists): the numpy spec
oracle of the encoder port's ``ops/quantize.py``, which the decoder's host
recon runs."""

from __future__ import annotations

import numpy as np

INV_QUANT_SCALES = np.array([40, 45, 51, 57, 64, 72], dtype=np.int32)


def dequant_np(level: np.ndarray, qp: int, bit_depth: int = 8) -> np.ndarray:
    """Normative §8.6.3 with flat scaling list (m=16)."""
    n = level.shape[-1]
    log2n = n.bit_length() - 1
    bd_shift = bit_depth + log2n - 5
    scale = (int(INV_QUANT_SCALES[qp % 6]) * 16) << (qp // 6)
    d = (level.astype(np.int64) * scale + (1 << (bd_shift - 1))) >> bd_shift
    return np.clip(d, -32768, 32767).astype(np.int32)
