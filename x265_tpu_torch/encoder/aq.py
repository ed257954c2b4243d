"""Adaptive quantization: per-block energy -> QP offsets.

Port of x265's calcAdaptiveQuantFrame (x265_1.9/source/encoder/
slicetype.cpp:95-228) and acEnergyCu (:48-93): per-16x16-block AC energy
(luma 16x16 variance + chroma 8x8 variances), mapped to QP offsets by
aq-mode:

  1 (AQ_VARIANCE):       strength*1.0397 * (log2(energy) - 14.427)
  2 (AQ_AUTO_VARIANCE):  s*( (E+1)^0.1 - avg' ), s = strength * avg,
                         avg' = avg - (avg2 - 11)/(2*avg)
  3 (AQ_AUTO_VARIANCE_BIASED): mode 2 + strength * (1 - 11/x^2) dark bias

Offsets are averaged per CTB (our QG granularity, diff_cu_qp_delta_depth
0 — the role of x265's calculateQpforCuSize averaging in analysis.cpp).
All numpy; runs per frame on host (cheap: one pass over the planes).
"""

from __future__ import annotations

import numpy as np


def block_energy(planes, bit_depth: int = 8) -> np.ndarray:
    """[gh, gw] AC energy per 16x16 luma block (acEnergyCu semantics:
    var(luma 16x16) + var(cb 8x8) + var(cr 8x8), var = ssd - mean*sum)."""
    def var_blocks(p, n, shift):
        h, w = p.shape
        gh, gw = h // n, w // n
        b = p[:gh * n, :gw * n].astype(np.uint64)
        b = b.reshape(gh, n, gw, n)
        s = b.sum(axis=(1, 3))
        ss = (b * b).sum(axis=(1, 3))
        return (ss - ((s * s) >> shift)).astype(np.int64)

    vy = var_blocks(planes[0], 16, 8)
    vcb = var_blocks(planes[1], 8, 6)
    vcr = var_blocks(planes[2], 8, 6)
    gh = min(vy.shape[0], vcb.shape[0])
    gw = min(vy.shape[1], vcb.shape[1])
    return (vy[:gh, :gw] + vcb[:gh, :gw] + vcr[:gh, :gw]).astype(np.float64)


def aq_offsets(planes, aq_mode: int, strength: float,
               bit_depth: int = 8, normalize: bool = False) -> np.ndarray:
    """Per-16x16-block QP offsets [gh, gw] float (qpAqOffset analogue).

    ``normalize`` recenters the offsets to zero mean — for CQP, where
    no rate control absorbs a global QP shift (the x265 formulas'
    constants leave a content-dependent mean offset, measured ~-1 QP
    on typical clips: pure bit spending rather than redistribution).
    CRF/ABR keep the raw offsets; their feedback loops compensate."""
    energy = block_energy(planes, bit_depth)
    if aq_mode >= 2:
        bdc = 1.0 / (1 << (2 * (bit_depth - 8)))
        raw = np.power(energy * bdc + 1.0, 0.1)
        avg = raw.mean()
        avg2 = (raw * raw).mean()
        s = strength * avg
        avg_b = avg - 0.5 * (avg2 - 11.0) / avg
        off = s * (raw - avg_b)
        if aq_mode == 3:
            off = off + strength * (1.0 - 11.0 / (raw * raw))
    else:
        # mode 1: variance AQ
        s = strength * 1.0397
        off = s * (np.log2(np.maximum(energy, 1.0))
                   - (14.427 + 2 * (bit_depth - 8)))
    if normalize:
        off = off - off.mean()
    return off


def per_ctb_qp(offsets16: np.ndarray, base_qp: int, geom) -> np.ndarray:
    """Average the per-16x16 offsets over each CTB and return clipped
    per-CTB base QPs [nctb] int32 (QG == CTB)."""
    n16 = 1 << (geom.log2_ctb - 4)      # 16x16 blocks per CTB side
    gh, gw = offsets16.shape
    out = np.zeros((geom.ctbs_h, geom.ctbs_w), np.float64)
    cnt = np.zeros_like(out)
    # accumulate into the covering CTB (the offset grid covers the coded
    # picture; partial CTBs average over their in-picture blocks)
    ys = np.arange(gh) // n16
    xs = np.arange(gw) // n16
    np.add.at(out, (ys[:, None].repeat(gw, 1), xs[None, :].repeat(gh, 0)),
              offsets16)
    np.add.at(cnt, (ys[:, None].repeat(gw, 1), xs[None, :].repeat(gh, 0)),
              1.0)
    avg = out / np.maximum(cnt, 1.0)
    qp = np.rint(base_qp + avg).astype(np.int32)
    return np.clip(qp, 0, 51).reshape(-1)
