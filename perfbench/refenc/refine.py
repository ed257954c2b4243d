"""A frozen plain copy of the encoder's subpel refine (the step that the
kernel K2 runs on the card), the benchmark's reference for K2's vectors.

Given the search windows, the source blocks, the full-pel winners, the
predicted vectors and the lambdas of one launch, it returns what the
refine returns: each block's quarter-pel offset, its prediction and its
cost, at the subme of the configuration (``settings``).
``low_precision=True`` computes the costs rounded to bfloat16.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ._util import dev_table, fma32
from .cost import satd
from .interp import mc_luma_batch

_DELTAS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
MV_BITS_LEN = 1024
# float32 [1024]: the mvd bits per |d| qpel, 0.718 at 0, else
# 2*log2(|d|+1)+1.718, as the reference evaluates them
_MVB_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "mv_bits_f32.npy")


def _mv_bits_table() -> np.ndarray:
    t = np.load(_MVB_PATH)
    assert t.dtype == np.float32 and t.shape == (MV_BITS_LEN,)
    return t


def _bf16(x):
    return torch.as_tensor(x, dtype=torch.float32).to(
        torch.bfloat16).to(torch.float32)


def refine(W, ob, mvi, pmv, lam, subme: int, mrq: int, bit_depth: int = 8,
           low_precision: bool = False):
    """Subpel ladder over [B, 25, 25] int32 windows W (top-left at the
    full-pel winner - 4), source blocks ob [B, 16, 16], full-pel winners
    mvi [B, 2] (y, x), pmv [B, 2] qpel (y, x), lam float32: a scalar, or
    [B].  Returns (q0 [B, 2] qpel offset (y, x), pred [B, 16, 16], cost
    [B])."""
    n = 16
    lp = _bf16 if low_precision else (lambda x: x)
    big = torch.tensor(float(1 << 30), dtype=torch.float32, device=W.device)
    bits = dev_table("mvbits", _mv_bits_table, W.device)
    lam = lp(lam)

    def mv_cost(mv_q, base):
        d = (mv_q - pmv).abs().long()
        return lp(fma32(lam, lp(lp(bits[d[..., 0]]) + lp(bits[d[..., 1]])),
                        base))

    def refine_round(center, step):
        qs, preds, costs = [], [], []
        for (dy, dx) in _DELTAS:
            q = center + torch.tensor((dy * step, dx * step),
                                      dtype=center.dtype, device=W.device)
            oob = ((mvi * 4 + q).abs() > 4 * mrq).any(1)
            iy1 = (q[:, 0] >> 2) + 1
            ix1 = (q[:, 1] >> 2) + 1
            wr = torch.where(iy1[:, None, None] == 0, W[:, 0:n + 7, :],
                             W[:, 1:n + 8, :])
            win = torch.where(ix1[:, None, None] == 0, wr[:, :, 0:n + 7],
                              wr[:, :, 1:n + 8])
            pred = mc_luma_batch(win, q[:, 1] & 3, q[:, 0] & 3, n, n,
                                 bit_depth)
            c = mv_cost(mvi * 4 + q, lp(satd(ob, pred).to(torch.float32)))
            qs.append(q)
            preds.append(pred)
            costs.append(torch.where(oob, big, c))
        best_c, best_q, best_p = costs[0], qs[0], preds[0]
        for k in range(1, 9):
            better = costs[k] < best_c
            best_c = torch.where(better, costs[k], best_c)
            best_q = torch.where(better[:, None], qs[k], best_q)
            best_p = torch.where(better[:, None, None], preds[k], best_p)
        return best_q, best_p, best_c

    q0 = torch.zeros_like(mvi)
    if subme == 0:
        return refine_round(q0, 0)
    q0, pred, cost = refine_round(q0, 2)
    if subme >= 2:
        q0, pred, cost = refine_round(q0, 1)
    return q0, pred, cost
