"""K2: subpel motion refinement as one hand-written CUDA kernel.

Replaces ``x265_tpu/encoder/me_pallas.py`` (``make_refine_kernel``: body
``kernel`` at :112, ``pallas_call`` at :237).  Source:
``x265_tpu_torch/csrc/k2_subpel_refine.cu``; plain version: ``refine_plain``
below, the torch twin of ``refine_round`` and its --subme ladder
(``x265_tpu/encoder/device_pipeline.py:729-789``), which the wrapper runs
for tensors on the CPU.

What it computes: for each 16x16 block, from the 25x25 integer window
around its full-pel winner, a half-pel round (step 2) then a quarter-pel
round (step 1) of 9 candidates each (``_DELTAS`` order, first wins ties
under strict ``<``); per candidate the exact 8-tap separable luma MC
(8-bit: +2048 >> 12, clip; 10-bit: the horizontal pass >> 2, the vertical
>> 6, then ``uni_round``'s +8 >> 4 and clip to 1023), the 4x4-Hadamard
SATD, plus
lam * (mv_bits(dy) + mv_bits(dx)) against the seed-median pmv, with
candidates beyond 4*merange qpel masked to 2^30.

Design (v2; the ``.cu`` header has the details).  One 160-thread block
per 16x16 block, 5 block barriers at subme 2.  The window, the source
block and the 14 mv_bits entries a block can read are staged by 4-byte
cp.async; the horizontal pass runs once per block for every phase the
block needs (dp4a of 8-bit samples; at 10 bits dp2a on int16 sample
pairs, the template instantiation ``k2_kernel<10>``); round 1 fills the
full-pel, H, V and HV planes its 9 candidates share (dp2a on int16 row
pairs) and reads each candidate from them; round 2 filters its 8 new candidates' samples
and reuses the round-1 winner as its center.  One half-warp per
candidate sums the SATD of its sixteen 4x4 Hadamards by shuffles; the
argmin is a warp reduction of (cost, k), the lower k winning equal costs.
Bound on an H100: its operations (``chip_smoke.k2_bound``: ~21 us a
launch at B = 8160, ~22 us at 10 bits, the bytes ~11 us).  Measured on an
H100 80GB HBM3 at 700 W (``chip_smoke.py``): ~0.07 ms a launch at B =
8160, subme 2, merange 57 (~0.076 ms at 10 bits), against v1's 0.34 ms
and ~25-50 ms for ``refine_plain``; ``tools/profile_k2_stages.py`` shows
where a block's cycles go.
Costs round as the reference: ``__fmaf_rn(lam, bits, satd)``, mv_bits from
the committed float32 table (no device log2).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from .._util import dev_table, fma32, on_device
from ..build import load_library
from ..ops.cost import satd
from ..ops.interp import mc_luma_batch

#: launches of K2 made by ``refine`` (counted once per kernel launch), and
#: of those the launches of its 10-bit path; ``LAUNCHES_BLOCKS`` sums the
#: blocks of each launch; bumped under ``_COUNT_LOCK`` (threads driving
#: several devices launch side by side)
LAUNCHES = 0
LAUNCHES_10BIT = 0
LAUNCHES_BLOCKS = 0
_COUNT_LOCK = threading.Lock()

_DELTAS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
MV_BITS_LEN = 1024
_MVB_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "mv_bits_f32.npy")


def mv_bits_table() -> np.ndarray:
    """float32 [1024]: the reference's EG1-style mvd bits per |d| qpel —
    0.718 at 0, else 2*log2(|d|+1)+1.718 — as XLA:CPU evaluates them
    (committed data; ``tools/make_mv_bits_table.py`` regenerates it)."""
    t = np.load(_MVB_PATH)
    assert t.dtype == np.float32 and t.shape == (MV_BITS_LEN,)
    return t


def mv_bits(d: torch.Tensor) -> torch.Tensor:
    """Table lookup of the mvd bits of qpel components ``d`` (|d| <=
    2 * 4 * 64 + 3 by the search's clamps; checked without a host sync)."""
    a = d.abs()
    torch._assert_async(a.max() < MV_BITS_LEN,
                        "mvd component beyond the mv_bits table")
    return dev_table("mvbits", mv_bits_table, d.device)[a.long()]


def mv_cost(lam, mv_q, pmv_b, base):
    """base + lam * (bits(dy) + bits(dx)) with one rounding (fused)."""
    d = mv_q - pmv_b
    return fma32(lam, mv_bits(d[..., 0]) + mv_bits(d[..., 1]), base)


def refine_plain(W, ob, mvi, pmv, lam, subme: int, mrq: int,
                 bit_depth: int = 8):
    """Subpel ladder over [B, 25, 25] int32 windows W (top-left at the
    full-pel winner - 4), source blocks ob [B, 16, 16], full-pel winners
    mvi [B, 2] (y, x), pmv [B, 2] qpel (y, x), lam float32: a scalar, or
    [B], each block's own (the blocks of several frames in one call).
    Returns (q0 [B, 2] qpel offset (y, x), pred [B, 16, 16], cost [B])."""
    n = 16
    big = torch.tensor(float(1 << 30), dtype=torch.float32, device=W.device)

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
            c = mv_cost(lam, mvi * 4 + q, pmv,
                        satd(ob, pred).to(torch.float32))
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


def refine(W, ob, mvi, pmv, lam, subme: int, mrq: int,
           bit_depth: int = 8):
    """Subpel refine of every block (``lam`` a scalar or one per block) at
    ``bit_depth`` 8 or 10.  CPU tensors: ``refine_plain``.  CUDA tensors:
    one launch of K2 (or an exception)."""
    if W.device.type != "cuda":
        return refine_plain(W, ob, mvi, pmv, lam, subme, mrq, bit_depth)
    return launch(load_library(), W, ob, mvi, pmv, lam, subme, mrq,
                  bit_depth)


def launch(lib, W, ob, mvi, pmv, lam, subme: int, mrq: int,
           bit_depth: int = 8):
    """Launch K2 from ``lib`` on the device of ``W`` (the CUDA library on
    CUDA tensors; the host build of the same source on CPU tensors)."""
    global LAUNCHES, LAUNCHES_10BIT, LAUNCHES_BLOCKS
    if bit_depth not in (8, 10):
        raise NotImplementedError(
            f"K2 covers bit depths 8 and 10, not {bit_depth}")
    B = W.shape[0]
    for nm, x, shp in (("W", W, (B, 25, 25)), ("ob", ob, (B, 16, 16)),
                       ("mvi", mvi, (B, 2)), ("pmv", pmv, (B, 2))):
        if (x.device != W.device or x.dtype != torch.int32
                or tuple(x.shape) != shp or not x.is_contiguous()):
            raise ValueError(f"K2 input {nm}: expected contiguous "
                             f"{W.device} int32 {shp}, got {x.device} "
                             f"{x.dtype} {tuple(x.shape)}")
    lam_t = torch.as_tensor(lam, dtype=torch.float32).reshape(-1).to(
        W.device).contiguous()
    if lam_t.numel() not in (1, B):
        raise ValueError(f"K2 lam: expected a scalar or [{B}], got "
                         f"{tuple(lam_t.shape)}")
    mvb = dev_table("mvbits", mv_bits_table, W.device)
    q0 = torch.empty((B, 2), dtype=torch.int32, device=W.device)
    pred = torch.empty((B, 16, 16), dtype=torch.int32, device=W.device)
    cost = torch.empty((B,), dtype=torch.float32, device=W.device)
    stream = (torch.cuda.current_stream(W.device).cuda_stream
              if W.device.type == "cuda" else 0)
    with on_device(W.device):
        rc = lib.k2_subpel_refine(
            W.data_ptr(), ob.data_ptr(), mvi.data_ptr(), pmv.data_ptr(),
            lam_t.data_ptr(), mvb.data_ptr(), q0.data_ptr(), pred.data_ptr(),
            cost.data_ptr(), B, int(subme), int(mrq),
            0 if lam_t.numel() == 1 else 1, 1 if bit_depth == 10 else 0,
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"K2 launch failed: {lib.k_error_string(rc).decode()}")
    with _COUNT_LOCK:
        LAUNCHES += 1
        LAUNCHES_BLOCKS += B
        if bit_depth == 10:
            LAUNCHES_10BIT += 1
    return q0, pred, cost
