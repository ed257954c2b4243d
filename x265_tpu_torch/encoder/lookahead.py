"""Lookahead: lowres analysis, cuTree QP offsets and the b-adapt costs —
torch twin of ``x265_tpu.encoder.lookahead``.

Per pushed frame the host makes the half-res luma (cropped to multiples of
8) and ONE device program computes, on the lowres 8x8 grid, the open-loop
35-mode intra SATD and the full-search SAD (+-10 lowres pixels, an |mv|
bias) against the previous lowres frame; the host fetches the three small
int32 arrays.  cuTree (``_propagate``), the scenecut test and every other
decision taken on floats stay on the host in numpy, in the reference's
order, so that the stream is the reference's.  The b-adapt trellis
(``Encoder._slicetype_decide``) asks for pair costs (the same SAD program
between two lowres frames) and bidir costs (a second device program: SAD
against the rounded average of two integer-MV predictions).

The programs run on the lookahead's device (the encoder's); the reference's
``lax.scan`` over the 21 rows of dy is a loop here, one [21, lh, lw] SAD
slab at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from .._util import to_device
from ..ops.cost import satd as satd_fn
from ..ops.intra import predict_all_modes, substitute_references


class LowresFrame:
    """Analyzed lookahead entry (role of x265's Lowres, lowres.h:107)."""

    __slots__ = ("planes", "low", "intra_cost", "inter_cost", "mv",
                 "aq_offsets", "invq", "satd_cost", "weight")

    def __init__(self, planes, low, aq_offsets):
        self.planes = planes          # full-res source (Y, Cb, Cr)
        self.low = low                # device half-res luma
        self.intra_cost = None        # [gh8, gw8] int32 (lowres 8x8 grid)
        self.inter_cost = None        # [gh8, gw8] int32 vs previous frame
        self.mv = None                # [gh8, gw8, 2] int32 (x, y) lowres px
        self.aq_offsets = aq_offsets  # [gh16, gw16] float (full-res grid)
        self.invq = None              # 256 * 2^(-aqoff/6) per lowres block
        self.satd_cost = 0.0          # frame complexity for rate control


def _clamped(lo, hi, size, device):
    """Indices lo..hi-1 clamped into [0, size): an edge pad as a gather."""
    return torch.arange(lo, hi, device=device).clamp(0, size - 1)


class _LowresProgram:
    """(cur_low, prev_low) -> per-8x8-block intra cost, inter cost and
    integer MV (x, y), all int32 [gh, gw(, 2)] on the device.  ``inter``
    alone is the pair cost of the b-adapt trellis."""

    def __init__(self, lw, lh, r, device):
        n = 8
        self.n, self.r, self.lw, self.lh = n, r, lw, lh
        self.gh, self.gw = gh, gw = lh // n, lw // n
        nb = gh * gw
        dev = self.device = torch.device(device)
        offs = np.array([(dy, dx) for dy in range(-r, r + 1)
                         for dx in range(-r, r + 1)], np.int32)
        self.offs = torch.as_tensor(offs, device=dev)
        # small |mv| bias (the lambda*mvbits analogue of lowresMC cost)
        self.bias = torch.as_tensor(np.abs(offs).sum(1) >> 2, device=dev)

        # open-loop intra availability on the lowres grid (top/left rows)
        av = np.ones((nb, 4 * n + 1), bool)
        by = np.repeat(np.arange(gh), gw)
        bx = np.tile(np.arange(gw), gh)
        av[bx == 0, :2 * n + 1] = False              # left column + corner
        av[by == 0, 2 * n:] = False                  # corner + top rows
        av[by == gh - 1, :n] = False                 # below-left
        av[bx == gw - 1, 3 * n + 1:] = False         # above-right
        # raster order: below-left is never available
        av[:, :n] = False
        self.av = torch.as_tensor(av, device=dev)

        # reference vector of block (by, bx) in the picture edge-padded by
        # 1 above / left: left column bottom-up (2n samples), the corner,
        # then the top row (2n samples)
        i = np.arange(2 * n + 1)
        ry = np.concatenate([np.broadcast_to(by[:, None] * n + 2 * n - 1 - i,
                                             (nb, 2 * n + 1)),
                             np.broadcast_to(by[:, None] * n - 1,
                                             (nb, 2 * n))], 1)
        rx = np.concatenate([np.broadcast_to(bx[:, None] * n - 1,
                                             (nb, 2 * n + 1)),
                             bx[:, None] * n + np.arange(2 * n)], 1)
        self.ref_idx = torch.as_tensor(
            np.clip(ry, 0, lh - 1) * lw + np.clip(rx, 0, lw - 1), device=dev)
        self.pad_rows = _clamped(-r, lh + r, lh, dev)
        self.pad_cols = _clamped(-r, lw + r, lw, dev)

    def _blocks(self, cur32):
        n = self.n
        return cur32.reshape(self.gh, n, self.gw, n).permute(
            0, 2, 1, 3).reshape(-1, n, n)

    def intra(self, cur):
        cur32 = cur.to(torch.int32)
        # bit depth 8 even at Main10, as the reference's lowres intra (an
        # inherited fault, kept so that the costs and streams stay equal)
        refs = substitute_references(cur32.reshape(-1)[self.ref_idx],
                                     self.av, 8)
        preds = predict_all_modes(refs, self.n, True, 8)
        icost = satd_fn(self._blocks(cur32)[:, None], preds).min(1).values
        return (icost + 4).reshape(self.gh, self.gw).to(torch.int32)

    def inter(self, cur, prev):
        """Full-search SAD vs ``prev`` edge-padded by r, one row of dy at a
        time; the argmin of cost + bias takes the first minimum in dy-major
        order."""
        n, r, lh, lw, gh, gw = self.n, self.r, self.lh, self.lw, self.gh, \
            self.gw
        span = 2 * r + 1
        cur32 = cur.to(torch.int32)
        pe = prev.to(torch.int32)[self.pad_rows][:, self.pad_cols]
        cs = torch.empty((span, span, gh, gw), dtype=torch.int32,
                         device=self.device)
        for dy in range(span):
            cand = pe[dy:dy + lh].unfold(1, lw, 1).permute(1, 0, 2)
            d = (cur32[None] - cand).abs()
            cs[dy] = d.reshape(span, gh, n, gw, n).sum((2, 4),
                                                       dtype=torch.int32)
        costs = cs.permute(2, 3, 0, 1).reshape(gh * gw, -1)
        idx = torch.argmin(costs + self.bias[None, :], dim=1)
        pcost = torch.gather(costs, 1, idx[:, None])[:, 0]
        mv = self.offs[idx].flip(-1)                 # (dy, dx) -> (x, y)
        return (pcost.reshape(gh, gw).to(torch.int32),
                mv.reshape(gh, gw, 2).to(torch.int32))

    def __call__(self, cur, prev):
        pcost, mv = self.inter(cur, prev)
        return self.intra(cur), pcost, mv


def _build_lowres_program(lw, lh, r, device="cpu"):
    """Device program: (cur_low, prev_low) -> per-8x8-block intra cost,
    inter cost, integer MV; and the lowres grid (gh, gw)."""
    prog = _LowresProgram(lw, lh, r, device)
    return prog, (prog.gh, prog.gw)


def _build_bidir_program(lw, lh, r, device="cpu"):
    """Device program: (cur, ref0, ref1, mv0, mv1) -> per-8x8-block SAD of
    cur vs the rounded average of the two integer-MV motion compensations
    (the lowres bidir predictor of x265's estimateFrameCost,
    slicetype.cpp:377); MVs (x, y) are clipped to +-r."""
    n = 8
    gh, gw = lh // n, lw // n
    dev = torch.device(device)
    by = torch.arange(gh, device=dev).repeat_interleave(gw) * n
    bx = torch.arange(gw, device=dev).repeat(gh) * n
    k = torch.arange(n, device=dev)
    pad_rows = _clamped(-r, lh + r, lh, dev)
    pad_cols = _clamped(-r, lw + r, lw, dev)

    def mc(ref, mv):
        pe = ref.to(torch.int32)[pad_rows][:, pad_cols]
        mvf = mv.reshape(-1, 2).to(torch.int64)      # (x, y) lowres px
        ys = by + mvf[:, 1].clamp(-r, r) + r
        xs = bx + mvf[:, 0].clamp(-r, r) + r
        return pe[(ys[:, None] + k)[:, :, None], (xs[:, None] + k)[:, None]]

    def run(cur, p0, p1, mv0, mv1):
        ob = cur.to(torch.int32).reshape(gh, n, gw, n).permute(
            0, 2, 1, 3).reshape(-1, n, n)
        pred = (mc(p0, mv0) + mc(p1, mv1) + 1) >> 1
        sad = (ob - pred).abs().sum((1, 2), dtype=torch.int32)
        return sad.reshape(gh, gw)

    return run


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


class Lookahead:
    """Sliding-window lookahead queue (x265 Lookahead role).

    push() returns analyzed frames ready for encoding once the window is
    deep enough; flush() drains.  Offsets returned per frame combine AQ
    and cuTree (qpCuTreeOffset semantics).  ``calls`` counts the device
    programs' runs and ``devices`` holds the device types their outputs
    lay on."""

    def __init__(self, params, bit_depth: int = 8, device="cuda"):
        self.p = params
        self.bit_depth = bit_depth
        self.device = torch.device(device)
        self.depth = max(1, min(params.rc_lookahead, 32))
        self.cutree = bool(params.cu_tree)
        self.strength = 5.0 * (1.0 - params.qcomp)
        self.queue: list[LowresFrame] = []
        self._prog = None
        self._prev_low = None
        self._pair_cache = {}           # (id, id) -> ([gh,gw] sad, mv)
        self._bidir_prog = None
        self.calls = dict(lowres=0, pair=0, bidir=0)
        self.devices = set()

    def _ran(self, name, out):
        self.calls[name] += 1
        self.devices.add(out[0].device.type)

    @trace.spanned("lookahead")
    def _analyze(self, fr: LowresFrame) -> None:
        y = fr.planes[0]
        h2, w2 = (y.shape[0] // 2) & ~7, (y.shape[1] // 2) & ~7
        if self._prog is None:
            r = 10
            self._prog = _build_lowres_program(w2, h2, r, self.device)[0]
        y32 = np.asarray(y, np.uint8 if self.bit_depth == 8
                         else np.uint16).astype(np.int32)
        low = ((y32[0::2, 0::2] + y32[1::2, 0::2] + y32[0::2, 1::2]
                + y32[1::2, 1::2] + 2) >> 2)[:h2, :w2]
        low = to_device(
            low.astype(np.uint8 if self.bit_depth == 8 else np.uint16),
            self.device)
        prev = self._prev_low if self._prev_low is not None else low
        out = self._prog(low, prev)
        self._ran("lowres", out)
        ic, pc, mv = out
        fr.low = low
        fr.intra_cost = _host(ic)
        fr.inter_cost = _host(pc)
        fr.mv = _host(mv)
        fr.satd_cost = float(np.minimum(fr.intra_cost,
                                        fr.inter_cost).sum())
        # invQscaleFactor (common.cpp:94 x265_exp2fix8 semantics) on the
        # lowres block grid (== full-res 16x16 grid, cropped to match)
        gh, gw = fr.intra_cost.shape
        aq = fr.aq_offsets[:gh, :gw] if fr.aq_offsets is not None \
            else np.zeros((gh, gw))
        fr.invq = 256.0 * np.exp2(-aq / 6.0)
        self._prev_low = low

    def push(self, planes, aq_offsets) -> list:
        """Add a display-order frame; returns frames leaving the window
        (with their cuTree offsets) in display order."""
        fr = LowresFrame(planes, None, aq_offsets)
        self._analyze(fr)
        self.queue.append(fr)
        out = []
        while len(self.queue) > self.depth:
            out.append(self._pop())
        return out

    def flush(self) -> list:
        out = []
        while self.queue:
            out.append(self._pop())
        return out

    def _pop(self) -> tuple:
        """Run cuTree over the current window and pop the front frame.

        Returns (planes, offsets16 [gh, gw] float or None, satd_cost,
        scenecut, frame): scenecut is the lowres cost-ratio decision (a
        frame whose inter cost is close to its intra cost starts a new
        GOP), taken before dispatch."""
        fr = self.queue[0]
        off = fr.aq_offsets
        scenecut = False
        if fr.intra_cost is not None:
            bias = self.p.scenecut_threshold / 100.0
            ic = float(fr.intra_cost.sum())
            pc = float(np.minimum(fr.intra_cost, fr.inter_cost).sum())
            scenecut = ic > 0 and pc >= (1.0 - bias) * ic
        if self.cutree and fr.intra_cost is not None:
            prop = self._propagate()
            ic = fr.intra_cost.astype(np.float64)
            weighted = ic * fr.invq / 256.0
            log2_ratio = np.where(
                weighted > 0,
                np.log2(weighted + prop + 1e-9) - np.log2(weighted + 1e-9),
                0.0)
            gh, gw = ic.shape
            base = (fr.aq_offsets[:gh, :gw]
                    if fr.aq_offsets is not None else 0.0)
            off = base - self.strength * log2_ratio
        self.queue.pop(0)
        return fr.planes, off, fr.satd_cost, scenecut, fr

    # -- b-adapt cost estimation ---------------------------------------------

    def pair_cost(self, b_fr: LowresFrame, r_fr: LowresFrame) -> tuple:
        """Per-8x8-lowres-block SAD of ``b_fr`` full-search-predicted
        from ``r_fr`` ([gh, gw] int32) plus the winning integer MVs, as
        host arrays (the window analysis's SAD program)."""
        k = (id(b_fr), id(r_fr))
        hit = self._pair_cache.get(k)
        if hit is not None:
            return hit
        res = self._prog.inter(b_fr.low, r_fr.low)
        self._ran("pair", res)
        out = (_host(res[0]), _host(res[1]))
        self._pair_cache[k] = out
        if len(self._pair_cache) > 256:
            self._pair_cache.pop(next(iter(self._pair_cache)))
        return out

    def bidir_cost(self, b_fr: LowresFrame, p0: LowresFrame,
                   p1: LowresFrame) -> float:
        """Frame cost of coding ``b_fr`` as a B with references (p0, p1):
        per block min(intra, list0, list1, bidir-average) summed."""
        pc0, mv0 = self.pair_cost(b_fr, p0)
        pc1, mv1 = self.pair_cost(b_fr, p1)
        if self._bidir_prog is None:
            self._bidir_prog = _build_bidir_program(
                *b_fr.low.shape[::-1], r=10, device=self.device)
        res = self._bidir_prog(
            b_fr.low, p0.low, p1.low,
            torch.as_tensor(mv0, device=self.device),
            torch.as_tensor(mv1, device=self.device))
        self._ran("bidir", (res,))
        bi = _host(res)
        per_blk = np.minimum.reduce([
            b_fr.intra_cost.astype(np.int64), pc0.astype(np.int64),
            pc1.astype(np.int64), bi.astype(np.int64)])
        return float(per_blk.sum())

    def p_cost(self, b_fr: LowresFrame, ref_fr: LowresFrame) -> float:
        """Frame cost of coding ``b_fr`` as a P predicted from
        ``ref_fr``: per block min(intra, list0) summed."""
        pc, _ = self.pair_cost(b_fr, ref_fr)
        return float(np.minimum(b_fr.intra_cost.astype(np.int64),
                                pc.astype(np.int64)).sum())

    @trace.spanned("lookahead")
    def _propagate(self) -> np.ndarray:
        """estimateCUPropagate (slicetype.cpp:1741) over the window: each
        frame's (aq-weighted intra cost + inherited propagation) flows to
        the previous frame's blocks along the lowres MVs, weighted by how
        predictable the block was ((intra - inter) / intra)."""
        q = self.queue
        gh, gw = q[0].intra_cost.shape
        prop = np.zeros((gh, gw), np.float64)   # flowing INTO q[i-1]
        for i in range(len(q) - 1, 0, -1):
            fr = q[i]
            ic = fr.intra_cost.astype(np.float64)
            pc = np.minimum(ic, fr.inter_cost.astype(np.float64))
            weighted = ic * fr.invq / 256.0
            amount = (weighted + prop) * np.maximum(ic - pc, 0.0) \
                / np.maximum(ic, 1.0)
            # scatter along MVs with bilinear splitting (x265 CLIP_ADD
            # block); MVs are lowres integer pixels, blocks are 8x8
            nxt = np.zeros((gh, gw), np.float64)
            by = np.repeat(np.arange(gh), gw)
            bx = np.tile(np.arange(gw), gh)
            mv = fr.mv.reshape(-1, 2)
            a = amount.reshape(-1)
            fx = bx * 8 + mv[:, 0]
            fy = by * 8 + mv[:, 1]
            cux = np.floor_divide(fx, 8)
            cuy = np.floor_divide(fy, 8)
            wx = (fx - cux * 8) / 8.0
            wy = (fy - cuy * 8) / 8.0
            for dx, dy, wgt in ((0, 0, (1 - wx) * (1 - wy)),
                                (1, 0, wx * (1 - wy)),
                                (0, 1, (1 - wx) * wy),
                                (1, 1, wx * wy)):
                X = cux + dx
                Y = cuy + dy
                ok = (X >= 0) & (X < gw) & (Y >= 0) & (Y < gh)
                np.add.at(nxt, (Y[ok], X[ok]), a[ok] * wgt[ok])
            prop = nxt
        return prop
