"""GOP-parallel encoding on one card or several — torch twin of
``x265_tpu.parallel.gop``.

Closed GOPs are mutually independent (each starts with an IDR), so G of
them encode together: round r codes frame r of every GOP.  The reference
runs a round's device programs under ``shard_map``, one GOP a device of a
mesh axis of all its devices.  The port splits the G GOPs into D shards of
G / D contiguous GOPs, one a device of ``devices`` (a device may appear
more than once).  Inside a shard the twin of the mesh axis is a leading
frame dimension of size G / D on the batched I and P pipelines
(``device_pipeline.build_i_pipeline`` / ``build_p_pipeline`` with
``batch=G / D``): a round's scan is one K1 launch a wavefront level over
the shard's frames' lanes, and each reference slot's search one K2 launch
over their blocks.  Each GOP keeps its own host ``Encoder`` (headers,
syntax, CABAC, rate control), which finishes its frame of a round from one
shared fetch of the shard's round; with several shards each runs its
rounds on its own host thread and CUDA stream, since closed GOPs share
nothing, and an exception in any of them is raised by ``encode``.  The GOP
streams are concatenated in GOP order under one header block.

At CQP the stream equals the sequential encode of the same frames with
``keyint_max`` equal to the GOP size (the device work is deterministic and
sees the same inputs); under ABR / CRF each GOP runs its own rate control,
and each GOP's stream equals that GOP encoded alone.  The GOPs are IPPP
(``bframes=0``); no lookahead runs, so ``cu_tree`` changes nothing here,
and no scene cut re-encodes a frame (GOP boundaries are fixed).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .._util import on_device, to_device
from ..common.params import Params
from ..encoder.device_pipeline import build_i_pipeline, build_p_pipeline
from ..encoder.intra_encoder import Encoder, _BatchFetch


class GopParallelEncoder:
    """Encode ``n_gops`` closed IPPP GOPs together: G / D of them on each
    of the D ``devices`` (default ``[device]``), one batched I or P
    dispatch a round a device for frame r of its GOPs."""

    def __init__(self, params: Params, n_gops: int, device="cuda",
                 devices=None):
        if params.bframes != 0:
            raise ValueError("GOP-parallel encoding is IPPP: bframes must "
                             "be 0")
        self.params = params
        self.G = int(n_gops)
        devices = [device] if devices is None else list(devices)
        if not devices or self.G % len(devices):
            raise ValueError(f"{self.G} GOPs do not split into "
                             f"{len(devices)} equal shards")
        per = self.G // len(devices)
        self.shards = [_Shard(params, per, d) for d in devices]
        self.encoders = [e for sh in self.shards for e in sh.encoders]

    def encode(self, gops: list[list]) -> list[bytes]:
        """``gops``: G lists of (Y, Cb, Cr) frames of one length, each a
        closed GOP.  Returns the G Annex-B streams (headers + AUs)."""
        if len(gops) != self.G:
            raise ValueError(f"need exactly {self.G} GOPs, got {len(gops)}")
        n = len(gops[0])
        if any(len(g) != n for g in gops):
            raise ValueError("the GOPs must be of equal length")
        per = self.G // len(self.shards)
        parts = [gops[k * per:(k + 1) * per]
                 for k in range(len(self.shards))]
        if len(self.shards) == 1:
            return self.shards[0].encode(parts[0])
        # one host thread a shard; the pool's exit waits for every shard,
        # and result() raises a failed shard's exception (the first in
        # shard order)
        with ThreadPoolExecutor(len(self.shards)) as pool:
            futs = [pool.submit(sh.encode_on_stream, part)
                    for sh, part in zip(self.shards, parts)]
            return [s for f in futs for s in f.result()]


class _Shard:
    """G / D of the GOPs on one device: their host Encoders, the batched I
    and P pipelines (``batch`` the shard's GOPs) and, on a CUDA device, a
    stream of their own for ``encode_on_stream``."""

    def __init__(self, params: Params, n_gops: int, device):
        self.params = params
        self.G = n_gops
        self.encoders = [Encoder(params, device=device)
                         for _ in range(n_gops)]
        self.device = self.encoders[0].device
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self._i_pipe = None
        self._p_pipe = None

    def _build(self):
        e0 = self.encoders[0]
        self._i_pipe = build_i_pipeline(e0, batch=self.G)
        self._p_pipe = build_p_pipeline(e0, nr=e0.num_ref, batch=self.G)

    def encode_on_stream(self, gops: list[list]) -> list[bytes]:
        """``encode`` with the shard's device current and its stream the
        current one (a shard's thread), after the work already queued on
        the device's default stream (what the Encoders made there); returns
        once the stream is done."""
        with on_device(self.device):
            if self.stream is None:
                return self.encode(gops)
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.stream):
                out = self.encode(gops)
            self.stream.synchronize()
        return out

    def encode(self, gops: list[list]) -> list[bytes]:
        """The shard's GOPs, round by round; their Annex-B streams."""
        n = len(gops[0])
        if self._i_pipe is None:
            self._build()

        encs = self.encoders
        dev = self.device
        outs = [[] for _ in range(self.G)]
        num_ref = encs[0].num_ref
        ext_hist: list = []             # the round's ext planes, nearest first
        for r in range(n):
            kind = "I" if r == 0 else "P"
            pends = [e._dispatch_one(
                gops[k][r], r, kind, l0_poc=None if r == 0 else r - 1,
                # CQP ignores the complexity: skip the estimate
                cplx=0.0 if self.params.rc_mode == 0 else None,
                defer_all=True) for k, e in enumerate(encs)]
            orig = [to_device(np.stack([p.orig[i] for p in pends]), dev)
                    for i in range(3)]
            qs = [to_device(np.stack([p.qp_arrays[i] for p in pends]), dev)
                  for i in range(5)]
            fq = [np.stack([p.filter_qps[i] for p in pends])
                  for i in range(4)]
            if r == 0:
                small, tails, ext = self._i_pipe(
                    *orig, qs[0], qs[1], qs[2], qs[3], fq[0], fq[1], fq[2],
                    fq[3], qs[4])
            else:
                # the sequential P's padded reference slots: a shorter
                # history repeats its farthest entry, which can never win
                # the ref_idx argmin
                hist = ext_hist + [ext_hist[-1]] * (num_ref - len(ext_hist))
                pocs = [r - 1 - i for i in range(len(ext_hist))]
                pocs = pocs + [pocs[-1]] * (num_ref - len(pocs))
                small, tails, ext = self._p_pipe(
                    *orig, tuple(h[0] for h in hist),
                    tuple(h[1] for h in hist), tuple(h[2] for h in hist),
                    qs[0], qs[1], qs[2], qs[3], fq[0], fq[1], fq[2], fq[3],
                    qs[4], pocs, wy=[p.wp[0] for p in pends],
                    wo=[p.wp[1] for p in pends], n_act=len(ext_hist))
            ext_hist = [ext] + ext_hist[:num_ref - 1]
            for e, pend in zip(encs, pends):
                e._after_anchor(pend, idr=(r == 0))
            handle = _BatchFetch(small)
            # the host finish per GOP, in GOP order
            for k, (e, pend) in enumerate(zip(encs, pends)):
                pend.out_dev = (handle, tails)
                pend.batch_idx = k
                outs[k].append(e._finish_one(pend).au)
        return [encs[k].headers() + b"".join(outs[k]) for k in range(self.G)]


def encode_gop_parallel(frames: list, params: Params, n_gops: int,
                        gop_size: int | None = None, device="cuda",
                        devices=None) -> bytes:
    """Split ``frames`` into ``n_gops`` equal closed GOPs, encode them
    together (G / D a device of ``devices``, default ``[device]``) and
    return the concatenated Annex-B stream (one header block): at CQP
    byte-identical to the sequential encode with ``keyint_max ==
    gop_size``."""
    enc = GopParallelEncoder(params, n_gops, device=device, devices=devices)
    G = enc.G
    if gop_size is None:
        gop_size = len(frames) // G
    if gop_size * G != len(frames):
        raise ValueError(f"need {G} equal GOPs (got {len(frames)} frames)")
    gops = [frames[k * gop_size:(k + 1) * gop_size] for k in range(G)]
    streams = enc.encode(gops)
    hdr = enc.encoders[0].headers()
    return hdr + b"".join(s[len(hdr):] for s in streams)
