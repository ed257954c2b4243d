"""What decides ``correct``: the run's Annex-B stream judged by the plain
reference decoder (``refdec``), which imports nothing of the program.

The stream is every AU the encoder returned, the frames flushed after the
window included.  The judge:

* indexes every picture from the stream's own headers (parameter sets,
  slice headers, POCs, reference lists, hash SEIs);
* decodes a sample of pictures alone: the stream's first picture (the
  IDR that starts the chain, decoded from nothing) and ``check_pictures``
  pictures of the window drawn from the seed, one of each slice type that
  the window holds first.  A picture's reference
  planes and its collocated motion field are the program's own (its
  reconstructions and the motion fields it retained for TMVP); each of
  those is held against the reference wherever its picture is sampled;
* counts, each against its limit:
  - ``pictures_missing``: frames pushed that no picture of the stream
    shows (display indices are worked out from the stream's POCs);
  - ``samples_differing``: samples of the sampled pictures where the
    reference's decode differs from the program's reconstruction (a
    picture that does not decode counts all its samples);
  - ``hash_mismatches``: sampled pictures whose decode does not match
    their decoded-picture hash SEI (MD5), or that carry none;
  - ``motion_mismatches``: sampled pictures whose decoded motion field
    reads otherwise to TMVP than the one the program retained;
  - ``cuts_not_intra`` (configurations with scene-cut detection, traffic
    with cuts): shot cuts whose first frame the stream does not code as
    an intra picture;
  - ``sao_ctbs_differing`` (configurations with SAO): CTB components
    (luma, chroma) of the sampled pictures whose SAO parameters in the
    stream differ from the decision of the benchmark's frozen plain copy
    of the encoder's (``refenc.sao``), worked out again from the
    picture's source frame, the reference decoder's planes before SAO and
    the lambda of the slice QP (a picture that does not decode counts
    all its CTBs);
* holds the encoder's decisions to the benchmark's frozen plain copies of
  the CTU step and the subpel refine (``steps``, ``refenc``): a seeded
  sample of the run's K1 and K2 calls of every shape, each recomputed from
  its own inputs with the settings of the stream's parameter sets and the
  configuration, and counts
  - ``k1_outputs_differing``: elements of the sampled K1 calls' outputs
    (TU levels, the 32-vs-16, TU32 and split choices, the reconstructed
    CTUs and the new frontier) that the reference step does not
    reproduce;
  - ``k2_outputs_differing``: elements of the sampled K2 calls' outputs
    (quarter-pel vectors, predictions, costs) that the reference refine
    does not reproduce.
Every comparison is exact, so every limit is 0.
"""

from __future__ import annotations

import functools
import random
import sys
import time

import numpy as np

from .content import sub_seed
from .refdec.cabac.ctu import MODE_INTRA
from .refdec.common.headers import SLICE_I
from .refdec.decoder import (DecodeError, decode_picture, hash_matches,
                             index_stream)

LIMITS = dict(pictures_missing=0, samples_differing=0, hash_mismatches=0,
              motion_mismatches=0, cuts_not_intra=0, sao_ctbs_differing=0,
              k1_outputs_differing=0, k2_outputs_differing=0)


@functools.lru_cache(maxsize=2)
def _index(stream: bytes) -> list:
    return index_stream(stream)


def slice_types(stream: bytes) -> list:
    """The slice type of each picture of the stream, in decode order."""
    return [e.slice_type for e in _index(stream)]


def draw_sample(seed: int, window_orders: list, n: int,
                types: list | None = None) -> list:
    """Decode-order indices to judge: the stream's first picture and ``n``
    of the window's pictures drawn from the seed: first one picture of
    each slice type that the window holds (``types``: the stream's, in
    decode order), then the rest from all of them."""
    rng = random.Random(sub_seed(seed, "check"))
    pool = sorted(set(window_orders) - {0})
    picked = []
    if types is not None:
        for t in sorted({types[k] for k in pool if k < len(types)}):
            if len(picked) < n:
                picked.append(rng.choice([k for k in pool if k < len(types)
                                          and types[k] == t]))
    rest = [k for k in pool if k not in picked]
    picked += rng.sample(rest, min(n - len(picked), len(rest)))
    return [0] + sorted(picked)


def tmvp_view(m: dict, h4: int, w4: int) -> np.ndarray:
    """A motion field as TMVP reads it (§8.5.3.2.9): on the top-left 4x4
    block of each 16x16 inside the picture, whether it is inter, and the
    motion and reference POC of each list that it uses (a direction of 0
    reads as list 0); what TMVP cannot read is zero."""
    def grid(k):
        return np.asarray(m[k])[:h4:4, :w4:4].astype(np.int64)
    inter = grid("pred_mode") != MODE_INTRA
    d = grid("inter_dir")
    d = np.where(d == 0, 1, d) * inter
    u0, u1 = (d & 1) != 0, (d & 2) != 0
    return np.concatenate([
        inter[..., None], d[..., None],
        grid("mv0") * u0[..., None], (grid("poc0") * u0)[..., None],
        grid("mv1") * u1[..., None], (grid("poc1") * u1)[..., None]], -1)


def motion_equal(a: dict, b: dict, h4: int, w4: int) -> bool:
    """Whether two motion fields read the same to TMVP."""
    return np.array_equal(tmvp_view(a, h4, w4), tmvp_view(b, h4, w4))


def judge(stream: bytes, pushed: int, recon: list, motion: list,
          sample: list, cut_displays: list | None, device,
          log: list | None = None, source=None) -> dict:
    """The numbers compared, from the stream, the number of frames pushed,
    the program's coded-size reconstructions and retained motion fields
    in decode order, the decode-order indices to judge, and the display
    indices of shot cuts (None: not judged).  ``source`` (None: SAO not
    judged) gives a picture's source planes as host arrays.  ``log`` gets
    each judged picture's decode order, slice type, bytes and seconds."""
    from .refenc import sao
    pics = _index(stream)
    shown = {e.display for e in pics}
    out = dict(pictures_missing=len(set(range(pushed)) - shown),
               samples_differing=0, hash_mismatches=0, motion_mismatches=0)
    if source is not None:
        out["sao_ctbs_differing"] = 0
    if len(pics) != len(recon):
        out["pictures_missing"] += abs(len(recon) - len(pics))
    by_key = {(e.cvs, e.poc): e.order for e in pics}
    for k in sample:
        if k >= len(pics) or k >= len(recon):
            out["hash_mismatches"] += 1
            if source is not None:
                out["sao_ctbs_differing"] += 1
            continue
        e = pics[k]
        t0 = time.perf_counter()
        total = sum(int(np.asarray(p).size) for p in recon[k])
        try:
            refs = {p: recon[by_key[(e.cvs, p)]]
                    for p in e.refs_l0 + e.refs_l1}
            col = (motion[by_key[(e.cvs, e.col_poc)]]
                   if e.col_poc is not None else None)
            keep = {}
            coded, mf = decode_picture(e, refs, col, device, keep)
        except (DecodeError, KeyError, IndexError, ValueError,
                AssertionError) as exc:
            print(f"check: picture {k} (POC {e.poc}) does not decode: "
                  f"{exc!r}", file=sys.stderr)
            out["samples_differing"] += total
            out["hash_mismatches"] += 1
            out["motion_mismatches"] += 1
            if source is not None:
                g = 1 << e.sps.log2_ctb_size
                out["sao_ctbs_differing"] += 2 * (
                    -(-e.sps.pic_width // g)) * (-(-e.sps.pic_height // g))
            continue
        diff = sum(int((np.asarray(a).astype(np.int32)
                        != np.asarray(b).astype(np.int32)).sum())
                   if np.asarray(a).shape == np.asarray(b).shape
                   else int(np.asarray(b).size)
                   for a, b in zip(coded, recon[k]))
        out["samples_differing"] += diff
        if not hash_matches(e, coded):
            out["hash_mismatches"] += 1
        if k >= len(motion) or not motion_equal(
                mf, motion[k], e.sps.pic_height // 4, e.sps.pic_width // 4):
            out["motion_mismatches"] += 1
        if source is not None:
            ps = keep["syntax"]
            ref = sao.decide(source(e), keep["pre_sao"],
                             1 << e.sps.log2_ctb_size,
                             sao.sao_lambda(e.slice_qp),
                             e.sps.bit_depth_luma)
            out["sao_ctbs_differing"] += sao.ctbs_differing(
                ref, ps.sao_type, ps.sao_eo_class, ps.sao_band_pos,
                ps.sao_offsets)
        if log is not None:
            log.append((k, e.slice_type, len(e.rbsp),
                        round(time.perf_counter() - t0, 3)))
    if cut_displays is not None:
        types = {e.display: e.slice_type for e in pics}
        out["cuts_not_intra"] = sum(1 for d in cut_displays
                                    if types.get(d) != SLICE_I)
    return out


def judge_steps(stream: bytes, recorder, config: dict,
                log: list | None = None) -> dict:
    """``k1_outputs_differing`` and ``k2_outputs_differing`` of the calls
    that ``recorder`` (``steps.StepRecorder``) kept, under the settings of
    the stream's first parameter sets and the configuration."""
    from .refenc.settings import step_settings
    from .steps import differing
    pics = _index(stream)
    if not pics:
        return dict(k1_outputs_differing=1, k2_outputs_differing=1)
    return differing(recorder, step_settings(pics[0].sps, pics[0].pps,
                                             config),
                     any(e.slice_type != SLICE_I for e in pics), log)


def verdict(numbers: dict) -> bool:
    return all(v <= LIMITS[k] for k, v in numbers.items())


def report(numbers: dict) -> dict:
    """Each number compared beside its limit."""
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in numbers.items()}
