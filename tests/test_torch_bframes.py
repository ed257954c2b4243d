"""B frames on the CPU: x265_tpu_torch against x265_tpu at 192x128
(gh = 8, gw = 12: both uniformization passes run), me_range 16, lookahead
off (rc_lookahead=0), MD5 hash SEI, otherwise Params() defaults (AQ 2,
psy-rd 2.0, 3 refs, weightp, TMVP, subme 2, SAO, deblock, sign hiding,
strong intra smoothing).

* The B pipeline's ``prep`` (analysis, both lists' searches, the bi
  trial, the direction decision, adoption, uniformization, chroma) for one
  frame and for a batch of two, against the reference's ``prep`` and its
  vmap over frames: every output ``np.array_equal``.
* push_frame / flush of the bench's panning content in two GOP patterns:
  bframes=4 with b-pyramid, 6 frames (encode order I0 P5 B3 B1 B2 B4: the
  reference B with the DPB extension, B1 + B2 as one batched dispatch, B4
  alone: every B dispatch shape of the reference), and bframes=2 without
  b-pyramid, 4 frames (I0 P3 B1 B2, batched).  Every access unit is
  byte-identical, the recons are equal in display order, and the stream
  decodes with matching picture hashes in x265_tpu's decoder.

x265_tpu builds its device programs per Encoder; here they are built once
for the module (``ref_programs``) and shared by its encoders, whose
geometry and search / scan parameters are the same, so that each program
is traced once: the reference streams cost most of this file's time."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import x265_tpu.encoder as ref_encoder
import x265_tpu.encoder.device_pipeline as ref_dp
from bench import synthetic_frame
from x265_tpu.common.params import Params as RefParams
from x265_tpu.decoder import decode_annexb
from x265_tpu_torch import Params
from x265_tpu_torch.convert import planes_to_torch
from x265_tpu_torch.encoder import ctu_scan_cuda, me_cuda
from x265_tpu_torch.encoder import device_pipeline as dp
from x265_tpu_torch.encoder.intra_encoder import Encoder
from ref_memo import ref_programs  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

W, H = 192, 128
CASES = {"pyramid": (dict(bframes=4, b_pyramid=True), 6,
                     [0, 5, 3, 1, 2, 4]),
         "flat": (dict(bframes=2, b_pyramid=False), 4, [0, 3, 1, 2])}


def _frames(n):
    base = synthetic_frame(W, H, 0)
    return [(np.roll(base[0], 3 * t, axis=1), base[1], base[2])
            for t in range(n)]


def _params(cls, case="flat"):
    kw, _n, _pocs = CASES[case]
    return cls(source_width=W, source_height=H, me_range=16,
               rc_lookahead=0, b_adapt=2, decoded_picture_hash=3, **kw)


def _encode(enc, n):
    efs = []
    for planes in _frames(n):
        efs += enc.push_frame(planes)
    efs += enc.flush()
    return enc.headers(), efs


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    case = request.param
    n = CASES[case][1]
    want = _encode(ref_encoder.Encoder(_params(RefParams, case)), n)
    n1, n2 = ctu_scan_cuda.LAUNCHES, me_cuda.LAUNCHES
    got = _encode(Encoder(_params(Params, case), device="cpu"), n)
    launches = (ctu_scan_cuda.LAUNCHES - n1, me_cuda.LAUNCHES - n2)
    return case, want, got, launches


def test_access_units_are_byte_identical(pair):
    case, (hw, want), (hg, got), launches = pair
    # CPU tensors: the plain versions ran, not the kernels
    assert launches == (0, 0)
    assert hg == hw
    assert [ef.poc for ef in got] == [ef.poc for ef in want] == CASES[case][2]
    assert [ef.kind for ef in got] == [ef.kind for ef in want]
    assert [len(ef.au) for ef in got] == [len(ef.au) for ef in want]
    for a, b in zip(want, got):
        assert a.au == b.au, f"access unit of poc {a.poc} differs"


def test_recons_equal_in_display_order(pair):
    _case, (_hw, want), (_hg, got), _l = pair

    def disp(efs):
        return sorted(efs, key=lambda e: e.display_idx)
    assert [e.display_idx for e in disp(got)] == list(range(len(got)))
    for a, b in zip(disp(want), disp(got)):
        for pa, pb in zip(a.recon, b.recon):
            assert np.array_equal(np.asarray(pa), pb)


def test_stream_decodes_with_hashes(pair):
    _case, _want, (hg, got), _l = pair
    pics = decode_annexb(hg + b"".join(ef.au for ef in got))
    assert len(pics) == len(got)
    assert all(p.hash_ok for p in pics)


@functools.lru_cache(maxsize=1)
def _prep_scene():
    """Two source frames and two noisy shifted references (as the
    reference encoder's ME-extended DPB entries)."""
    rng = np.random.RandomState(0)
    base = synthetic_frame(W + 64, H + 64, 1)

    def crop(dy, dx, noise):
        return [np.clip(p[dy // s:dy // s + H // s, dx // s:dx // s + W // s]
                        .astype(np.int32)
                        + rng.randint(-noise, noise + 1, (H // s, W // s)),
                        0, 255).astype(np.uint8)
                for p, s in zip(base, (1, 2, 2))]

    def spoil(planes, cols):
        # replace a band of columns by noise: there the other list wins
        out = []
        for p, s in zip(planes, (1, 2, 2)):
            p = p.copy()
            p[:, cols[0] // s:cols[1] // s] = rng.randint(
                0, 256, (p.shape[0], (cols[1] - cols[0]) // s))
            out.append(p)
        return out

    er = ref_encoder.Encoder(_params(RefParams))
    origs = [crop(10, 20, 0)[0], crop(12, 23, 2)[0]]
    refs = [er._extend_ref(spoil(crop(8, 16, 6), (128, 192))),
            er._extend_ref(spoil(crop(16, 30, 6), (0, 64)))]
    return er, origs, refs


@pytest.mark.parametrize("batch", [None, 2])
def test_b_prep_matches_reference(batch):
    er, origs, refs = _prep_scene()
    ep = Encoder(_params(Params), device="cpu")
    qps = [32, 35]
    rj = [jnp.asarray(p) for r in refs for p in r]
    rt = [p for r in refs for p in planes_to_torch(r, "cpu")]
    if batch is None:
        want = ref_dp.build_b_pipeline(er).prep(jnp.asarray(origs[0]), *rj,
                                                np.int32(qps[0]))
        got = dp.build_b_pipeline(ep).prep(torch.as_tensor(origs[0]), *rt,
                                           qps[0])
    else:
        want = ref_dp.build_b_pipeline(er, batch=2).prep(
            jnp.asarray(np.stack(origs)), *rj,
            jnp.asarray(np.array(qps, np.int32)))
        got = dp.build_b_pipeline(ep, batch=2).prep(
            torch.as_tensor(np.stack(origs)), *rt, qps)
    names = "modes mode32 mv0 mv1 d inter pred_y pred_cb pred_cr".split()
    for nm, a, b in zip(names, want, got):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, (nm, a.shape, b.shape)
        assert np.array_equal(a, b), (nm, int((a != b).sum()))
    # the scene exercises all three directions and both intra and inter
    d, inter = np.asarray(want[4]), np.asarray(want[5])
    assert set(np.unique(d[inter])) == {1, 2, 3}
    assert inter.any() and not inter.all()
