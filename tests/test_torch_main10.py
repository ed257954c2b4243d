"""Main10 (``internal_bit_depth=10``) streams on the CPU: x265_tpu_torch
against x265_tpu at 192x128 (3 x 2 CTBs) on ``smoke_config``'s 10-bit
panning content (bands at 0 and 1023), me_range 16, the MD5 hash SEI
(``decoded_picture_hash=1``, so the host's 16-bit hash path runs) and
otherwise the defaults:

* IPPP through ``encode_frame`` (``bframes=0``, lookahead off);
* a B mini-GOP with the lookahead on through ``push_frame`` / ``flush``:
  ``bframes=2`` without b-pyramid, b-adapt 0, cuTree over a 3-deep window,
  4 frames, encode order I0 P3 B1 B2 (the two Bs one batched dispatch).

Every access unit is byte-identical to the reference's, the recons are
equal uint16 planes, and the stream decodes with matching MD5 hashes in
x265_tpu's decoder.  The reference's pipeline builders and lookahead
programs are built once for the module and shared by its encoders.  The
host float math with bit-depth terms, AQ offsets (all four modes) and
weightp's analysis (a fade, a pan, a contrast change), equals the
reference's in float64 at 10 bits."""

import numpy as np
import pytest
import torch

import x265_tpu.encoder as ref_encoder
import x265_tpu.encoder.aq as ref_aq
import x265_tpu.encoder.weights as ref_weights
from x265_tpu.common.params import Params as RefParams
from x265_tpu.decoder import decode_annexb
from x265_tpu_torch import Params
from x265_tpu_torch.encoder import aq, ctu_scan_cuda, me_cuda, weights
from x265_tpu_torch.encoder.intra_encoder import Encoder
from x265_tpu_torch.smoke_config import smoke_frames_bench10
from ref_memo import ref_programs  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

W, H = 192, 128
CASES = {"ippp": (dict(bframes=0, rc_lookahead=0), 3, [0, 1, 2]),
         "bgop": (dict(bframes=2, b_pyramid=False, b_adapt=0,
                       rc_lookahead=3), 4, [0, 3, 1, 2])}


def _params(cls, case):
    kw, _n, _pocs = CASES[case]
    return cls(source_width=W, source_height=H, me_range=16,
               internal_bit_depth=10, decoded_picture_hash=1, **kw)


def _encode(enc, case):
    frames = smoke_frames_bench10(W, H, CASES[case][1])
    if case == "ippp":
        out = []
        for poc, planes in enumerate(frames):
            au, rec = enc.encode_frame(planes)
            out.append((poc, au, rec))
        return enc.headers(), out
    efs = []
    for planes in frames:
        efs += enc.push_frame(planes)
    efs += enc.flush()
    return enc.headers(), [(ef.poc, ef.au, ef.recon) for ef in efs]


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    case = request.param
    want = _encode(ref_encoder.Encoder(_params(RefParams, case)), case)
    n1, n2 = ctu_scan_cuda.LAUNCHES, me_cuda.LAUNCHES
    enc = Encoder(_params(Params, case), device="cpu")
    got = _encode(enc, case)
    launches = (ctu_scan_cuda.LAUNCHES - n1, me_cuda.LAUNCHES - n2)
    return case, want, got, launches, enc


def test_access_units_are_byte_identical(pair):
    case, (hw, want), (hg, got), launches, enc = pair
    # CPU tensors: the plain versions ran, not the kernels
    assert launches == (0, 0)
    assert hg == hw
    assert [g[0] for g in got] == [w[0] for w in want] == CASES[case][2]
    assert [len(g[1]) for g in got] == [len(w[1]) for w in want]
    for (poc, a, _ra), (_p, b, _rb) in zip(want, got):
        assert a == b, f"access unit of poc {poc} differs"
    if case == "bgop":
        assert enc.lookahead.cutree and enc.lookahead.devices == {"cpu"}
    # the device holds the samples as int16 (torch's CUDA build has no
    # indexing on uint16), the host as uint16
    assert enc.dpb_dev and all(pl.dtype == torch.int16
               for ent in enc.dpb_dev.values()
               for pl in ent)


def test_recons_are_equal_uint16(pair):
    _case, (_hw, want), (_hg, got), _l, _enc = pair
    for (_p, _a, ra), (_q, _b, rb) in zip(want, got):
        for pa, pb in zip(ra, rb):
            assert pb.dtype == np.uint16
            assert np.array_equal(np.asarray(pa), pb)


def test_stream_decodes_with_md5_hashes(pair):
    _case, _want, (hg, got), _l, _enc = pair
    pics = decode_annexb(hg + b"".join(g[1] for g in got))
    assert len(pics) == len(got)
    assert all(p.hash_ok for p in pics)


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_aq_offsets_match_reference_10bit(mode):
    """The AQ offsets' bit-depth terms (the energy's 1 / 4^(bd - 8), the
    14.427 + 2 (bd - 8) of auto-variance) at 10 bits, equal in float64."""
    planes = smoke_frames_bench10(W, H, 1)[0]
    for normalize in (False, True):
        want = ref_aq.aq_offsets(planes, mode, 1.0, 10, normalize=normalize)
        got = aq.aq_offsets(planes, mode, 1.0, 10, normalize=normalize)
        assert got.dtype == want.dtype == np.float64
        assert np.array_equal(got, want)


@pytest.mark.parametrize("change", ["fade", "pan", "contrast"])
def test_luma_weight_matches_reference_10bit(change):
    """weightp's analysis at 10 bits (its 2^(bd - 8) offset scale and 1023
    clip): the same (w, offset, enabled) on a fade, a pan and a contrast
    change of 10-bit content."""
    f0, f1 = (f[0] for f in smoke_frames_bench10(W, H, 2))
    cur = dict(fade=np.clip(f0.astype(np.int32) * 3 // 4, 0, 1023),
               pan=f1,
               contrast=np.clip((f0.astype(np.int32) - 512) * 5 // 4 + 540,
                                0, 1023))[change].astype(np.uint16)
    want = ref_weights.analyse_luma_weight(cur, f0, 10)
    got = weights.analyse_luma_weight(cur, f0, 10)
    assert got == want
    if change != "pan":
        assert got[2]                    # the weight is on
