"""The slice end to end on the CPU: x265_tpu_torch's Encoder.encode_frame
against x265_tpu's, 192x128, I P P of the bench's panning content with
Params(bframes=0, me_range=16, decoded_picture_hash=3) and otherwise the
defaults (AQ 2, psy-rd 2.0, 3 refs, weightp, TMVP, subme 2, SAO, deblock,
sign hiding, strong intra smoothing).  Every access unit must be
byte-identical, and the stream must decode with matching picture hashes
in x265_tpu's decoder; the same through push_frame with the cuTree
lookahead on.  The reference's pipelines are built once for the module."""

import numpy as np
import pytest

import x265_tpu.encoder as ref_encoder
from bench import synthetic_frame
from x265_tpu.common.params import Params as RefParams
from x265_tpu.decoder import decode_annexb
from x265_tpu_torch import Params
from x265_tpu_torch.encoder import ctu_scan_cuda, me_cuda
from x265_tpu_torch.encoder.intra_encoder import Encoder
from ref_memo import ref_programs  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

W, H, N = 192, 128, 3


def _frames(n=N):
    base = synthetic_frame(W, H, 0)
    return [(np.roll(base[0], 3 * t, axis=1), base[1], base[2])
            for t in range(n)]


def _params(cls=Params, **kw):
    return cls(source_width=W, source_height=H, bframes=0, me_range=16,
               decoded_picture_hash=3, **kw)


def _encode(enc):
    aus, recs = [enc.headers()], []
    for planes in _frames():
        au, rec = enc.encode_frame(planes)
        aus.append(au)
        recs.append(rec)
    return aus, recs


def test_ipp_stream_is_byte_identical():
    want, want_rec = _encode(ref_encoder.Encoder(_params(RefParams)))
    n1, n2 = ctu_scan_cuda.LAUNCHES, me_cuda.LAUNCHES
    got, got_rec = _encode(Encoder(_params(), device="cpu"))
    # CPU tensors: the plain versions ran, not the kernels
    assert (ctu_scan_cuda.LAUNCHES, me_cuda.LAUNCHES) == (n1, n2)
    assert [len(a) for a in got] == [len(a) for a in want]
    for i, (a, b) in enumerate(zip(want, got)):
        assert a == b, f"access unit {i} differs"
    for ra, rb in zip(want_rec, got_rec):
        for pa, pb in zip(ra, rb):
            assert np.array_equal(np.asarray(pa), pb)
    pics = decode_annexb(b"".join(got))
    assert len(pics) == N
    assert all(p.hash_ok for p in pics)


@pytest.mark.parametrize("kw", [dict(internal_bit_depth=12),
                                dict(lossless=True, internal_bit_depth=12)])
def test_unsupported_configs_raise(kw):
    p = Params(source_width=W, source_height=H, **kw)
    with pytest.raises(NotImplementedError):
        Encoder(p, device="cpu")


def test_lookahead_path_matches_reference():
    """push_frame with the cuTree lookahead on (bframes=0, a 2-deep
    window): the first rc_lookahead pushes return nothing, the rest return
    what the reference's do, and every access unit equals the
    reference's."""
    frames = _frames(4)
    outs = []
    for enc in (ref_encoder.Encoder(_params(RefParams, rc_lookahead=2)),
                Encoder(_params(rc_lookahead=2), device="cpu")):
        assert enc._use_lookahead
        pushed = [enc.push_frame(planes) for planes in frames]
        aus = [enc.headers()] + [ef.au for out in pushed + [enc.flush()]
                                 for ef in out]
        outs.append(([len(out) for out in pushed], aus))
    (want_n, want), (got_n, got) = outs
    assert got_n[:2] == [0, 0] and got_n == want_n
    assert len(got) == len(want) == 5
    for i, (a, b) in enumerate(zip(want, got)):
        assert a == b, f"access unit {i} differs"


def test_encode_frame_refuses_bframes():
    """B frames reorder the output: encode_frame raises as x265_tpu's does
    (push_frame / flush is the B path)."""
    enc = Encoder(Params(source_width=W, source_height=H, bframes=2,
                         rc_lookahead=0), device="cpu")
    with pytest.raises(ValueError):
        enc.encode_frame(_frames()[0])
