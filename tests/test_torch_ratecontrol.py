"""Rate control on the port against x265_tpu, 96x64 of the bench's panning
content (``synthetic_frame``), MD5 hash SEI, me_range 16 and b-adapt 0 on
both sides (``tests/conftest.py`` patches only the reference's defaults):
CRF, ABR and ABR with VBV through ``Encoder.encode_frame`` (I P P P); CRF
through ``push_frame`` / ``flush`` with B frames and the cuTree lookahead;
2-pass ABR through ``encode_sequence`` (the stats file's text and pass 2's
stream); zones with a qpfile; HRD with VBV (the buffering-period and
picture-timing SEIs) and without it (a warning, no HRD); and
``param_parse`` on x265's option names.  Every access unit must be
byte-identical to the reference's and decode with matching hashes in its
decoder, and each case shows its mode's effect.  The reference's I and P
pipeline builders are memoised for the module."""

import dataclasses

import numpy as np
import pytest

import x265_tpu.encoder as ref_encoder
import x265_tpu.encoder.device_pipeline as ref_dp
from x265_tpu.common.params import Params as RefParams
from x265_tpu.common.params import param_parse as ref_param_parse
from x265_tpu.common.sei import parse_sei_rbsp
from x265_tpu.decoder import decode_annexb
from x265_tpu_torch import Params
from x265_tpu_torch.common.params import param_parse
from x265_tpu_torch.encoder import encode_sequence
from x265_tpu_torch.encoder.intra_encoder import Encoder
from x265_tpu_torch.smoke_config import synthetic_frame
from torch_threads import one_torch_thread  # noqa: F401

W, H, N = 96, 64, 4


@pytest.fixture(scope="module", autouse=True)
def ref_programs():
    """The reference's I, P and B pipeline builders, memoised for the
    module (its encoders share geometry and search / scan parameters; the
    QPs are inputs)."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("build_i_pipeline", "build_p_pipeline",
                     "build_b_pipeline"):
            real = getattr(ref_dp, name)
            memo = {}

            def build(enc, *a, _real=real, _memo=memo, **kw):
                key = (a, tuple(sorted(kw.items())))
                if key not in _memo:
                    _memo[key] = _real(enc, *a, **kw)
                return _memo[key]

            mp.setattr(ref_dp, name, build)
        yield


def _frames(n=N):
    base = synthetic_frame(W, H, 0)
    return [(np.roll(base[0], 3 * t, axis=1), base[1], base[2])
            for t in range(n)]


def _kw(**kw):
    return dict(dict(source_width=W, source_height=H, bframes=0,
                     me_range=16, b_adapt=0, decoded_picture_hash=1,
                     log_level=0), **kw)


def _encode_frames(enc, frames):
    """encode_frame over ``frames``: the headers, each AU and each QP."""
    aus, qps = [enc.headers()], []
    for planes in frames:
        au, _rec = enc.encode_frame(planes)
        aus.append(au)
        qps.append(enc.qp)
    return aus, qps


def _both(frames=None, **kw):
    frames = frames or _frames()
    want = _encode_frames(ref_encoder.Encoder(RefParams(**_kw(**kw))),
                          frames)
    got = _encode_frames(Encoder(Params(**_kw(**kw)), device="cpu"), frames)
    return want, got


def _check_equal(want, got):
    assert [len(a) for a in got] == [len(a) for a in want]
    for i, (a, b) in enumerate(zip(want, got)):
        assert a == b, f"access unit {i} differs"
    pics = decode_annexb(b"".join(got))
    assert len(pics) == len(got) - 1
    assert all(p.hash_ok for p in pics)


RC_MODES = {
    "crf": dict(rc_mode=1, crf=28.0),
    "abr": dict(rc_mode=2, bitrate=120),
    # a 10 kbit buffer filled at 20 kbps binds from the I frame on
    "abr_vbv": dict(rc_mode=2, bitrate=120, vbv_max_bitrate=20,
                    vbv_buffer_size=10),
}


@pytest.mark.parametrize("mode", list(RC_MODES))
def test_rate_control_streams_match_reference(mode):
    """CRF, ABR and ABR + VBV through encode_frame: byte-identical AUs;
    the QPs are the rate control's, not CQP's, and VBV changes the
    stream against the same ABR without it."""
    (want, want_qp), (got, got_qp) = _both(**RC_MODES[mode])
    _check_equal(want, got)
    assert got_qp == want_qp
    cqp = Params().qp
    assert got_qp != [cqp] * N, got_qp
    if mode == "abr_vbv":
        plain, _ = _encode_frames(
            Encoder(Params(**_kw(**RC_MODES["abr"])), device="cpu"),
            _frames())
        assert plain != got


def test_crf_with_bframes_and_lookahead_matches_reference():
    """CRF through push_frame / flush: two B frames, b-pyramid off, the
    cuTree lookahead over a 3-deep window (AQ 2)."""
    frames = _frames(6)
    kw = _kw(rc_mode=1, crf=28.0, bframes=2, b_pyramid=False,
             rc_lookahead=3)
    outs = []
    for enc in (ref_encoder.Encoder(RefParams(**kw)),
                Encoder(Params(**kw), device="cpu")):
        assert enc._use_lookahead
        efs = []
        for planes in frames:
            efs += enc.push_frame(planes)
        efs += enc.flush()
        outs.append(([enc.headers()] + [ef.au for ef in efs],
                     [(ef.poc, ef.kind, ef.qp) for ef in efs]))
    (want, want_k), (got, got_k) = outs
    assert got_k == want_k
    assert {k for _p, k, _q in got_k} == {"I", "P", "B"}
    _check_equal(want, got)


def test_two_pass_matches_reference(tmp_path):
    """2-pass ABR through encode_sequence: pass 1's stats file has the
    reference's text, and pass 2 (which reads it) its stream; pass 2
    differs from pass 1."""
    frames = _frames(5)
    streams, texts = [], []
    for pkg in ("ref", "port"):
        stats = str(tmp_path / f"{pkg}.log")
        kw = _kw(rc_mode=2, bitrate=120, stats_file=stats)
        out = []
        for pss in (1, 2):
            if pkg == "ref":
                s, _ = ref_encoder.encode_sequence(
                    frames, RefParams(**kw, stats_pass=pss))
            else:
                s, _ = encode_sequence(frames, Params(**kw, stats_pass=pss),
                                       device="cpu")
            out.append(s)
            if pss == 1:
                texts.append(open(stats).read())
        streams.append(out)
    assert texts[1] == texts[0]
    assert len(texts[1].strip().splitlines()) == len(frames)
    assert streams[1] == streams[0]
    assert streams[1][1] != streams[1][0]
    pics = decode_annexb(streams[1][1])
    assert len(pics) == len(frames) and all(p.hash_ok for p in pics)


def test_zones_and_qpfile_match_reference(tmp_path):
    """--zones forces frames 2-3 to QP 22 and a qpfile frame 1 to 40."""
    qpfile = tmp_path / "qp.txt"
    qpfile.write_text("1 P 40\n")
    (want, want_qp), (got, got_qp) = _both(
        rc_mode=1, crf=28.0, zones="2,3,q=22", qpfile=str(qpfile))
    _check_equal(want, got)
    assert got_qp == want_qp and got_qp[1:] == [40, 22, 22]


def _sei_types(au):
    """The payload types of each prefix SEI NAL (type 39) of an AU."""
    out = []
    for nal in au.split(b"\x00\x00\x01")[1:]:
        nal = nal.rstrip(b"\x00")
        if (nal[0] >> 1) & 0x3F == 39:
            rbsp = nal[2:].replace(b"\x00\x00\x03", b"\x00\x00")
            out.append([t for t, _p in parse_sei_rbsp(rbsp)])
    return out


def test_hrd_with_vbv_matches_reference():
    """ABR + VBV + HRD: the SPS carries hrd_parameters, every I AU a
    buffering period and every AU a picture timing SEI."""
    frames = _frames(4)
    kw = dict(RC_MODES["abr_vbv"], hrd=True, keyint_max=2)
    (want, _), (got, _) = _both(frames, **kw)
    _check_equal(want, got)
    enc = Encoder(Params(**_kw(**kw)), device="cpu")
    assert enc.hrd and enc.sps.hrd_present
    # frames 0 and 2 open GOPs (keyint 2): buffering period + timing
    assert [_sei_types(au) for au in got[1:]] == [[[0, 1]], [[1]], [[0, 1]],
                                                  [[1]]]


def test_hrd_without_vbv_warns_and_is_off(capsys):
    """--hrd without VBV: the reference's warning, no HRD in the SPS, and
    the stream of the same encode without --hrd."""
    frames = _frames(2)
    enc = Encoder(Params(**_kw(hrd=True, log_level=1)), device="cpu")
    err = capsys.readouterr().err
    assert "--hrd requires --vbv-bufsize/--vbv-maxrate" in err
    assert not enc.hrd and not enc.sps.hrd_present
    got, _ = _encode_frames(enc, frames)
    want, _ = _encode_frames(
        ref_encoder.Encoder(RefParams(**_kw(hrd=True))), frames)
    plain, _ = _encode_frames(Encoder(Params(**_kw()), device="cpu"),
                              frames)
    assert got == want == plain


PARSE_CASES = [
    ("crf", "23"), ("bitrate", "500"), ("qp", "30"), ("pass", "1"),
    ("stats", "x.log"), ("vbv-maxrate", "800"), ("vbv-bufsize", "1600"),
    ("vbv-init", "0.5"), ("hrd", None), ("no-hrd", None), ("lossless", None),
    ("zones", "0,10,q=20/11,20,b=1.5"), ("qpfile", "qp.txt"),
    ("hash", "md5"), ("hash", "crc"), ("hash", "checksum"), ("hash", "2"),
    ("me", "umh"), ("me", "2"), ("fps", "30000/1001"), ("fps", "29.97"),
    ("fps", "25"), ("sar", "16:11"), ("sar", "4x3"),
    ("colorprim", "bt709"), ("colorprim", "9"),
    ("transfer", "smpte-st-2084"), ("colormatrix", "bt2020nc"),
    ("videoformat", "pal"), ("range", "full"), ("range", "limited"),
    ("input-res", "352x288"), ("ctu", "32"), ("aq-strength", "0.8"),
    ("no-sao", None), ("sao", "0"), ("rc-lookahead", "10"), ("psy-rd", "1.5"),
    ("bframes", "3"), ("keyint", "120"), ("nr-intra", "100"),
    ("master-display", "G(13250,34500)B(7500,3000)R(34000,16000)"
                       "WP(15635,16450)L(10000000,1)"),
    ("max-cll", "1000,400"), ("repeat-headers", None), ("aud", "yes"),
    ("rdoq-level=2", None), ("no-open-gop", None), ("ipratio", "1.3"),
]


@pytest.mark.parametrize("name,value", PARSE_CASES)
def test_param_parse_matches_reference(name, value):
    """Both packages' param_parse from the same fields, the defaults and
    a start with the options that reset a default set: equal fields
    after, and the option moved something from one of the starts."""
    moved = False
    for start in (Params(), Params(hrd=True, fps_num=30,
                                   video_full_range=True)):
        before = dataclasses.asdict(start)
        ref = RefParams(**before)
        param_parse(start, name, value)
        ref_param_parse(ref, name, value)
        assert dataclasses.asdict(start) == dataclasses.asdict(ref)
        moved |= dataclasses.asdict(start) != before
    assert moved


@pytest.mark.parametrize("name,value", [("no-such-option", "1"),
                                        ("sar", None)])
def test_param_parse_refuses_like_reference(name, value):
    errs = []
    for fn, p in ((param_parse, Params()), (ref_param_parse, RefParams())):
        with pytest.raises(Exception) as e:
            fn(p, name, value)
        errs.append(type(e.value))
    assert errs[0] is errs[1]
