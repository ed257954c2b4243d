"""The port's decoder on the CPU: ``x265_tpu_torch.decoder`` against
``x265_tpu.decoder`` on the same Annex-B bytes.

The streams are the port's own, encoded once for the module with
``device="cpu"`` (byte-identical to the reference's encodes, without its
tracing): I P at the ``Params()`` defaults on a fade (AQ's cu_qp_delta,
weightp, TMVP, SAO, deblock), a B mini-GOP with b-pyramid, Main10, CTU
32, CTU 16 all-intra without AQ (the batched wavefront recon, in both
packages), lossless, and a size that is not a multiple of the CTB.  Each
decodes with equal POC order, planes (cropped and coded), hashes (all
good), QPs, bit depths and warnings; the parsed syntax of a P and a B
picture is equal array by array.  The unit cases: the CABAC decoder and
``decode_residual`` on bins the reference's encoder wrote; the parameter
set and slice header parsers field by field; the device deblock (per-edge
QPs, motion BS, chroma, 10 bits) and SAO against ``deblock_picture_np``
and ``sao_apply_plane_np``; the reference's robustness cases; and no
fallback to the host."""

import dataclasses
import functools
import re

import numpy as np
import pytest
import torch

import x265_tpu.decoder.decoder as r_decoder
from x265_tpu.cabac import syntax as r_syntax
from x265_tpu.cabac.engine import CabacEncoder
from x265_tpu.cabac.tables import init_context_states
from x265_tpu.common import headers as r_headers
from x265_tpu.common.bitstream import BitReader as RBitReader
from x265_tpu.common.bitstream import BitWriter
from x265_tpu.ops.deblock import deblock_picture_np
from x265_tpu.ops.sao import sao_apply_plane_np
from x265_tpu_torch import Params
from x265_tpu_torch.cabac import syntax as p_syntax
from x265_tpu_torch.cabac.engine import CabacDecoder
from x265_tpu_torch.common import headers as p_headers
from x265_tpu_torch.common.bitstream import BitReader, split_annexb
from x265_tpu_torch.decoder import (DecodedPicture, DecodeError, Decoder,
                                    decode_annexb)
from x265_tpu_torch.decoder import decoder as p_decoder
from x265_tpu_torch.encoder import encode_sequence
from x265_tpu_torch.ops.deblock import deblock_decoded_picture
from x265_tpu_torch.ops.sao import sao_apply_decoded_plane
from x265_tpu_torch.smoke_config import smoke_frames_bench10, synthetic_frame
from torch_threads import one_torch_thread  # noqa: F401


def _pan(w, h, n, fade=0.0):
    y, u, v = synthetic_frame(w, h, 0)
    return [((np.roll(y, 3 * t, axis=1) * (1.0 - fade * t)).astype(np.uint8),
             u, v) for t in range(n)]


# name -> (Params fields, frames)
STREAMS = {
    "ip_defaults": (dict(source_width=128, source_height=64, bframes=0),
                    lambda: _pan(128, 64, 3, fade=0.15)),
    "b_pyramid": (dict(source_width=128, source_height=64, bframes=3,
                       b_pyramid=True, b_adapt=0, rc_lookahead=0),
                  lambda: _pan(128, 64, 5)),
    "main10": (dict(source_width=128, source_height=64, bframes=2,
                    b_pyramid=False, b_adapt=0, rc_lookahead=3,
                    internal_bit_depth=10),
               lambda: smoke_frames_bench10(128, 64, 4)),
    "ctu32": (dict(source_width=128, source_height=64, bframes=0,
                   ctu_size=32), lambda: _pan(128, 64, 2)),
    "ctu16_intra": (dict(source_width=128, source_height=72, bframes=0,
                         ctu_size=16, aq_mode=0, keyint_max=1),
                    lambda: _pan(128, 72, 2)),
    "lossless": (dict(source_width=64, source_height=64, lossless=True),
                 lambda: _pan(64, 64, 2)),
    "odd_size": (dict(source_width=100, source_height=72, bframes=0),
                 lambda: _pan(100, 72, 2)),
}


@functools.lru_cache(maxsize=None)
def _stream(name):
    kw, frames = STREAMS[name]
    params = Params(me_range=16, decoded_picture_hash=1, log_level=0, **kw)
    stream, _recons = encode_sequence(frames(), params, device="cpu")
    return stream


@functools.lru_cache(maxsize=None)
def _decoded(name):
    """(reference Decoder, port Decoder, the wavefront paths the
    reference took, the port's wavefront decodes) on the stream."""
    took = []
    real = r_decoder.Decoder._wavefront_decode

    def spy(self, *a, **kw):
        took.append(real(self, *a, **kw))
        return took[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(r_decoder.Decoder, "_wavefront_decode", spy)
        ref = r_decoder.Decoder()
        ref.push_bytes(_stream(name))
    n0 = p_decoder.WAVEFRONT_DECODES
    port = Decoder(device="cpu")
    port.push_bytes(_stream(name))
    return ref, port, took, p_decoder.WAVEFRONT_DECODES - n0


def _same_pictures(ref_pics, port_pics):
    assert [p.poc for p in port_pics] == [p.poc for p in ref_pics]
    for a, b in zip(ref_pics, port_pics):
        assert isinstance(b, DecodedPicture)
        assert (b.hash_ok, b.qp, b.bit_depth) == (a.hash_ok, a.qp,
                                                  a.bit_depth)
        for pa, pb in zip(a.planes + a.coded_planes,
                          b.planes + b.coded_planes):
            assert pa.shape == pb.shape and np.array_equal(pa, pb)


def _nals(stream):
    return list(split_annexb(stream))


def _slice_headers(stream, mod, reader):
    """(nal_type, parsed slice header) of every VCL NAL, with the parameter
    sets ``mod`` parses."""
    sps = pps = None
    out = []
    for nal_type, _tid, rbsp in _nals(stream):
        if nal_type == 33:
            sps = mod.parse_sps(rbsp)
        elif nal_type == 34:
            pps = mod.parse_pps(rbsp)
        elif nal_type < 32:
            out.append(mod.parse_slice_header(reader(rbsp), sps, pps,
                                              nal_type))
    return sps, pps, out


# what each stream must exercise, read from its parsed headers
def _features(name, sps, pps, shs):
    kinds = {sh.slice_type for sh in shs}
    f = dict(
        ip_defaults=pps.cu_qp_delta_enabled and pps.weighted_pred
        and sps.sao_enabled and sps.temporal_mvp_enabled
        and any(any(e[0] for e in sh.weights_l0) for sh in shs
                if sh.slice_type == 1)
        and not any(sh.deblocking_filter_disabled for sh in shs),
        b_pyramid=0 in kinds and sps.num_reorder_pics >= 2,
        main10=sps.bit_depth_luma == 10 and 0 in kinds,
        ctu32=sps.log2_ctb_size == 5 and 1 in kinds,
        ctu16_intra=sps.log2_ctb_size == 4 and kinds == {2}
        and not pps.cu_qp_delta_enabled and sps.conf_win[3] > 0,
        lossless=bool(pps.transquant_bypass_enabled),
        odd_size=sps.pic_width % 64 != 0 and sps.conf_win[1] > 0)
    return f[name]


@pytest.mark.parametrize("name", list(STREAMS))
def test_decode_matches_reference(name):
    ref, port, took, wf = _decoded(name)
    sps, pps, shs = _slice_headers(_stream(name), p_headers, BitReader)
    assert _features(name, sps, pps, shs), name
    assert ref.pictures and all(p.hash_ok is True for p in ref.pictures)
    _same_pictures(ref.pictures, port.pictures)
    assert port.warnings == ref.warnings == []
    if name == "ctu16_intra":
        # the batched wavefront recon, in both packages, for both pictures
        assert took == [True, True] and wf == 2
    else:
        assert wf == 0 and not any(took)


@pytest.mark.parametrize("name,kind", [("ip_defaults", 1),
                                       ("b_pyramid", 0), ("main10", 0)],
                         ids=["ip_defaults-P", "b_pyramid-B", "main10-B"])
def test_parsed_syntax_matches(name, kind):
    """Every PicSyntax array of the P (B) pictures, as both packages parse
    them: modes, depths, MVs, reference indices, coefficients, SAO."""
    ref, port, _took, _wf = _decoded(name)
    shs = _slice_headers(_stream(name), p_headers, BitReader)[2]
    # the slice type of each POC (port.walls is in decode order)
    kinds = {w["poc"]: sh.slice_type for w, sh in zip(port.walls, shs)}
    checked = 0
    for a, b in zip(ref.pictures, port.pictures):
        if kinds[b.poc] != kind:
            continue
        sa, sb = a.syntax, b.syntax
        for f in dataclasses.fields(sa):
            va = getattr(sa, f.name)
            if isinstance(va, np.ndarray):
                assert np.array_equal(va, getattr(sb, f.name)), (b.poc,
                                                                 f.name)
        assert (sb.ref_pocs_l0, sb.ref_pocs_l1, sb.cur_poc) == (
            sa.ref_pocs_l0, sa.ref_pocs_l1, sa.cur_poc)
        assert (sb.pred_mode != 1).any()         # inter CUs were parsed
        checked += 1
    assert checked


@pytest.mark.parametrize("name", list(STREAMS))
def test_headers_parse_like_reference(name):
    """VPS, SPS, PPS and every slice header of the port's stream, parsed by
    both packages, field by field."""
    stream = _stream(name)
    for nal_type, _tid, rbsp in _nals(stream):
        for t, fn in ((32, "parse_vps"), (33, "parse_sps"),
                      (34, "parse_pps")):
            if nal_type == t:
                assert dataclasses.asdict(getattr(p_headers, fn)(rbsp)) == \
                    dataclasses.asdict(getattr(r_headers, fn)(rbsp))
    rs = _slice_headers(stream, r_headers, RBitReader)
    ps = _slice_headers(stream, p_headers, BitReader)
    assert len(ps[2]) == len(rs[2]) > 0
    for a, b in zip(rs[2], ps[2]):
        assert dataclasses.asdict(b) == dataclasses.asdict(a)


@pytest.mark.parametrize("log2_size,c_idx,sign_hiding",
                         [(2, 0, False), (2, 1, True), (3, 0, True),
                          (3, 2, False), (4, 0, True), (4, 1, False),
                          (5, 0, True)])
def test_cabac_residual_decode(log2_size, c_idx, sign_hiding):
    """Seeded coefficient blocks through the reference's CabacEncoder and
    encode_residual; the port's CabacDecoder and decode_residual read
    them back as the reference's decoder does, context states too."""
    rng = np.random.default_rng(7 * log2_size + c_idx)
    n = 1 << log2_size
    blocks = []
    for trial in range(8):
        density = [0.03, 0.2, 0.6, 1.0][trial % 4]
        c = rng.integers(-40, 41, (n, n)) * (rng.random((n, n)) < density)
        if trial == 7:
            c[0, 0] = 30000              # deep escapes, rice adaptation
        if not c.any():
            c[rng.integers(n), rng.integers(n)] = 1
        scans = [0, 1, 2] if log2_size <= 3 else [0]
        blocks.append((c.astype(np.int32), scans[trial % len(scans)]))
    ctx = init_context_states(1, 30)
    bw = BitWriter()
    enc = CabacEncoder(bw, ctx.copy())
    for c, scan in blocks:
        r_syntax.encode_residual(enc, c, log2_size, c_idx, scan,
                                 sign_hiding=sign_hiding)
        enc.encode_bin(5, int(c[0, 0] & 1))
        enc.encode_bypass(int(c[0, 0] < 0))
    enc.encode_terminate(1)
    bw.rbsp_trailing_bits()
    data = bw.getvalue()

    from x265_tpu.cabac.engine import CabacDecoder as RCabacDecoder
    outs = []
    for dec_cls, rd_cls, mod in ((CabacDecoder, BitReader, p_syntax),
                                 (RCabacDecoder, RBitReader, r_syntax)):
        dec = dec_cls(rd_cls(data), ctx.copy())
        got = []
        for c, scan in blocks:
            got.append(mod.decode_residual(dec, log2_size, c_idx, scan,
                                           sign_hiding=sign_hiding))
            got.append((dec.decode_bin(5), dec.decode_bypass()))
        assert dec.decode_terminate() == 1
        outs.append((got, dec.ctx.copy()))
    (pg, pctx), (rg, rctx) = outs
    assert np.array_equal(pctx, rctx) and np.array_equal(pctx, enc.ctx)
    for a, b in zip(pg, rg):
        assert np.array_equal(a, b)
    if not sign_hiding:
        for (c, _scan), got in zip(blocks, pg[::2]):
            assert np.array_equal(got, c)


def test_cabac_bins_decode():
    """A seeded script of context, bypass, Exp-Golomb and terminate bins."""
    rng = np.random.default_rng(3)
    ctx = init_context_states(2, 37)
    script = []
    for _ in range(3000):
        k = rng.integers(4)
        if k == 0:
            script.append(("ctx", int(rng.integers(len(ctx))),
                           int(rng.random() < 0.8)))
        elif k == 1:
            script.append(("ep", int(rng.integers(2))))
        elif k == 2:
            script.append(("eg", int(rng.integers(0, 300)),
                           int(rng.integers(0, 4))))
        else:
            script.append(("term", 0))
    bw = BitWriter()
    enc = CabacEncoder(bw, ctx.copy())
    for op in script:
        if op[0] == "ctx":
            enc.encode_bin(op[1], op[2])
        elif op[0] == "ep":
            enc.encode_bypass(op[1])
        elif op[0] == "eg":
            enc.encode_eg_k(op[1], op[2])
        else:
            enc.encode_terminate(0)
    enc.encode_terminate(1)
    bw.rbsp_trailing_bits()
    dec = CabacDecoder(BitReader(bw.getvalue()), ctx.copy())
    for op in script:
        if op[0] == "ctx":
            assert dec.decode_bin(op[1]) == op[2]
        elif op[0] == "ep":
            assert dec.decode_bypass() == op[1]
        elif op[0] == "eg":
            assert dec.decode_eg_k(op[2]) == op[1]
        else:
            assert dec.decode_terminate() == 0
    assert dec.decode_terminate() == 1
    assert np.array_equal(dec.ctx, enc.ctx)


def _blocky(shape, bd, seed):
    """Smooth content with per-8x8 steps and a little noise: every edge
    decision (off, weak, strong) occurs."""
    rng = np.random.default_rng(seed)
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 50 * np.sin(xx / 13.0) * np.cos(yy / 17.0)
    steps = rng.integers(-12, 13, (h // 8 + 1, w // 8 + 1))
    p = base + steps[yy // 8, xx // 8] + rng.integers(-2, 3, (h, w))
    p = np.clip(p * (1 << (bd - 8)), 0, (1 << bd) - 1)
    return p.astype(np.int16)


def _padded(plane, ph, pw):
    out = np.zeros((ph, pw), np.int32)
    out[:plane.shape[0], :plane.shape[1]] = plane
    return torch.as_tensor(out)


@pytest.mark.parametrize("name", ["ip_defaults", "b_pyramid", "main10",
                                  "odd_size"])
def test_deblock_matches_np(name):
    """The device deblock of parsed pictures (BS from their TU edges,
    motion and coefficients; per-edge QP maps under cu_qp_delta; chroma)
    against deblock_picture_np on the coded-size crop."""
    _ref, port, _took, _wf = _decoded(name)
    sps, pps, shs = _slice_headers(_stream(name), p_headers, BitReader)
    bd = sps.bit_depth_luma
    cw, ch = sps.pic_width, sps.pic_height
    assert pps.cu_qp_delta_enabled                # per-edge QP maps
    changed = 0
    for i, pic in enumerate(port.pictures):
        ps = pic.syntax
        g = ps.geom
        ph, pw = g.ctbs_h << g.log2_ctb, g.ctbs_w << g.log2_ctb
        planes = (_blocky((ch, cw), bd, i),
                  _blocky((ch // 2, cw // 2), bd, i + 10),
                  _blocky((ch // 2, cw // 2), bd, i + 20))
        for beta_off, tc_off in ((0, 0), (3, -2)):
            want = deblock_picture_np(ps, planes, pic.qp, bd, beta_off,
                                      tc_off, pps.cb_qp_offset,
                                      pps.cr_qp_offset)
            got = deblock_decoded_picture(
                ps, tuple(_padded(p, ph >> (k > 0), pw >> (k > 0))
                          for k, p in enumerate(planes)),
                pic.qp, bd, beta_off, tc_off, pps.cb_qp_offset,
                pps.cr_qp_offset)
            for k, (a, b) in enumerate(zip(want, got)):
                hh, ww = a.shape
                assert np.array_equal(b[:hh, :ww].numpy(), a), (pic.poc, k)
                changed += int((a != planes[k]).sum())
    assert changed


@pytest.mark.parametrize("bd,name", [(8, "ip_defaults"), (8, "odd_size"),
                                     (10, "main10")])
def test_sao_matches_np(bd, name):
    """The device SAO apply of a parsed picture's parameters, and of seeded
    ones covering every EO class and band position, against
    sao_apply_plane_np on the coded-size crop."""
    _ref, port, _took, _wf = _decoded(name)
    rng = np.random.default_rng(bd)
    sps = _slice_headers(_stream(name), p_headers, BitReader)[0]
    cw, ch = sps.pic_width, sps.pic_height
    ps = port.pictures[0].syntax
    g = ps.geom
    ctb = 1 << g.log2_ctb
    seeded = dataclasses.replace(ps)
    n = g.n_ctbs
    seeded.sao_type = rng.integers(0, 3, (n, 2)).astype(np.int8)
    seeded.sao_eo_class = rng.integers(0, 4, (n, 2)).astype(np.int8)
    seeded.sao_band_pos = rng.integers(0, 32, (n, 3)).astype(np.int8)
    seeded.sao_offsets = rng.integers(-7, 8, (n, 3, 4)).astype(np.int8)
    for syn in (ps, seeded):
        for c_idx, size, (hh, ww) in ((0, ctb, (ch, cw)),
                                      (1, ctb // 2, (ch // 2, cw // 2)),
                                      (2, ctb // 2, (ch // 2, cw // 2))):
            plane = _blocky((hh, ww), bd, c_idx)
            sel = 0 if c_idx == 0 else 1
            want = sao_apply_plane_np(
                plane, size,
                syn.sao_type[:, sel].reshape(g.ctbs_h, g.ctbs_w),
                syn.sao_eo_class[:, sel].reshape(g.ctbs_h, g.ctbs_w),
                syn.sao_band_pos[:, c_idx].reshape(g.ctbs_h, g.ctbs_w),
                syn.sao_offsets[:, c_idx].reshape(g.ctbs_h, g.ctbs_w, 4),
                bd)
            got = sao_apply_decoded_plane(
                _padded(plane, g.ctbs_h * size, g.ctbs_w * size), syn,
                c_idx, size, ww, hh, bd)
            assert np.array_equal(got[:hh, :ww].numpy(), want), c_idx
    assert ps.sao_type.any()


# -- robustness (the reference's tests/test_decoder_robustness.py cases) ----

def _frames(n, h=48, w=64, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 256, (h, w)).astype(np.uint8),
             rng.randint(0, 256, (h // 2, w // 2)).astype(np.uint8),
             rng.randint(0, 256, (h // 2, w // 2)).astype(np.uint8))
            for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _ippp(ref=3):
    p = Params(source_width=64, source_height=48, qp=34, bframes=0,
               decoded_picture_hash=1, log_level=0, me_range=8, ref=ref)
    return encode_sequence(_frames(4), p, device="cpu")[0]


def _both(data):
    """(reference Decoder, port Decoder) after push_bytes(data)."""
    ref = r_decoder.Decoder(check_hashes=True)
    ref.push_bytes(data)
    port = Decoder(check_hashes=True, device="cpu")
    port.push_bytes(data)
    return ref, port


def test_missing_reference_concealed():
    """Dropping the first P: later pictures conceal the missing reference
    with the reference's warning, pictures and (failing) hashes."""
    stream = _ippp()
    starts = [m.start() for m in re.finditer(b"\x00\x00\x00\x01", stream)]
    aus = [stream[a:b] for a, b in zip(starts, starts[1:] + [len(stream)])]
    vcl = [i for i, au in enumerate(aus) if (au[4] >> 1) < 32]
    broken = b"".join(au for i, au in enumerate(aus) if i != vcl[1])
    ref, port = _both(broken)
    assert port.warnings == ref.warnings
    assert "concealed" in port.warnings[0]
    assert len(port.pictures) == 3
    assert any(p.hash_ok is False for p in port.pictures)
    _same_pictures(ref.pictures, port.pictures)


@pytest.mark.parametrize("ref_count,bound", [(3, 4), (1, 2)])
def test_dpb_rps_marking(ref_count, bound):
    ref, port = _both(_ippp(ref_count))
    assert sorted(port._dpb) == sorted(ref._dpb) and len(port._dpb) <= bound
    assert all(p.hash_ok for p in port.pictures)
    _same_pictures(ref.pictures, port.pictures)


@pytest.mark.parametrize("data", [
    "truncated", b"\x00\x00\x01\x40\x01garbagegarbage" * 3],
    ids=["truncated", "garbage"])
def test_broken_input_raises_decode_error(data):
    if data == "truncated":
        data = _ippp()[:len(_ippp()) // 2]
    with pytest.raises(r_decoder.DecodeError):
        r_decoder.decode_annexb(data)
    with pytest.raises(DecodeError):
        decode_annexb(data, device="cpu")


def test_empty_input():
    assert decode_annexb(b"", device="cpu") == [] == \
        r_decoder.decode_annexb(b"")


def test_no_host_fallback(monkeypatch):
    """The decoder runs on the card unless asked for the CPU, and a failing
    device pass raises instead of running on the host."""
    if torch.cuda.is_available():
        assert Decoder().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            Decoder()
        with pytest.raises((AssertionError, RuntimeError)):
            decode_annexb(_stream("ctu32"))

    def broken(*a, **kw):
        raise RuntimeError("device pass failed")

    monkeypatch.setattr(p_decoder, "deblock_decoded_picture", broken)
    with pytest.raises(RuntimeError, match="device pass failed"):
        decode_annexb(_stream("ctu32"), device="cpu")
