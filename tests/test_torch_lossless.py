"""Lossless (transquant bypass) on the port against x265_tpu: the native
serializer's ``cu_transquant_bypass_flag`` against the reference's Python
``CtuCoder`` on the same lossless picture syntax (raw residuals over the
whole sample range, 8 and 10 bits); the open-loop mode decision; and
lossless streams of random content through ``encode_sequence`` at 8 and
10 bits and at CTU 32, byte-identical to the reference's, with recons
equal to the source and matching hashes in the reference's decoder."""

import numpy as np
import pytest

import x265_tpu.encoder as ref_encoder
from x265_tpu.cabac.ctu import CtuCoder
from x265_tpu.cabac.ctu import PicSyntax as RefPicSyntax
from x265_tpu.cabac.engine import CabacEncoder
from x265_tpu.cabac.tables import init_context_states
from x265_tpu.common.geometry import PictureGeometry as RefGeometry
from x265_tpu.common.headers import SLICE_I
from x265_tpu.common.params import Params as RefParams
from x265_tpu.decoder import decode_annexb
from x265_tpu_torch import Params
from x265_tpu_torch.cabac.ctu import PicSyntax
from x265_tpu_torch.common.geometry import PictureGeometry
from x265_tpu_torch.encoder import encode_sequence
from x265_tpu_torch.encoder.intra_encoder import Encoder
from x265_tpu_torch.native import encode_slice_data_native
from torch_threads import one_torch_thread  # noqa: F401

W, H = 64, 48


def _syntax(cls, geom_cls, log2_ctb):
    g = geom_cls(W, H, log2_ctb, 3)
    ps = cls(g, max_tr_depth_intra=0, max_tr_depth_inter=2,
             sign_hiding=False, slice_qp=30)
    return g, ps


def _fill(ps, log2_ctb, bd, rng):
    """A lossless I picture's syntax: 16x16 intra CUs (one 32x32 CU in
    the first CTB), random modes, random bypass flags, and raw residuals
    over +-(2^bd - 1) with zeros, both extremes planted in every plane."""
    h4, w4 = ps.depth.shape
    ps.depth[:] = log2_ctb - 4
    ps.depth[:8, :8] = log2_ctb - 5
    ps.tu_depth[:] = 0
    modes = rng.randint(0, 35, (h4 // 4, w4 // 4)).astype(np.uint8)
    modes[:2, :2] = modes[0, 0]
    ps.luma_mode[:] = np.kron(modes, np.ones((4, 4), np.uint8))
    ps.chroma_mode[:] = ps.luma_mode
    flags = rng.randint(0, 2, (h4 // 4, w4 // 4)).astype(np.uint8)
    flags[:2, :2] = flags[0, 0]
    ps.tq_bypass[:] = np.kron(flags, np.ones((4, 4), np.uint8))
    top = (1 << bd) - 1
    for plane in (ps.coeff_y, ps.coeff_cb, ps.coeff_cr):
        v = rng.randint(-top, top + 1, plane.shape)
        v[rng.rand(*plane.shape) < 0.3] = 0
        v[0, 0], v[-1, -1] = top, -top
        plane[:] = v


@pytest.mark.parametrize("bd", [8, 10])
def test_bypass_serializer_matches_python_ctucoder(bd):
    """The port's native slice encoder with transquant_bypass writes the
    bytes of the reference's Python CtuCoder on the same syntax."""
    rng = np.random.RandomState(bd)
    log2_ctb = 6
    g_ref, ps_ref = _syntax(RefPicSyntax, RefGeometry, log2_ctb)
    _g, ps = _syntax(PicSyntax, PictureGeometry, log2_ctb)
    _fill(ps, log2_ctb, bd, rng)
    for name in ("depth", "tu_depth", "luma_mode", "chroma_mode",
                 "tq_bypass", "coeff_y", "coeff_cb", "coeff_cr"):
        getattr(ps_ref, name)[:] = getattr(ps, name)
    ctx = init_context_states(0, 30)
    enc = CabacEncoder(ctx=ctx)
    coder = CtuCoder(ps_ref, 3, 2, 5, slice_type=SLICE_I, sao_luma=False,
                     sao_chroma=False, bit_depth=bd, num_ref_l0=1,
                     num_ref_l1=1, transquant_bypass=True)
    for ctu in range(g_ref.n_ctbs):
        coder.encode_ctu(enc, ctu)
        enc.encode_terminate(1 if ctu == g_ref.n_ctbs - 1 else 0)
    enc.bw.byte_alignment()
    want = enc.bw.getvalue()
    got = encode_slice_data_native(ps, 30, log2_min_cb=3, log2_min_tb=2,
                                   log2_max_tb=5, bit_depth=bd,
                                   transquant_bypass=True)
    assert got == want
    # the flag is what differs from the same syntax without bypass
    assert encode_slice_data_native(ps, 30, bit_depth=bd) != got


def _frames(bd, n=2, seed=5):
    rng = np.random.RandomState(seed)
    dt = np.uint8 if bd == 8 else np.uint16
    top = 1 << bd
    return [tuple(rng.randint(0, top, s).astype(dt)
                  for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2)))
            for _ in range(n)]


def _kw(bd, ctu):
    return dict(source_width=W, source_height=H, lossless=True,
                internal_bit_depth=bd, ctu_size=ctu, b_adapt=0, me_range=8,
                decoded_picture_hash=1, log_level=0)


@pytest.mark.parametrize("bd", [8, 10])
def test_decide_modes_matches_reference(bd):
    """The open-loop 35-mode SATD decision over original neighbours."""
    orig = _frames(bd, 1)[0]
    ref = ref_encoder.Encoder(RefParams(**_kw(bd, 64)))
    enc = Encoder(Params(**_kw(bd, 64)), device="cpu")
    pad = [np.pad(p, ((0, s - p.shape[0]), (0, t - p.shape[1])), "edge")
           for p, s, t in zip(orig, (64, 32, 32), (64, 32, 32))]
    want = ref._decide_modes(pad)
    got = enc._decide_modes(pad)
    assert got[0] == want[0]
    assert np.array_equal(got[1], np.asarray(want[1]))


@pytest.mark.parametrize("bd,ctu", [(8, 64), (10, 64), (8, 32)])
def test_lossless_stream_matches_reference(bd, ctu, monkeypatch):
    frames = _frames(bd)
    want, _ = ref_encoder.encode_sequence(frames, RefParams(**_kw(bd, ctu)))

    def no_device_pipeline(*_a, **_k):
        raise AssertionError("lossless ran a device pipeline")
    # all-intra without the scan or the search: no pipeline is dispatched
    for name in ("_dispatch_i", "_dispatch_p", "_get_ctu_scan"):
        monkeypatch.setattr(Encoder, name, no_device_pipeline)
    got, recons = encode_sequence(frames, Params(**_kw(bd, ctu)),
                                  device="cpu")
    assert got == want
    for fr, rec in zip(frames, recons):
        for a, b in zip(fr, rec):
            assert b.dtype == a.dtype and np.array_equal(a, b)
    pics = decode_annexb(got)
    assert len(pics) == len(frames)
    for fr, pic in zip(frames, pics):
        assert pic.hash_ok
        for a, b in zip(fr, pic.planes):
            assert np.array_equal(a, np.asarray(b, a.dtype))
