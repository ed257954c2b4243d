"""x265_tpu_torch's WavefrontIntraRecon against x265_tpu's on the CPU.

The inputs are those of tests/test_wavefront.py (a random 128x96 luma
plane at QP 12 / 30 / 47, an 8x8 chroma plane), with seeded modes in
place of the encoder's decisions: encode and decode, 8 and 10 bits,
sign hiding, the inter override of ``scan_fn(inter=True)`` and the paired
Cb + Cr scan.  Every output is np.array_equal to the reference's.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x265_tpu.encoder import wavefront as ref_wf
from x265_tpu_torch._util import to_host_samples
from x265_tpu_torch.encoder import wavefront as wf
from torch_threads import one_torch_thread  # noqa: F401

W, H = 128, 96


def _blocks(pl, n):
    ph, pw = pl.shape
    return np.ascontiguousarray(pl.astype(np.int32).reshape(
        ph // n, n, pw // n, n).transpose(0, 2, 1, 3).reshape(-1, n, n))


def _inputs(seed, n, bd, chroma):
    """Seeded [B, n, n] original blocks, modes, an inter prediction and
    inter mask for the luma plane (or, ``chroma``, the 4:2:0 chroma
    plane) of a WxH picture at bit depth ``bd``, padded to whole 64x64
    CTBs (the rows below the picture are not coded)."""
    rng = np.random.RandomState(seed)
    ph, pw = -(-H // 64) * 64, -(-W // 64) * 64
    if chroma:
        ph, pw = ph // 2, pw // 2
    nb = (ph // n) * (pw // n)
    hi = 1 << bd
    return dict(data=_blocks(rng.randint(0, hi, (ph, pw)), n),
                modes=rng.randint(0, 35, nb).astype(np.int32),
                ipred=rng.randint(0, hi, (nb, n, n)).astype(np.int32),
                is_inter=rng.rand(nb) < 0.5,
                data2=_blocks(rng.randint(0, hi, (ph, pw)), n),
                ipred2=rng.randint(0, hi, (nb, n, n)).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _ref_fn(n, chroma, bd, sign_hide, encode, inter, paired):
    """The reference's jitted scan, shared by the cases of the file."""
    import jax
    r = ref_wf.WavefrontIntraRecon(W, H, 6, n, is_luma=not chroma,
                                   chroma_shift=int(chroma), bit_depth=bd,
                                   sign_hide=sign_hide)
    make = r.paired_scan_fn if paired else r.scan_fn
    return jax.jit(make(encode=encode, inter=inter))


def _port(n, chroma, bd, sign_hide):
    return wf.WavefrontIntraRecon(W, H, 6, n, is_luma=not chroma,
                                  chroma_shift=int(chroma), bit_depth=bd,
                                  sign_hide=sign_hide, device="cpu")


def _eq(ref, got):
    ref = np.asarray(ref)
    got = to_host_samples(got) if got.dtype == torch.int16 and \
        ref.dtype == np.uint16 else got.numpy()
    assert ref.dtype == got.dtype, (ref.dtype, got.dtype)
    assert ref.shape == got.shape
    assert np.array_equal(ref, got), int((ref != got).sum())


@pytest.mark.parametrize("n,chroma,bd,qp,sign_hide,inter", [
    (16, False, 8, 12, False, False),
    (16, False, 8, 30, False, False),
    (16, False, 8, 47, False, False),
    (16, False, 8, 30, True, False),
    (16, False, 8, 30, False, True),
    (4, False, 8, 30, True, False),
    (8, True, 8, 26, False, False),
    (8, True, 8, 26, True, True),
    (16, False, 10, 42, True, False),
    (8, True, 10, 38, False, True),
])
def test_wavefront_encode_decode(n, chroma, bd, qp, sign_hide, inter):
    """``scan_fn`` encoding (plane and levels), then decoding the levels,
    each equal to the reference's; the decoded plane equals the encoded
    one."""
    x = _inputs(qp + n, n, bd, chroma)
    extra = (x["ipred"], x["is_inter"]) if inter else ()
    want_plane, want_lv = _ref_fn(n, chroma, bd, sign_hide, True, inter,
                                  False)(jnp.asarray(x["data"]),
                                         jnp.asarray(x["modes"]), qp,
                                         *map(jnp.asarray, extra))
    p = _port(n, chroma, bd, sign_hide)
    plane, lv = p.scan_fn(encode=True, inter=inter)(
        x["data"], x["modes"], qp, *extra)
    _eq(want_plane, plane)
    _eq(want_lv, lv)
    assert int((lv != 0).sum()) > 0
    want_dec = _ref_fn(n, chroma, bd, sign_hide, False, inter, False)(
        want_lv, jnp.asarray(x["modes"]), qp, *map(jnp.asarray, extra))
    dec = p.scan_fn(encode=False, inter=inter)(lv, x["modes"], qp, *extra)
    _eq(want_dec, dec)
    assert torch.equal(dec, plane)


@pytest.mark.parametrize("inter", [False, True])
def test_wavefront_paired(inter):
    """The paired Cb + Cr scan (two QPs), encoding then decoding."""
    n, bd, qps = 8, 8, (27, 29)
    x = _inputs(5, n, bd, True)
    extra = (((x["ipred"], x["ipred2"]), x["is_inter"]) if inter else ())
    jextra = (((jnp.asarray(x["ipred"]), jnp.asarray(x["ipred2"])),
               jnp.asarray(x["is_inter"])) if inter else ())
    datas = (x["data"], x["data2"])
    want = _ref_fn(n, True, bd, True, True, inter, True)(
        tuple(map(jnp.asarray, datas)), jnp.asarray(x["modes"]), qps,
        *jextra)
    p = _port(n, True, bd, True)
    got = p.paired_scan_fn(encode=True, inter=inter)(datas, x["modes"], qps,
                                                     *extra)
    for (wp, wl), (gp, gl) in zip(want, got):
        _eq(wp, gp)
        _eq(wl, gl)
    want_dec = _ref_fn(n, True, bd, True, False, inter, True)(
        (want[0][1], want[1][1]), jnp.asarray(x["modes"]), qps, *jextra)
    dec = p.paired_scan_fn(encode=False, inter=inter)(
        (got[0][1], got[1][1]), x["modes"], qps, *extra)
    for wd, gd, (gp, _gl) in zip(want_dec, dec, got):
        _eq(wd, gd)
        assert torch.equal(gd, gp)


def test_wavefront_encode_decode_methods():
    """``encode`` / ``decode`` and the schedule's tables at 64x64, the
    reference test's luma size."""
    rng = np.random.RandomState(30)
    y = rng.randint(0, 256, (64, 64))
    blocks = _blocks(y, 16)
    modes = rng.randint(0, 35, 16).astype(np.int32)
    r = ref_wf.WavefrontIntraRecon(64, 64, 6, 16, is_luma=True)
    p = wf.WavefrontIntraRecon(64, 64, 6, 16, is_luma=True, device="cpu")
    for k in ("lvl_blk", "ref_idx", "ref_avail", "sct_idx", "host_mask"):
        assert np.array_equal(r.sched[k], p.sched[k]), k
    want_plane, want_lv = r.encode(blocks, modes, 30)
    plane, lv = p.encode(blocks, modes, 30)
    _eq(want_plane, plane)
    _eq(want_lv, lv)
    _eq(r.decode(want_lv, modes, 30), p.decode(lv, modes, 30))
