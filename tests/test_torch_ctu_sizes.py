"""The CTU scan and K1 at 32x32 and 16x16 CTBs, on the CPU at 192x128
(CTB 32: 6 x 4 CTBs, 12 wavefront levels of at most 3 lanes; CTB 16:
12 x 8 CTBs, 26 levels of at most 6), decide32 where the CTB has 32x32
quads, as the pipelines run the scan (at CTB 16 there is no 32x32
candidate and no decision):

* x265_tpu_torch's plain scan against x265_tpu's jitted scan, one frame
  and two frames batched, I and P at 8 bits, P at 10 bits (CTB 32 and 16),
  and at CTB 32 with RDOQ + psy-RDOQ + noise reduction;
* K1's CUDA source built as host C++ (one thread per block) through the
  wrapper's launch path against the plain step: I and P, psy-rd on and
  off, decide32 on and off at CTB 32, batched lanes, 10 bits, and at CTB
  32 the RDOQ and noise-reduction instantiations; every launch counted at
  its CTB size.

All twelve outputs must be equal; the 192x128 planes are the same at
every CTB size, so the inputs are tests/test_torch_ctu_scan.py's, with
QPs and lambdas per CTB of the geometry."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ctu_scan import (_inputs, _nr_offsets, _scan_call,
                                 assert_scan_equal)
from x265_tpu.common.geometry import PictureGeometry as RefGeometry
from x265_tpu.encoder.ctu_scan import CtuScan as RefScan
from x265_tpu_torch.build import load_host_library
from x265_tpu_torch.common.geometry import PictureGeometry
from x265_tpu_torch.encoder import ctu_scan_cuda
from x265_tpu_torch.encoder.ctu_scan import CtuScan
from torch_threads import one_torch_thread  # noqa: F401

W, H = 192, 128
KW = dict(sign_hide=True, strong_intra_smoothing=True, psy_rd=2.0)
KW_RDOQ_NR = dict(KW, rdoq=True, noise_reduction=True, psy_rdoq=1.0)


def _x(log2, seed, bd=8):
    """``_inputs``' planes, modes and inter predictions, with QPs and
    lambdas drawn per CTB of the ``log2``-sized geometry (as ``_inputs``
    draws them: 24..39, at 10 bits 36..63)."""
    _g, x = _inputs(seed=seed, bd=bd)
    nctb = PictureGeometry(W, H, log2, 3).n_ctbs
    rng = np.random.RandomState(seed + 100)
    x["qp"] = (rng.randint(24, 40, nctb) if bd == 8
               else rng.randint(36, 64, nctb)).astype(np.int32)
    x["lam"] = (0.85 * 2.0 ** (rng.randint(24, 40 if bd == 8 else 52, nctb)
                               / 3.0 - 4.0)).astype(np.float32)
    return x


def _scan(log2, bd=8, kw=KW):
    return CtuScan(PictureGeometry(W, H, log2, 3), bit_depth=bd, **kw)


@functools.lru_cache(maxsize=None)
def _ref(log2, cfg, bd, rdnr=False):
    """The reference's jitted scan (decide32 where the CTB has quads),
    traced once per module and configuration."""
    scan = RefScan(RefGeometry(W, H, log2, 3), bit_depth=bd,
                   **(KW_RDOQ_NR if rdnr else KW))
    return jax.jit(scan.scan_fn(inter=cfg == "P", decide32=log2 >= 5))


def _port(scan, cfg, xs, nr=None):
    fn = scan.scan_fn(inter=cfg == "P", decide32=scan.t["has32"])
    return _scan_call(fn, torch, xs, cfg, nr)


# --- the plain scan against the reference's ------------------------------

SCAN_CASES = [(5, "I", 8), (5, "P", 8), (5, "P", 10), (4, "I", 8),
              (4, "P", 8), (4, "P", 10)]


@pytest.mark.parametrize("log2,cfg,bd", SCAN_CASES)
def test_scan_matches_reference(log2, cfg, bd):
    x = _x(log2, 7, bd)
    want = _scan_call(_ref(log2, cfg, bd), jnp, x, cfg, None)
    got = _port(_scan(log2, bd), cfg, x)
    assert_scan_equal(want, got)
    if log2 == 4:      # no 32x32 outputs at CTB 16
        assert got[6] is None and not np.asarray(got[9]).any()


@pytest.mark.parametrize("log2,cfg,bd", SCAN_CASES)
def test_batched_scan_matches_reference_frames(log2, cfg, bd):
    """Two frames in one batched scan equal two single-frame reference
    scans."""
    x0, x1 = _x(log2, 7, bd), _x(log2, 8, bd)
    got = _port(_scan(log2, bd), cfg, [x0, x1])
    for f, x in enumerate((x0, x1)):
        assert_scan_equal(_scan_call(_ref(log2, cfg, bd), jnp, x, cfg, None),
                          got, f)


def test_scan_matches_reference_rdoq_nr_ctb32():
    """CTB 32 with RDOQ, psy-RDOQ and noise reduction, P (intra and inter
    blocks, the TU32 trial): one frame and two batched, the NR sums
    included."""
    cfg = "P"
    x0, x1 = _x(5, 7), _x(5, 8)
    nr = _nr_offsets()
    ref = _ref(5, cfg, 8, True)
    scan = _scan(5, 8, KW_RDOQ_NR)
    w0 = _scan_call(ref, jnp, x0, cfg, nr)
    assert_scan_equal(w0, _port(scan, cfg, x0, nr))
    got = _port(scan, cfg, [x0, x1], nr)
    assert_scan_equal(w0, got, 0)
    assert_scan_equal(_scan_call(ref, jnp, x1, cfg, nr), got, 1)


# --- K1's host build against the plain step ------------------------------

@pytest.fixture
def k1_host(monkeypatch):
    """Route the scan's levels through K1's host build; yields a function
    returning the launches (all, at CTB 32, at CTB 16) made since."""
    lib = load_host_library()
    monkeypatch.setattr(
        ctu_scan_cuda, "ctu_step",
        lambda s, inter, d, carry, xs, plain: ctu_scan_cuda.launch(
            lib, s, inter, d, carry, xs))

    def counts():
        return (ctu_scan_cuda.LAUNCHES, ctu_scan_cuda.LAUNCHES_CTB32,
                ctu_scan_cuda.LAUNCHES_CTB16)
    n0 = counts()
    yield lambda: tuple(a - b for a, b in zip(counts(), n0))


def _same(a, b, where="out"):
    """Equal outputs: arrays, None, and dicts / tuples of them."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif a is None or b is None:
        assert a is None and b is None, where
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (where, a.shape, b.shape)
        assert np.array_equal(a, b), (where, int((a != b).sum()))


def _k1_vs_plain(k1_host, monkeypatch, scan, cfg, xs, decide, nr=None):
    """The scan through K1's host build equals the plain scan (one frame,
    or a list of frames batched); returns the launches made."""
    got = _scan_call(scan.scan_fn(inter=cfg == "P", decide32=decide),
                     torch, xs, cfg, nr)
    made = k1_host()
    with monkeypatch.context() as mp:
        mp.setattr(ctu_scan_cuda, "ctu_step",
                   lambda s, inter, d, carry, xl, plain: plain(carry, xl))
        want = _scan_call(scan.scan_fn(inter=cfg == "P", decide32=decide),
                          torch, xs, cfg, nr)
    _same(want, got)
    return made


def _want_counts(scan):
    n = scan.t["n_levels"]
    ctb = 1 << scan.t["geom"].log2_ctb
    return (n, n if ctb == 32 else 0, n if ctb == 16 else 0)


@pytest.mark.parametrize("cfg", ["I", "P"])
@pytest.mark.parametrize("decide,psy", [(True, 2.0), (True, 0.0),
                                        (False, 2.0)])
def test_k1_source_ctb32(k1_host, monkeypatch, cfg, decide, psy):
    """CTB 32: decide32 with and without psy-rd, and the given use32."""
    scan = _scan(5, 8, dict(KW, psy_rd=psy))
    made = _k1_vs_plain(k1_host, monkeypatch, scan, cfg, _x(5, 11), decide)
    assert made == _want_counts(scan)


@pytest.mark.parametrize("cfg", ["I", "P"])
@pytest.mark.parametrize("sign_hide", [True, False])
def test_k1_source_ctb16(k1_host, monkeypatch, cfg, sign_hide):
    scan = _scan(4, 8, dict(KW, sign_hide=sign_hide))
    made = _k1_vs_plain(k1_host, monkeypatch, scan, cfg, _x(4, 11), False)
    assert made == _want_counts(scan)


@pytest.mark.parametrize("log2", [5, 4])
@pytest.mark.parametrize("cfg", ["I", "P"])
def test_k1_source_batched_lanes(k1_host, monkeypatch, log2, cfg):
    """Two frames' lanes, one launch a level."""
    scan = _scan(log2)
    made = _k1_vs_plain(k1_host, monkeypatch, scan, cfg,
                        [_x(log2, 11), _x(log2, 12)], log2 >= 5)
    assert made == _want_counts(scan)


@pytest.mark.parametrize("log2", [5, 4])
@pytest.mark.parametrize("cfg", ["I", "P"])
def test_k1_source_10bit(k1_host, monkeypatch, log2, cfg):
    """The 10-bit instantiations, samples at 0 and 1023."""
    scan = _scan(log2, 10)
    t0 = ctu_scan_cuda.LAUNCHES_10BIT
    made = _k1_vs_plain(k1_host, monkeypatch, scan, cfg, _x(log2, 11, 10),
                        log2 >= 5)
    assert made == _want_counts(scan)
    assert ctu_scan_cuda.LAUNCHES_10BIT - t0 == made[0]


@pytest.mark.parametrize("mode", ["rdoq", "nr", "rdoq+nr"])
@pytest.mark.parametrize("cfg,frames,bd", [("I", 1, 8), ("P", 1, 8),
                                           ("P", 2, 8), ("P", 1, 10)])
def test_k1_source_rdoq_nr_ctb32(k1_host, monkeypatch, mode, cfg, frames,
                                 bd):
    """CTB 32 through the K1_RDOQ / K1_NR instantiations (psy-RDOQ 1.0,
    seeded NR offsets), one frame or two batched, 8 and 10 bits."""
    rdoq, nr = "rdoq" in mode, "nr" in mode
    scan = _scan(5, bd, dict(KW, rdoq=rdoq, noise_reduction=nr,
                             psy_rdoq=1.0 if rdoq else 0.0))
    xs = [_x(5, 11 + f, bd) for f in range(frames)]
    r0, n0 = ctu_scan_cuda.LAUNCHES_RDOQ, ctu_scan_cuda.LAUNCHES_NR
    made = _k1_vs_plain(k1_host, monkeypatch, scan, cfg,
                        xs if frames > 1 else xs[0], True,
                        _nr_offsets() if nr else None)
    assert made == _want_counts(scan)
    assert ctu_scan_cuda.LAUNCHES_RDOQ - r0 == (made[0] if rdoq else 0)
    assert ctu_scan_cuda.LAUNCHES_NR - n0 == (made[0] if nr else 0)


def test_k1_takes_every_ctb_size():
    """The wrapper refuses no CTB size; it still refuses bit depths other
    than 8 and 10 at every size, and the entry point other CTB sizes."""
    for log2 in (6, 5, 4):
        with pytest.raises(NotImplementedError):
            ctu_scan_cuda.kernel_args(_scan(log2, 12), False, True, None, {
                "cx": torch.zeros(1, dtype=torch.int32)})
    lib = load_host_library()
    assert lib.k1_ctu_step(None, 51, 1, 1, 1, 1, 8, 0, 0.0, None) == -2
    assert b"CTB size" in lib.k_error_string(-2)
