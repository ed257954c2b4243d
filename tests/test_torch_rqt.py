"""The inter RQT split candidate (``CtuScan.scan_fn(..., rqt=True)``: every
inter 16x16 slot also tries four 8x8 luma and 4x4 chroma TUs and keeps the
cheaper configuration) of x265_tpu_torch on the CPU at 192x128.

* The port's scan (inter, decide32, one frame and two frames batched)
  against x265_tpu's ``scan_fn(inter=True, decide32=True, rqt=True)`` in two
  configurations, each reference program traced once for the module:
  (a) 8 bits, psy-rd 2.0, sign hiding, ``rqt_ok`` None;
  (b) 10 bits, RDOQ + psy-RDOQ 1.0 + noise reduction with seeded offsets,
  a random ``rqt_ok`` mask.
  All twelve outputs equal, ``tu8`` and the NR sums included, with blocks
  split and blocks not.
* K1's CUDA source built as host C++ with ``K1_RQT`` against the plain
  step, both configurations, at CTB 64, 32 and 16 (one frame; two frames
  batched at CTB 64), every launch counted in ``LAUNCHES_RQT``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ctu_scan import (KW_RDOQ_NR, _inputs, _nr_offsets,
                                 assert_scan_equal)
from test_torch_ctu_sizes import _x
from x265_tpu.common.geometry import PictureGeometry as RefGeometry
from x265_tpu.encoder.ctu_scan import CtuScan as RefScan
from x265_tpu_torch.build import load_host_library
from x265_tpu_torch.common.geometry import PictureGeometry
from x265_tpu_torch.encoder import ctu_scan_cuda
from x265_tpu_torch.encoder.ctu_scan import CtuScan
from torch_threads import one_torch_thread  # noqa: F401

W, H = 192, 128
# configuration -> (bit depth, CtuScan options, NR offsets, rqt_ok mask)
CONFIGS = {
    "a": (8, dict(sign_hide=True, strong_intra_smoothing=True, psy_rd=2.0),
          False, False),
    "b": (10, KW_RDOQ_NR, True, True),
}
INTER_KEYS = ("is_inter", "ipred_y", "ipred_cb", "ipred_cr", "m32_in")


def _extras(cfg, n16):
    """The configuration's NR offsets and ``rqt_ok`` mask (None when it
    has none)."""
    _bd, _kw, nr, mask = CONFIGS[cfg]
    rq = (np.random.RandomState(4).rand(n16) < 0.6) if mask else None
    return (_nr_offsets() if nr else None), rq


def _call(fn, arr, xs, cfg):
    """``fn`` on one frame's inputs (a dict) or several (a list, stacked
    on a leading dimension), with the configuration's extras."""
    if isinstance(xs, list):
        n16 = len(xs[0]["modes"])
        nr, rq = _extras(cfg, n16)
        if rq is not None:
            rq = np.stack([rq] * len(xs))
        xs = {k: np.stack([x[k] for x in xs]) for k in xs[0]}
    else:
        nr, rq = _extras(cfg, len(xs["modes"]))
    a = {k: (jnp.asarray(v) if arr is jnp else torch.as_tensor(v))
         for k, v in xs.items()}
    kw = {k: a[k] for k in INTER_KEYS}
    if rq is not None:
        kw["rqt_ok"] = jnp.asarray(rq) if arr is jnp else torch.as_tensor(rq)
    return fn(a["oy"], a["ocb"], a["ocr"], a["modes"], a["mode32"],
              a["use32"] & False, a["qp"], a["qp"], a["qp"], lam=a["lam"],
              nr_offsets=nr, **kw)


@functools.lru_cache(maxsize=None)
def _ref_fn(cfg):
    """The reference's jitted RQT scan of a configuration, traced once."""
    bd, kw, _nr, _m = CONFIGS[cfg]
    scan = RefScan(RefGeometry(W, H, 6, 3), bit_depth=bd, **kw)
    return jax.jit(scan.scan_fn(inter=True, decide32=True, rqt=True))


@functools.lru_cache(maxsize=None)
def _ref_out(cfg, seed):
    bd = CONFIGS[cfg][0]
    return _call(_ref_fn(cfg), jnp, _inputs(seed=seed, bd=bd)[1], cfg)


def _port_scan(cfg, log2=6):
    bd, kw, _nr, _m = CONFIGS[cfg]
    return CtuScan(PictureGeometry(W, H, log2, 3), bit_depth=bd, **kw)


def _port_fn(scan):
    return scan.scan_fn(inter=True, decide32=scan.t["has32"], rqt=True)


@pytest.mark.parametrize("cfg", ["a", "b"])
def test_scan_matches_reference(cfg):
    """One frame, then two batched, each frame equal to the reference's
    scan of it."""
    bd = CONFIGS[cfg][0]
    x0, x1 = _inputs(seed=7, bd=bd)[1], _inputs(seed=8, bd=bd)[1]
    w0 = _ref_out(cfg, 7)
    fn = _port_fn(_port_scan(cfg))
    got = _call(fn, torch, x0, cfg)
    assert_scan_equal(w0, got)
    tu8 = np.asarray(w0[10])
    assert 0 < tu8.sum() < np.asarray(x0["is_inter"]).sum()
    batched = _call(fn, torch, [x0, x1], cfg)
    assert_scan_equal(w0, batched, 0)
    assert_scan_equal(_ref_out(cfg, 8), batched, 1)


def _host_k1(monkeypatch):
    lib = load_host_library()
    monkeypatch.setattr(
        ctu_scan_cuda, "ctu_step",
        lambda s, inter, d, carry, xs, plain: ctu_scan_cuda.launch(
            lib, s, inter, d, carry, xs))


@pytest.mark.parametrize("cfg", ["a", "b"])
@pytest.mark.parametrize("log2", [6, 5, 4])
def test_k1_source_matches_plain_step(monkeypatch, cfg, log2):
    """K1's host build with the split, through the wrapper's launch path,
    equals the plain step on every output (CTB 64 also over two frames'
    lanes); each launch counts as an RQT launch."""
    bd = CONFIGS[cfg][0]
    xs = [_x(log2, 11, bd), _x(log2, 12, bd)] if log2 == 6 else _x(
        log2, 11, bd)
    scan = _port_scan(cfg, log2)
    fn = _port_fn(scan)
    want = _call(fn, torch, xs, cfg)
    n0, r0 = ctu_scan_cuda.LAUNCHES, ctu_scan_cuda.LAUNCHES_RQT
    _host_k1(monkeypatch)
    got = _call(_port_fn(scan), torch, xs, cfg)
    assert ctu_scan_cuda.LAUNCHES - n0 == scan.t["n_levels"]
    assert ctu_scan_cuda.LAUNCHES_RQT - r0 == scan.t["n_levels"]
    assert np.asarray(want[10]).any()
    assert_scan_equal(want, got)
