"""RDOQ, psy-RDOQ and DCT-domain noise reduction of x265_tpu_torch on the
CPU, against x265_tpu (jnp) and, for K1, against the port's plain step.

* The float tables (lambda2 / lambda_sad per QP 0..63, the rate term per
  level 0..32767) equal XLA's values over their whole range.
* ``_rdoq_core`` equals the reference's at n = 4, 8, 16, 32, bit depths 8
  and 10, psy-RDOQ off and on, with a QP per block over 0..51 (0..63 at
  10 bits) and with scalar QPs; a block whose DC level is 8192 (the rate
  table's odd entry) is among the inputs.
* Twins of tests/test_rdoq.py's bound and RD tests and of
  tests/test_psy.py's psy-RDOQ test on the port's ops.
* The scan (P, one frame and two batched) with RDOQ + psy-RDOQ and noise
  reduction together equals the reference's ``CtuScan``, the NR sums
  included (I and Main10 in tests/test_torch_ctu_scan.py).
* K1's source built as host C++ equals the plain step with RDOQ and with
  noise reduction (I and P, one and two frames, 8 and 10 bits), counted
  apart in ``ctu_scan_cuda``; CPU tensors take the plain step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ctu_scan import (KW_RDOQ_NR, NAMES, _inputs, _nr_offsets,
                                 _ref_scan_rdoq_nr, _scan_call,
                                 assert_scan_equal)
from x265_tpu.ops import quantize as r_quant
from x265_tpu.ops.transforms import forward_transform as r_forward
from x265_tpu_torch.build import load_host_library
from x265_tpu_torch.common.rdcost import level_bits
from x265_tpu_torch.encoder import ctu_scan_cuda
from x265_tpu_torch.encoder.ctu_scan import CtuScan
from x265_tpu_torch.ops import quantize as p_quant
from x265_tpu_torch.ops.transforms import forward_transform, inverse_transform
from x265_tpu_torch.smoke_config import plant_level_8192
from torch_threads import one_torch_thread  # noqa: F401


def test_lambda_table_equals_jnp():
    qp = jnp.arange(64, dtype=jnp.int32)
    scale = 0.85 * r_quant._RDOQ_RATE_SCALE

    @jax.jit
    def lambdas(q):
        lam2 = scale * jnp.exp2((q.astype(jnp.float32) - 12.0) / 3.0)
        return lam2, jnp.sqrt(lam2 / scale)

    lam2, lam_sad = (np.asarray(v) for v in lambdas(qp))
    tab = p_quant.rdoq_lambda_table()
    assert tab.dtype == np.float32 and tab.shape == (64, 2)
    assert np.array_equal(tab[:, 0], lam2)
    assert np.array_equal(tab[:, 1], lam_sad)


def test_rate_table_equals_jnp():
    @jax.jit
    def rate(c):
        lf = c.astype(jnp.float32)
        return jnp.where(c > 0, 3.0 + 2.0 * jnp.floor(
            jnp.log2(jnp.maximum(lf, 1.0))), 0.0)

    want = np.asarray(rate(jnp.arange(32768, dtype=jnp.int32)))
    tab = p_quant.rdoq_rate_table()
    assert tab.dtype == np.float32 and np.array_equal(tab, want)
    # XLA's log2(8192) rounds below 13: the level's rate is 27, not 29
    assert tab[8192] == 27.0 and tab[8191] == 27.0 and tab[8193] == 29.0


@functools.lru_cache(maxsize=None)
def _ref_rdoq(bd, psy):
    return jax.jit(lambda c, q: r_quant._rdoq_core(jnp, c, q, bd,
                                                   psy_scale=psy))


def _coefs(rng, b, n, bd):
    """Transform coefficients of mixed residuals: noise, smooth ramps and
    sparse blocks (the last half zero)."""
    hi = (1 << bd) - 1
    x = np.concatenate([
        rng.randint(-hi, hi + 1, (b // 3, n, n)),
        np.cumsum(rng.normal(0, 6 << (bd - 8), (b // 3, n, n)), axis=2),
        rng.normal(0, 20 << (bd - 8), (b - 2 * (b // 3), n, n))
        * (rng.rand(b - 2 * (b // 3), 1, 1) < 0.5)])
    x = np.clip(x, -hi, hi).astype(np.int32)
    return np.array(r_forward(jnp.asarray(x), bd, dst=False), np.int32)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("psy", [0.0, 1.0])
def test_rdoq_core_matches_reference(n, bd, psy):
    rng = np.random.RandomState(n * 10 + bd + int(psy))
    top = 51 + 6 * (bd - 8)
    coef = _coefs(rng, 192, n, bd)
    qp = np.concatenate([np.arange(top + 1),
                         rng.randint(0, top + 1, 192 - top - 1)])
    qp = qp.astype(np.int32)
    if n == 32:
        # a flat block whose DC coefficient 20480 quantizes to 8192 at the
        # QP whose scale is 26214 with qbits 16
        coef[0] = 0
        coef[0, 0, 0] = 20480
        qp[0] = 6 * (bd - 8)
    want = np.asarray(_ref_rdoq(bd, psy)(jnp.asarray(coef), jnp.asarray(qp)))
    got = p_quant._rdoq_core(torch.as_tensor(coef), torch.as_tensor(qp), bd,
                             psy).numpy()
    assert np.array_equal(want, got)
    if n == 32:
        assert want[0, 0, 0] == 8192
    # scalar QPs: one block batch per QP
    for q in (0, 22, 37, top):
        w = np.asarray(_ref_rdoq(bd, psy)(jnp.asarray(coef[:48]),
                                          jnp.int32(q)))
        g = p_quant._rdoq_core(torch.as_tensor(coef[:48]), q, bd,
                               psy).numpy()
        assert np.array_equal(w, g), q


def test_rdoq_refuses_qps_outside_the_table():
    coef = torch.zeros((1, 8, 8), dtype=torch.int32)
    with pytest.raises(AssertionError):
        p_quant._rdoq_core(coef, 64, 10)


def _smooth_coefs(seed, b, sigma):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.normal(0, sigma, (b, 16, 16)), axis=2).astype(np.int32)
    return torch.as_tensor(x), forward_transform(torch.as_tensor(x), 8)


def test_rdoq_levels_bounded_by_nearest():
    """Twin of tests/test_rdoq.py: RDOQ may only lower magnitudes vs the
    deadzone quantizer (at most one above it), never invert a sign."""
    _x, coef = _smooth_coefs(2, 16, 6)
    for qp in (22, 32, 42):
        lr = p_quant.rdoq(coef, qp, 8)
        lq = p_quant.quant(coef, qp, 8, intra=True)
        assert bool((lr.abs() <= lq.abs() + 1).all())
        assert bool(((lr == 0) | (lr.sign() == coef.sign())).all())


def test_rdoq_improves_rd_on_smooth_blocks():
    """Twin of tests/test_rdoq.py: the rate-damped RD objective of RDOQ's
    levels beats the deadzone quantizer's."""
    x, coef = _smooth_coefs(3, 64, 4)
    qp = 32

    def rd(lv):
        rec = inverse_transform(p_quant.dequant(lv, qp, 8), 8)
        ssd = float(((rec - x).double() ** 2).sum())
        bits = float(level_bits(lv).double().sum())
        lam = 0.85 * (2.0 ** (qp / 6.0 - 2.0)) ** 2
        return ssd + lam * p_quant._RDOQ_RATE_SCALE * bits

    assert rd(p_quant.rdoq(coef, qp, 8)) <= rd(p_quant.quant(coef, qp, 8))


def test_psy_rdoq_retains_ac_energy():
    """Twin of tests/test_psy.py: psy-RDOQ keeps marginal AC coefficients
    that plain RDOQ zeroes, and leaves DC alone."""
    rng = np.random.default_rng(11)
    coef = torch.as_tensor(rng.integers(-2200, 2200, (4, 16, 16)).astype(
        np.int32))
    qp = torch.full((4,), 37, dtype=torch.int32)
    base = p_quant._rdoq_core(coef, qp, 8)
    psy = p_quant._rdoq_core(coef, qp, 8, psy_scale=5.0)
    assert int((psy != 0).sum()) > int((base != 0).sum())
    assert torch.equal(base[:, 0, 0], psy[:, 0, 0])


def test_scan_matches_reference_rdoq_nr():
    """P, 8 bits, RDOQ + psy-RDOQ + noise reduction: one frame, then two
    frames in one batched scan, each equal to the reference's scan of it
    (the batched NR sums per frame)."""
    g, x0 = _inputs(seed=7)
    _g, x1 = _inputs(seed=8)
    nr = _nr_offsets()
    ref = _ref_scan_rdoq_nr(g.width, g.height, "P", 8)
    scan = CtuScan(g, bit_depth=8, **KW_RDOQ_NR)
    fn = scan.scan_fn(inter=True, decide32=True)
    w0 = _scan_call(ref, jnp, x0, "P", nr)
    assert_scan_equal(w0, _scan_call(fn, torch, x0, "P", nr))
    got = _scan_call(fn, torch, [x0, x1], "P", nr)
    assert_scan_equal(w0, got, 0)
    assert_scan_equal(_scan_call(ref, jnp, x1, "P", nr), got, 1)


def _k1_case(cfg, bd, mode, frames):
    g, x = _inputs(seed=11, bd=bd)
    if mode == "rdoq" and cfg == "P":
        plant_level_8192(x, 0, 0, g.ctbs_w, bd)
    xs = [x] + [_inputs(seed=12 + f, bd=bd)[1] for f in range(frames - 1)]
    scan = CtuScan(g, bit_depth=bd, sign_hide=True,
                   strong_intra_smoothing=True, psy_rd=2.0,
                   rdoq=mode == "rdoq", noise_reduction=mode == "nr",
                   psy_rdoq=1.0)
    return scan, xs if frames > 1 else x


@pytest.mark.parametrize("mode", ["rdoq", "nr"])
@pytest.mark.parametrize("cfg,bd,frames", [("I", 8, 1), ("P", 8, 1),
                                           ("P", 8, 2), ("I", 10, 2),
                                           ("P", 10, 1)])
def test_k1_source_matches_plain_step(monkeypatch, mode, cfg, bd, frames):
    """K1's host build, level by level through the wrapper's launch path,
    equals the plain step with RDOQ (psy-RDOQ 1.0; in P at 8 and 10 bits a
    TU32 trial codes a level of 8192) or noise reduction; the launches
    count as RDOQ / NR launches."""
    lib = load_host_library()
    scan, xs = _k1_case(cfg, bd, mode, frames)
    nr = _nr_offsets() if mode == "nr" else None
    fn = scan.scan_fn(inter=cfg == "P", decide32=True)
    n0 = ctu_scan_cuda.LAUNCHES
    want = _scan_call(fn, torch, xs, cfg, nr)
    assert ctu_scan_cuda.LAUNCHES == n0        # CPU tensors: plain step
    if mode == "rdoq" and cfg == "P" and frames == 1:
        assert int((want[6].abs() == 8192).sum()) > 0
    counts = (ctu_scan_cuda.LAUNCHES_RDOQ, ctu_scan_cuda.LAUNCHES_NR)
    monkeypatch.setattr(
        ctu_scan_cuda, "ctu_step",
        lambda s, inter, d, carry, x, plain: ctu_scan_cuda.launch(
            lib, s, inter, d, carry, x))
    # scan_fn binds ctu_step when it is called
    got = _scan_call(scan.scan_fn(inter=cfg == "P", decide32=True), torch,
                     xs, cfg, nr)
    nl = scan.t["n_levels"]
    assert ctu_scan_cuda.LAUNCHES - n0 == nl
    assert (ctu_scan_cuda.LAUNCHES_RDOQ - counts[0],
            ctu_scan_cuda.LAUNCHES_NR - counts[1]) == (
        (nl, 0) if mode == "rdoq" else (0, nl))
    for i, (a, b) in enumerate(zip(want[:11], got[:11])):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b), (NAMES[i], int((a != b).sum()))
    if mode == "nr":
        for cat in want[11]:
            for a, b in zip(want[11][cat], got[11][cat]):
                assert torch.equal(a, b), cat
    else:
        assert want[11] is None and got[11] is None
