"""The frozen yardstick equals ``chip_smoke``'s bounds where both apply,
and counts K2's candidates by subme."""

import pytest
import torch

import chip_smoke
from perfbench import yardstick


@pytest.mark.parametrize("kind", ["random", "flat", "extreme", "edge"])
@pytest.mark.parametrize("bd", [8, 10])
def test_k2_bound_equals_chip_smoke(kind, bd):
    from x265_tpu_torch.encoder import me_cuda
    W, ob, mvi, pmv, lam = chip_smoke.k2_case(kind, 256, 57, 5, "cpu", bd)
    outs = me_cuda.refine_plain(W, ob, mvi, pmv, lam, 2, 57, bd)
    assert yardstick.k2_bound(W, ob, mvi, pmv, outs, lam, 57, bd,
                              subme=2) == chip_smoke.k2_bound(
        W, ob, mvi, pmv, outs, lam, 57, bd)


def test_half_pel_winner_is_the_plain_refines():
    from x265_tpu_torch.encoder import me_cuda
    W, ob, mvi, pmv, lam = chip_smoke.k2_case("random", 256, 57, 9, "cpu")
    lam_b = torch.full((256,), float(lam)) * torch.linspace(0.5, 2, 256)
    for lm in (lam, lam_b):
        q1 = me_cuda.refine_plain(W, ob, mvi, pmv, lm, 1, 57)[0]
        assert torch.equal(yardstick.half_pel_winner(W, ob, mvi, pmv, lm, 57),
                           q1)


def test_k2_bound_by_subme():
    from x265_tpu_torch.encoder import me_cuda
    W, ob, mvi, pmv, lam = chip_smoke.k2_case("random", 256, 57, 2, "cpu")
    outs = me_cuda.refine_plain(W, ob, mvi, pmv, lam, 2, 57)
    rec = yardstick.k2_launch_record(W, ob, mvi, pmv, lam, outs, 0, 57, 8)
    b0 = yardstick.k2_record_bound(rec)
    # subme 0: one full-pel candidate, 256 + 16 x 96 adds a block
    ops = 256 * (256 + 16 * 96)
    nbytes = yardstick._nbytes([W, ob, mvi, pmv] + list(outs))
    want = max(nbytes / yardstick.HBM_BYTES_PER_S,
               ops / yardstick.INT32_OPS_PER_S) * 1e3
    assert b0[0] == pytest.approx(want, rel=1e-12)
    b1 = yardstick.k2_bound(W, ob, mvi, pmv, outs, lam, 57, subme=1)
    b2 = yardstick.k2_bound(W, ob, mvi, pmv, outs, lam, 57, subme=2)
    assert b0[0] <= b1[0] <= b2[0]


def _k1_levels(preset, **kw):
    """(xs, ys, inter, scan) of every level of a tiny encode's CTU scans on
    the CPU (I and P pictures)."""
    import numpy as np
    from x265_tpu_torch.common.params import default_params
    from x265_tpu_torch.encoder import ctu_scan_cuda
    from x265_tpu_torch.encoder.intra_encoder import Encoder
    got = []
    real = ctu_scan_cuda.ctu_step

    def spy(scan, inter, decide32, carry, xs, plain):
        carry, ys = real(scan, inter, decide32, carry, xs, plain)
        got.append((xs, ys, inter, scan))
        return carry, ys
    ctu_scan_cuda.ctu_step = spy
    try:
        p = default_params(preset, source_width=128, source_height=64,
                           bframes=0, rc_lookahead=0, qp=30, **kw)
        enc = Encoder(p, device="cpu")
        rng = np.random.RandomState(3)
        base = rng.randint(0, 256, (64, 160)).astype(np.uint8)
        for t in range(2):
            y = np.ascontiguousarray(base[:, 8 * t:8 * t + 128])
            enc.encode_frame((y, np.full((32, 64), 128, np.uint8),
                              np.full((32, 64), 120, np.uint8)))
    finally:
        ctu_scan_cuda.ctu_step = real
    return got


@pytest.mark.parametrize("preset,kw", [("medium", {}),
                                       ("ultrafast", {}),
                                       ("slow", {}),
                                       ("medium", dict(
                                           noise_reduction_intra=400,
                                           noise_reduction_inter=400))])
def test_k1_bound_equals_chip_smoke(preset, kw):
    levels = _k1_levels(preset, **kw)
    assert any(inter for _, _, inter, _ in levels)
    for xs, ys, inter, scan in levels:
        assert yardstick.k1_level_bound(xs, ys, inter, scan) == \
            chip_smoke.k1_level_bound(xs, ys, inter, scan)
