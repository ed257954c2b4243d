"""x265_tpu_torch motion search against x265_tpu's jnp search
(``_inter_tools_builder(enc, allow_pallas=False)["me"]``), and K2's source
(built for the host) against the plain refine and, inside the port's
search, against that jnp search, on the CPU at 192x128.

The reference picture is the reference encoder's own ME-extended DPB entry
(``Encoder._extend_ref``), carried across with ``planes_to_torch``;
me_range 16 makes the quarter-res ``coarse_seeds`` stage run.  The 10-bit
cases hold the search and K2's 10-bit instantiation at Main10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import x265_tpu.encoder as ref_encoder
from bench import synthetic_frame
from x265_tpu.common.params import Params as RefParams
from x265_tpu.encoder.device_pipeline import _inter_tools_builder as ref_tools
from x265_tpu_torch import Params
from x265_tpu_torch.build import load_host_library
from x265_tpu_torch.convert import planes_to_torch
from x265_tpu_torch.encoder import device_pipeline as dp
from x265_tpu_torch.encoder import me_cuda
from x265_tpu_torch.encoder.intra_encoder import Encoder
from x265_tpu_torch.smoke_config import synthetic_frame10
from torch_threads import one_torch_thread  # noqa: F401

W, H = 192, 128


def _scene(bd=8):
    """A panned crop as the source and a noisy shifted crop as the recon
    (noise makes neighbour adoption matter); 10 bits: of
    ``synthetic_frame10`` (with its bands at 0 and 1023), noise +-32."""
    rng = np.random.RandomState(0)
    if bd == 8:
        base = synthetic_frame(W + 64, H + 64, 1)
    else:
        base = synthetic_frame10(W + 64, H + 64, 1)
    noise, dt = 8 << (bd - 8), np.uint8 if bd == 8 else np.uint16
    orig = [p[10:10 + H // s, 20:20 + W // s].copy()
            for p, s in zip(base, (1, 2, 2))]
    recon = [np.clip(p[13:13 + H // s, 25:25 + W // s].astype(np.int32)
                     + rng.randint(-noise, noise + 1, (H // s, W // s)), 0,
                     (1 << bd) - 1).astype(dt)
             for p, s in zip(base, (1, 2, 2))]
    return orig, recon


def _me_pair(subme, refine=None, bd=8):
    """The reference's jnp search and the port's (with ``refine`` in place
    of K2's wrapper when given) on the same scene."""
    kw = dict(source_width=W, source_height=H, bframes=0, me_range=16,
              subme=subme, internal_bit_depth=bd)
    er = ref_encoder.Encoder(RefParams(**kw))
    ep = Encoder(Params(**kw), device="cpu")
    assert er.me_coarse > 0          # the quarter-res seed stage runs
    orig, recon = _scene(bd)
    ref_ext = er._extend_ref(recon)              # the reference's DPB entry
    ext = planes_to_torch(ref_ext, "cpu")
    oy = orig[0].astype(np.int32)
    ob = oy.reshape(H // 16, 16, W // 16, 16).transpose(0, 2, 1, 3).reshape(
        -1, 16, 16)
    qp = 32
    want = jax.jit(ref_tools(er, allow_pallas=False)["me"])(
        jnp.asarray(oy), jnp.asarray(ref_ext[0]), jnp.asarray(ob), qp)
    real = dp.refine
    if refine is not None:
        dp.refine = refine
    try:
        got = dp._inter_tools_builder(ep)["me"](
            torch.as_tensor(oy), ext[0], torch.as_tensor(ob),
            dp.me_lambda(qp))
    finally:
        dp.refine = real
    for name, a, b in zip(("mv", "cost", "pred"), want, got):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, name
        assert np.array_equal(a, b), (name, int((a != b).sum()))


@pytest.mark.parametrize("subme", [0, 1, 2])
def test_me_matches_reference(subme):
    _me_pair(subme)


def test_me_with_host_k2_matches_reference():
    """The port's search with K2's source (host build) as its refine equals
    the reference's jnp search: ties the kernel to the reference."""
    lib = load_host_library()
    n0 = me_cuda.LAUNCHES
    _me_pair(2, lambda *a: me_cuda.launch(lib, *a))
    assert me_cuda.LAUNCHES == n0 + 1


@pytest.mark.parametrize("subme", [0, 1, 2, 3])
def test_k2_source_matches_plain_refine(subme):
    """K2's CUDA source, compiled as host C++ (one thread per block), run
    through the wrapper's launch path, equals refine_plain."""
    rng = np.random.RandomState(subme)
    B, mrq = 300, 16
    base = rng.randint(0, 256, (B, 1, 25))
    t = torch.as_tensor
    Wn = t(np.clip(base + rng.randint(-20, 21, (B, 25, 25)), 0, 255).astype(
        np.int32))
    ob = t(rng.randint(0, 256, (B, 16, 16)).astype(np.int32))
    mvi = t(rng.randint(-mrq, mrq + 1, (B, 2)).astype(np.int32))
    pmv = t((4 * rng.randint(-12, 13, (B, 2))).astype(np.int32))
    lam = dp.me_lambda(int(rng.randint(20, 45)))
    want = me_cuda.refine_plain(Wn, ob, mvi, pmv, lam, subme, mrq)
    n0 = me_cuda.LAUNCHES
    got = me_cuda.launch(load_host_library(), Wn, ob, mvi, pmv, lam, subme,
                         mrq)
    assert me_cuda.LAUNCHES == n0 + 1
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    # CPU tensors take the plain version in the public wrapper
    for a, b in zip(want, me_cuda.refine(Wn, ob, mvi, pmv, lam, subme, mrq)):
        assert torch.equal(a, b)
    assert me_cuda.LAUNCHES == n0 + 1


@pytest.mark.parametrize("subme", [0, 1, 2, 3])
@pytest.mark.parametrize("kind", ["flat", "extreme", "edge"])
def test_k2_source_edge_sets(kind, subme):
    """K2's host build equals refine_plain on chip_smoke's tie, extreme and
    range-edge sets (every candidate tied; samples 0/255; mvi at +-mrq and
    +-(mrq + 1), masked candidates and ties among them)."""
    mrq = 16
    args = chip_smoke.k2_case(kind, 300, mrq, subme, "cpu")
    want = me_cuda.refine_plain(*args, subme, mrq)
    got = me_cuda.launch(load_host_library(), *args, subme, mrq)
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    if kind == "flat":                   # every round's first candidate
        first = {0: (0, 0), 1: (-2, -2)}.get(subme, (-3, -3))
        assert (got[0] == torch.tensor(first, dtype=torch.int32)).all()


@pytest.mark.parametrize("B", [1, 7, 300])
def test_k2_source_batch_sizes(B):
    """Batch sizes that are no multiple of anything (B is the only grid
    dimension)."""
    mrq = 57
    args = chip_smoke.k2_case("random", B, mrq, B, "cpu")
    want = me_cuda.refine_plain(*args, 2, mrq)
    got = me_cuda.launch(load_host_library(), *args, 2, mrq)
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def test_k2_source_lambda_per_block():
    """Two frames' blocks in one launch, each with its frame's lambda:
    K2's host build equals refine_plain with the per-block lambda, and
    that equals refine_plain on each frame's blocks with its own scalar."""
    mrq = 57
    W, ob, mvi, pmv, _lam = chip_smoke.k2_case("random", 300, mrq, 5, "cpu")
    lams = [dp.me_lambda(27), dp.me_lambda(38)]
    lam = torch.cat([lams[0].expand(150), lams[1].expand(150)])
    want = me_cuda.refine_plain(W, ob, mvi, pmv, lam, 2, mrq)
    got = me_cuda.launch(load_host_library(), W, ob, mvi, pmv, lam, 2, mrq)
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    for f, sl in enumerate((slice(0, 150), slice(150, 300))):
        one = me_cuda.refine_plain(W[sl], ob[sl], mvi[sl], pmv[sl], lams[f],
                                   2, mrq)
        for a, b in zip(one, want):
            assert torch.equal(a, b[sl])
    # the two lambdas decide differently somewhere
    cut = me_cuda.refine_plain(W, ob, mvi, pmv, lams[0], 2, mrq)[0]
    assert not torch.equal(cut, want[0])


def test_me_matches_reference_10bit():
    """Main10: the port's search (refine_plain at 10 bits: the horizontal
    pass >> 2, the vertical >> 6, uni_round) equals the reference's jnp
    search, whose refine_round filters at ``enc.bit_depth``."""
    _me_pair(2, bd=10)


def test_me_with_host_k2_matches_reference_10bit():
    """Main10: the port's search with K2's 10-bit instantiation (host
    build) equals the reference's jnp search."""
    lib = load_host_library()
    n0, t0 = me_cuda.LAUNCHES, me_cuda.LAUNCHES_10BIT
    _me_pair(2, lambda *a: me_cuda.launch(lib, *a), bd=10)
    assert (me_cuda.LAUNCHES, me_cuda.LAUNCHES_10BIT) == (n0 + 1, t0 + 1)


@pytest.mark.parametrize("subme", [0, 1, 2, 3])
@pytest.mark.parametrize("kind", ["random", "flat", "extreme", "edge"])
def test_k2_source_sets_10bit(kind, subme):
    """K2's 10-bit host build equals refine_plain at 10 bits on
    chip_smoke's sets with 10-bit samples (random; flat: every candidate
    tied; extreme: samples 0 / 1023; range edge)."""
    mrq = 16
    args = chip_smoke.k2_case(kind, 300, mrq, subme, "cpu", bd=10)
    want = me_cuda.refine_plain(*args, subme, mrq, 10)
    got = me_cuda.launch(load_host_library(), *args, subme, mrq, 10)
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    if kind == "extreme":        # the 10-bit clip is reached both ways
        assert got[1].max() == 1023 and got[1].min() == 0


def test_k2_refuses_other_bit_depths():
    args = chip_smoke.k2_case("random", 4, 16, 0, "cpu")
    with pytest.raises(NotImplementedError):
        me_cuda.launch(load_host_library(), *args, 2, 16, 12)
