"""GOP-parallel encoding on the port (``x265_tpu_torch.parallel``) on the
CPU.

* The batched I and P pipelines (``batch=3``, 96x64, AQ 2, weightp, 3
  reference slots): each frame with its own references, weights and QPs,
  every output np.array_equal to the unbatched pipeline's on that frame.
* The motion search with one reference plane per frame ([F, H, W])
  against F single-frame searches.
* K1's CUDA source built as host C++ over the lanes of 8 frames (a
  GOP-parallel round's F), one launch a level, against the plain step.
* CQP, tests/test_multichip.py's frames and parameters at keyint 2, four
  GOPs: the stream byte-identical to x265_tpu's sequential
  ``encode_sequence`` (which test_multichip.py holds the reference's own
  GOP-parallel stream to), decoding with matching hashes in x265_tpu's
  decoder; the same over two shards (``devices=["cpu", "cpu"]``, each on
  its own host thread), against the same reference stream.
* A shard that raises makes ``encode`` raise; threads launching K1's host
  build side by side count every launch.
* ABR, three GOPs of three frames at 64x48 (test_multichip.py's ABR
  case): each GOP's stream equal to the port's sequential Encoder on that
  GOP alone.
* The refusals: B frames, GOPs of unequal length, a frame count that does
  not split, GOPs that do not split over the devices.
"""

import dataclasses
import functools
import os
import sys
import threading

import numpy as np
import pytest
import torch

from x265_tpu.common.params import Params as RefParams
from x265_tpu.decoder import decode_annexb
from x265_tpu.encoder import encode_sequence as ref_encode_sequence
from x265_tpu_torch import Params
from x265_tpu_torch._util import to_device
from x265_tpu_torch.build import load_host_library
from x265_tpu_torch.common.params import RC_ABR
from x265_tpu_torch.encoder import ctu_scan_cuda
from x265_tpu_torch.encoder import device_pipeline as dp
from x265_tpu_torch.encoder.ctu_scan import CtuScan
from x265_tpu_torch.encoder.intra_encoder import Encoder, pad_plane
from x265_tpu_torch.parallel import GopParallelEncoder, encode_gop_parallel
from x265_tpu_torch.smoke_config import synthetic_frame
from torch_threads import one_torch_thread  # noqa: F401

W, H, G = 96, 64, 3


def _mc_frames(n, w=96, h=64, seed=3):
    """tests/test_multichip.py's frames."""
    rng = np.random.RandomState(seed)
    base = (np.arange(h)[:, None] * 2 + np.arange(w)[None, :]
            + rng.randint(0, 17, (h, w))).astype(np.uint8)
    return [(np.roll(base, 2 * t, axis=1),
             np.full((h // 2, w // 2), 90 + 3 * t, np.uint8),
             np.full((h // 2, w // 2), 150, np.uint8))
            for t in range(n)]


def _mc_params(cls, w=96, h=64, **kw):
    """tests/test_multichip.py's parameters, me_range 8 given to both
    packages (tests/conftest.py patches only the reference's default)."""
    kw.setdefault("scenecut_threshold", 0)
    return cls(source_width=w, source_height=h, qp=30, bframes=0, aq_mode=0,
               cu_tree=False, decoded_picture_hash=3, me_range=8, **kw)


def _encoder():
    return Encoder(Params(source_width=W, source_height=H, bframes=0,
                          me_range=16, decoded_picture_hash=3), device="cpu")


def _inputs(enc, seed, qp):
    """One frame's padded planes on the device and its QP inputs (the
    encoder's own AQ plan at frame QP ``qp``)."""
    g = enc.geom
    ph, pw = g.ctbs_h << g.log2_ctb, g.ctbs_w << g.log2_ctb
    y, u, v = synthetic_frame(W, H, seed)
    orig = (pad_plane(np.roll(y, 3 * seed, axis=1), ph, pw),
            pad_plane(u, ph // 2, pw // 2), pad_plane(v, ph // 2, pw // 2))
    enc.qp = qp
    enc._la_off16 = None
    enc._qp_plan(orig)
    qs = [to_device(a, "cpu") for a in enc._qp_arrays]
    fq = enc._filter_qps()
    return [to_device(pl, "cpu") for pl in orig], qs, fq


def _args(x):
    """The pipeline's per-frame arguments from ``_inputs``: planes, qpy,
    qpb, qpr, lam, qp_base, dqp_cb, dqp_cr, sao_lam, qp_base_ctb."""
    planes, qs, fq = x
    return (*planes, qs[0], qs[1], qs[2], qs[3], *fq, qs[4])


def _stack(per_frame):
    """Per-frame argument lists -> batched: tensors stacked, host values
    as arrays."""
    out = []
    for vals in zip(*per_frame):
        out.append(torch.stack(vals) if torch.is_tensor(vals[0])
                   else np.stack(vals))
    return out


def _assert_frame(batched, single, f):
    """Frame ``f`` of a batched (small, tails, ext) equal to one frame's."""
    (bs, bt, be), (ss, st, se) = batched, single
    assert sorted(bs) == sorted(ss)
    for k in ss:
        assert torch.equal(bs[k][f], ss[k]), k
    for k in st:
        for a, b in zip(bt[k], st[k]):
            assert torch.equal(a[f], b), k
    for a, b in zip(be, se):
        assert torch.equal(a[f], b)


@pytest.fixture(scope="module")
def i_frames():
    """Three I frames at QPs 27, 32, 36: the encoder, the per-frame inputs
    and the unbatched outputs (whose ext planes serve as references)."""
    enc = _encoder()
    run = dp.build_i_pipeline(enc)
    xs = [_args(_inputs(enc, f, qp)) for f, qp in enumerate((27, 32, 36))]
    return enc, xs, [run(*x) for x in xs]


def test_batched_i_pipeline(i_frames):
    enc, xs, singles = i_frames
    out = dp.build_i_pipeline(enc, batch=G)(*_stack(xs))
    for f in range(G):
        _assert_frame(out, singles[f], f)


@pytest.mark.parametrize("n_act", [2, 3])
def test_batched_p_pipeline(i_frames, n_act):
    """Each frame its own three reference slots (the I frames' ext planes
    in another order per frame; with n_act 2 the third slot repeats the
    second, as the encoder pads it), weights and QP."""
    enc, _xs, singles = i_frames
    exts = [s[2] for s in singles]
    nr = enc.num_ref
    assert nr == 3 and enc.params.weightp and enc.aq
    refs = [[exts[(f + k) % G] for k in range(nr)] for f in range(G)]
    if n_act == 2:
        refs = [r[:2] + [r[1]] for r in refs]
    wps = [(64, 0), (58, 3), (71, -4)]
    pocs = [3, 2, 2 if n_act == 2 else 1]
    xs = [_args(_inputs(enc, 5 + f, qp)) for f, qp in enumerate((29, 33, 35))]
    run = dp.build_p_pipeline(enc, nr=nr)

    def slots(rs):
        return tuple(tuple(r[i] for r in rs) for i in range(3))

    singles_p = []
    for f in range(G):
        ry, rcb, rcr = slots(refs[f])
        x = xs[f]
        singles_p.append(run(*x[:3], ry, rcb, rcr, *x[3:], pocs,
                             wy=wps[f][0], wo=wps[f][1], n_act=n_act))
    ry, rcb, rcr = (tuple(torch.stack([slots(refs[f])[i][r]
                                       for f in range(G)])
                          for r in range(nr)) for i in range(3))
    xb = _stack(xs)
    out = dp.build_p_pipeline(enc, nr=nr, batch=G)(
        *xb[:3], ry, rcb, rcr, *xb[3:], pocs, wy=[w[0] for w in wps],
        wo=[w[1] for w in wps], n_act=n_act)
    for f in range(G):
        _assert_frame(out, singles_p[f], f)
        assert torch.equal(out[0]["ref_idx"][f], singles_p[f][0]["ref_idx"])
    rsel = out[0]["ref_idx"][out[0]["inter"]]
    assert int(rsel.max()) == n_act - 1           # a padded slot never wins


def test_me_per_frame_references(i_frames):
    """``me`` over F frames, each against its own reference plane [F, H,
    W] with its own lambda, equal to F single-frame searches."""
    enc, xs, singles = i_frames
    tools = dp._inter_tools_builder(enc)
    oy = torch.stack([x[0] for x in xs[::-1]]).to(torch.int32)
    ref = torch.stack([s[2][0] for s in singles])
    n = 16
    ph, pw = oy.shape[1:]
    ob = oy.reshape(G, ph // n, n, pw // n, n).permute(
        0, 1, 3, 2, 4).reshape(-1, n, n)
    lam = torch.stack([dp.me_lambda(q) for q in (28, 32, 37)])
    got = tools["me"](oy, ref, ob, lam)
    nb = ob.shape[0] // G
    for f in range(G):
        want = tools["me"](oy[f], ref[f], ob[f * nb:(f + 1) * nb], lam[f])
        for a, b in zip(got, want):
            assert torch.equal(a[f * nb:(f + 1) * nb], b)


@pytest.mark.parametrize("cfg", ["I", "P"])
def test_k1_source_eight_frames(monkeypatch, cfg):
    """K1's host build over the F x L lanes of eight frames (lane / (L / F)
    picks a lane's frame), one launch a level, equal to the plain step;
    ``LAUNCHES_FRAMES`` counts eight frames a launch."""
    from test_torch_ctu_scan import _inputs as scan_inputs
    from test_torch_ctu_scan import _run_batch

    lib = load_host_library()
    xs = [scan_inputs(seed=20 + f)[1] for f in range(8)]
    g = scan_inputs()[0]
    scan = CtuScan(g, bit_depth=8, sign_hide=True,
                   strong_intra_smoothing=True, psy_rd=2.0)
    want = _run_batch(scan, xs, cfg, True)
    n0, f0 = ctu_scan_cuda.LAUNCHES, ctu_scan_cuda.LAUNCHES_FRAMES
    monkeypatch.setattr(
        ctu_scan_cuda, "ctu_step",
        lambda s, inter, d, carry, x, plain: ctu_scan_cuda.launch(
            lib, s, inter, d, carry, x))
    got = _run_batch(scan, xs, cfg, True)
    levels = scan.t["n_levels"]
    assert ctu_scan_cuda.LAUNCHES - n0 == levels
    assert ctu_scan_cuda.LAUNCHES_FRAMES - f0 == 8 * levels
    for w, gg in zip(want, got):
        for a, b in zip(w, gg):
            assert (a is None and b is None) or np.array_equal(a, b)


@functools.lru_cache(maxsize=None)
def _ref_sequential():
    """x265_tpu's sequential stream of the 8 frames at keyint 2 (traced
    once for the module)."""
    want, _ = ref_encode_sequence(_mc_frames(8),
                                  _mc_params(RefParams, keyint_max=2))
    return want


def test_cqp_equals_reference_sequential():
    frames = _mc_frames(8)
    stream = encode_gop_parallel(frames, _mc_params(Params, keyint_max=2), 4,
                                 device="cpu")
    assert stream == _ref_sequential()
    pics = decode_annexb(stream)
    assert len(pics) == 8 and all(p.hash_ok for p in pics)


def test_abr_per_gop_equals_sequential():
    """Each GOP runs its own rate control: its stream equals the port's
    sequential encode of that GOP alone."""
    n, w, h = 3, 64, 48
    rng = np.random.RandomState(3)
    gops = []
    for k in range(3):
        base = rng.randint(0, 256, (h, w), np.uint8)
        gops.append([(np.roll(base, t + k, axis=1),
                      np.full((h // 2, w // 2), 128, np.uint8),
                      np.full((h // 2, w // 2), 128, np.uint8))
                     for t in range(n)])
    p = Params(source_width=w, source_height=h, bitrate=200, fps_num=25,
               rc_mode=RC_ABR, bframes=0, aq_mode=0, cu_tree=False,
               decoded_picture_hash=1, me_range=8)
    streams = GopParallelEncoder(p, 3, device="cpu").encode(gops)
    qps = set()
    for k, gop in enumerate(gops):
        seq = Encoder(p, device="cpu")
        out = seq.headers()
        for fr in gop:
            au, _ = seq.encode_frame(fr)
            out += au
            qps.add(seq.qp)
        assert streams[k] == out, f"GOP {k} differs from its own encode"
    assert len(qps) > 1                   # the rate control moved the QP


def test_refusals():
    frames = _mc_frames(6)
    with pytest.raises(ValueError, match="bframes"):
        GopParallelEncoder(dataclasses.replace(_mc_params(Params), bframes=2),
                           2, device="cpu")
    enc = GopParallelEncoder(_mc_params(Params), 2, device="cpu")
    with pytest.raises(ValueError, match="equal length"):
        enc.encode([frames[:2], frames[2:5]])
    with pytest.raises(ValueError, match="exactly 2 GOPs"):
        enc.encode([frames[:2]])
    with pytest.raises(ValueError, match="equal GOPs"):
        encode_gop_parallel(frames[:5], _mc_params(Params), 2, device="cpu")


def test_cqp_two_shards_equals_reference_sequential():
    """Four GOPs of two over two shards (two GOPs each, one host thread
    each) equal the reference's sequential stream."""
    frames = _mc_frames(8)
    enc = GopParallelEncoder(_mc_params(Params, keyint_max=2), 4,
                             devices=["cpu", "cpu"])
    assert [len(sh.encoders) for sh in enc.shards] == [2, 2]
    stream = encode_gop_parallel(frames, _mc_params(Params, keyint_max=2), 4,
                                 devices=["cpu", "cpu"])
    assert stream == _ref_sequential()
    pics = decode_annexb(stream)
    assert len(pics) == 8 and all(p.hash_ok for p in pics)


def test_shard_exception_raises_from_encode():
    """A shard that fails makes ``encode`` raise its exception, after the
    other shard has run."""
    enc = GopParallelEncoder(_mc_params(Params), 4, devices=["cpu", "cpu"])
    ran = []

    def ok(gops):
        ran.append(len(gops))
        return [b"", b""]

    def fail(gops):
        raise RuntimeError("shard 1 failed")

    enc.shards[0].encode_on_stream = ok
    enc.shards[1].encode_on_stream = fail
    frames = _mc_frames(8)
    with pytest.raises(RuntimeError, match="shard 1 failed"):
        enc.encode([frames[2 * k:2 * k + 2] for k in range(4)])
    assert ran == [2]


def test_refuses_gops_that_do_not_split_over_devices():
    with pytest.raises(ValueError, match="equal shards"):
        GopParallelEncoder(_mc_params(Params), 3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="equal shards"):
        GopParallelEncoder(_mc_params(Params), 2, devices=[])


def test_k1_launches_from_threads_count_exactly(monkeypatch):
    """More threads than cores, each scanning a frame twice through
    K1's host build (ctypes releases the interpreter lock, so the launches
    overlap), with a short switch interval: every launch is counted (the
    counts are bumped under a lock) and every scan equals the plain step."""
    from test_torch_ctu_scan import _inputs as scan_inputs
    from test_torch_ctu_scan import _run

    lib = load_host_library()
    g = scan_inputs()[0]
    scan = CtuScan(g, bit_depth=8, sign_hide=True,
                   strong_intra_smoothing=True, psy_rd=2.0)
    xs = [scan_inputs(seed=30 + k)[1] for k in range(2)]
    want = [_run(scan, torch, x, "P", True) for x in xs]
    monkeypatch.setattr(
        ctu_scan_cuda, "ctu_step",
        lambda s, inter, d, carry, x, plain: ctu_scan_cuda.launch(
            lib, s, inter, d, carry, x))
    n0, f0 = ctu_scan_cuda.LAUNCHES, ctu_scan_cuda.LAUNCHES_FRAMES
    T, reps = (os.cpu_count() or 1) + 2, 2
    got = [None] * T

    def work(k):
        for _ in range(reps):
            got[k] = _run(scan, torch, xs[k % 2], "P", True)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(T)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    levels = scan.t["n_levels"]
    assert ctu_scan_cuda.LAUNCHES - n0 == T * reps * levels
    assert ctu_scan_cuda.LAUNCHES_FRAMES - f0 == T * reps * levels
    for k, gg in enumerate(got):
        for a, b in zip(want[k % 2], gg):
            assert (a is None and b is None) or np.array_equal(a, b)
