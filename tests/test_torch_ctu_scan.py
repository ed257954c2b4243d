"""x265_tpu_torch CtuScan against x265_tpu's CtuScan, and K1's source (built
for the host) against the port's plain step, on the CPU at 192x128
(5 wavefront levels, 2 lanes at most); the pattern of
tools/check_pallas_scan.py.  All 12 outputs must be equal.  At 8 bits and
at 10 (Main10: samples and predictions 0..1023 with bands at 0 and 1023,
QPs with the 12 of the bit-depth offset, up to 63)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x265_tpu.common.geometry import PictureGeometry as RefGeometry
from x265_tpu.encoder.ctu_scan import CtuScan as RefScan
from x265_tpu_torch.build import load_host_library
from x265_tpu_torch.common.geometry import PictureGeometry
from x265_tpu_torch.encoder import ctu_scan_cuda
from x265_tpu_torch.encoder.ctu_scan import NR_CATS, CtuScan
from torch_threads import one_torch_thread  # noqa: F401

NAMES = ("rec_y rec_cb rec_cr lv16 lv8cb lv8cr lv32 lv16cb lv16cr use32 "
         "tu8 nr").split()


def _inputs(seed=7, w=192, h=128, bd=8):
    """Random scan inputs.  10 bits: samples and inter predictions
    0..1023 with, in every plane and prediction, a band of columns at 0,
    one at 1023 (every clamp is reached) and one of 512 +- 5 (near-flat:
    strong smoothing's threshold 32 decides there), QPs 36..63 (the
    scan's QP includes 6 * (10 - 8))."""
    rng = np.random.RandomState(seed)
    g = PictureGeometry(w, h, 6, 3)
    ph, pw = g.ctbs_h << 6, g.ctbs_w << 6
    b16, b32 = (ph // 16) * (pw // 16), (ph // 32) * (pw // 32)
    nctb = g.n_ctbs
    dt = np.uint8 if bd == 8 else np.uint16

    def plane(shape):
        p = rng.randint(0, 1 << bd, shape)
        if bd == 10:
            w8 = shape[-1] // 8
            p[..., :w8] = 0
            p[..., 4 * w8:5 * w8] = 1023
            p[..., 6 * w8:7 * w8] = 512 + rng.randint(-5, 6,
                                                      p[..., :w8].shape)
        return p

    x = dict(
        oy=plane((ph, pw)).astype(dt),
        ocb=plane((ph // 2, pw // 2)).astype(dt),
        ocr=plane((ph // 2, pw // 2)).astype(dt),
        modes=rng.randint(0, 35, b16).astype(np.int32),
        mode32=rng.randint(0, 35, b32).astype(np.int32),
        use32=rng.rand(b32) < 0.5,
        qp=(rng.randint(24, 40, nctb) if bd == 8
            else rng.randint(36, 64, nctb)).astype(np.int32),
        lam=(0.85 * 2.0 ** (rng.randint(24, 40 if bd == 8 else 52, nctb)
                            / 3.0 - 4.0)).astype(np.float32),
        is_inter=rng.rand(b16) < 0.7,
        ipred_y=plane((b16, 16, 16)).astype(np.int32),
        ipred_cb=plane((b16, 8, 8)).astype(np.int32),
        ipred_cr=plane((b16, 8, 8)).astype(np.int32),
        m32_in=rng.rand(b32) < 0.4)
    return g, x


def _run(scan, arr, x, cfg, decide):
    fn = scan.scan_fn(inter=cfg == "P", decide32=decide)
    if arr is jnp:
        fn = jax.jit(fn)
    return _call(fn, arr, x, cfg, decide)


def _call(fn, arr, x, cfg, decide):
    a = {k: (jnp.asarray(v) if arr is jnp else torch.as_tensor(v))
         for k, v in x.items()}
    use32 = a["use32"] if not decide else (
        jnp.zeros_like(a["use32"]) if arr is jnp
        else torch.zeros_like(a["use32"]))
    kw = {}
    if cfg == "P":
        kw = {k: a[k] for k in ("is_inter", "ipred_y", "ipred_cb",
                                "ipred_cr", "m32_in")}
    out = fn(a["oy"], a["ocb"], a["ocr"], a["modes"], a["mode32"], use32,
             a["qp"], a["qp"], a["qp"], lam=a["lam"], **kw)
    return [None if o is None else np.asarray(o) for o in out]


def _assert_same(want, got):
    for nm, a, b in zip(NAMES, want, got):
        if a is None and b is None:
            continue
        assert a.shape == b.shape, (nm, a.shape, b.shape)
        assert np.array_equal(a, b), (nm, int((a != b).sum()))


@functools.lru_cache(maxsize=None)
def _ref_scan(w, h, cfg, psy, sign_hide, bd=8):
    """The reference's jitted decide32 scan, traced once per module and
    configuration."""
    scan = RefScan(RefGeometry(w, h, 6, 3), bit_depth=bd, sign_hide=sign_hide,
                   strong_intra_smoothing=True, psy_rd=psy)
    return jax.jit(scan.scan_fn(inter=cfg == "P", decide32=True))


CONFIGS = [("I", 0.0, False), ("P", 2.0, True)]


@pytest.mark.parametrize("cfg,psy,sign_hide", CONFIGS)
def test_scan_matches_reference(cfg, psy, sign_hide):
    g, x = _inputs()
    kw = dict(bit_depth=8, sign_hide=sign_hide, strong_intra_smoothing=True,
              psy_rd=psy)
    want = _call(_ref_scan(g.width, g.height, cfg, psy, sign_hide), jnp, x,
                 cfg, True)
    got = _run(CtuScan(g, **kw), torch, x, cfg, True)
    _assert_same(want, got)


@pytest.mark.parametrize("cfg", ["I", "P"])
@pytest.mark.parametrize("decide", [True, False])
@pytest.mark.parametrize("psy,sign_hide", [(2.0, True), (2.0, False),
                                           (0.0, True)])
def test_k1_source_matches_plain_step(monkeypatch, cfg, decide, psy,
                                      sign_hide):
    """K1's CUDA source, compiled as host C++ (one thread per block), run
    level by level through the wrapper's launch path, equals the plain
    torch step on every output."""
    lib = load_host_library()
    g, x = _inputs(seed=11)
    scan = CtuScan(g, bit_depth=8, sign_hide=sign_hide,
                   strong_intra_smoothing=True, psy_rd=psy)
    want = _run(scan, torch, x, cfg, decide)
    n0 = ctu_scan_cuda.LAUNCHES
    monkeypatch.setattr(
        ctu_scan_cuda, "ctu_step",
        lambda s, inter, d, carry, xs, plain: ctu_scan_cuda.launch(
            lib, s, inter, d, carry, xs))
    got = _run(scan, torch, x, cfg, decide)
    assert ctu_scan_cuda.LAUNCHES - n0 == scan.t["n_levels"]
    _assert_same(want, got)


def test_cpu_tensors_take_the_plain_step():
    g, x = _inputs()
    scan = CtuScan(g, bit_depth=8, sign_hide=True,
                   strong_intra_smoothing=True, psy_rd=2.0)
    n0 = ctu_scan_cuda.LAUNCHES
    want = _run(scan, torch, x, "I", True)
    assert ctu_scan_cuda.LAUNCHES == n0
    # the RQT split is an inter candidate: an intra scan with it codes no
    # block with the split and gives the same outputs
    got = _call(scan.scan_fn(inter=False, decide32=True, rqt=True), torch,
                x, "I", True)
    assert not got[10].any()
    _assert_same(want, got)


def _run_batch(scan, xs, cfg, decide):
    """The port's scan over a batch of frames (inputs stacked on a leading
    frame dimension); returns one output list per frame."""
    fn = scan.scan_fn(inter=cfg == "P", decide32=decide)
    a = {k: torch.as_tensor(np.stack([x[k] for x in xs])) for k in xs[0]}
    use32 = a["use32"] if not decide else torch.zeros_like(a["use32"])
    kw = {}
    if cfg == "P":
        kw = {k: a[k] for k in ("is_inter", "ipred_y", "ipred_cb",
                                "ipred_cr", "m32_in")}
    out = fn(a["oy"], a["ocb"], a["ocr"], a["modes"], a["mode32"], use32,
             a["qp"], a["qp"], a["qp"], lam=a["lam"], **kw)
    return [[None if o is None else np.asarray(o[f]) for o in out]
            for f in range(len(xs))]


@pytest.mark.parametrize("cfg,psy,sign_hide", CONFIGS)
def test_batched_scan_matches_reference_frames(cfg, psy, sign_hide):
    """Two frames in one batched scan (each level one step over both
    frames' lanes, each frame its own frontiers) equal two single-frame
    reference scans."""
    g, x0 = _inputs(seed=7)
    _g, x1 = _inputs(seed=8)
    kw = dict(bit_depth=8, sign_hide=sign_hide, strong_intra_smoothing=True,
              psy_rd=psy)
    ref = _ref_scan(g.width, g.height, cfg, psy, sign_hide)
    got = _run_batch(CtuScan(g, **kw), [x0, x1], cfg, True)
    for x, frame in zip((x0, x1), got):
        _assert_same(_call(ref, jnp, x, cfg, True), frame)


@pytest.mark.parametrize("cfg,decide", [("I", True), ("P", True),
                                        ("P", False)])
def test_k1_source_batched_lanes(monkeypatch, cfg, decide):
    """K1's host build over the F x L lanes of two frames, one launch per
    level, equals the plain step on the same batched carry."""
    lib = load_host_library()
    g, x0 = _inputs(seed=11)
    _g, x1 = _inputs(seed=12)
    scan = CtuScan(g, bit_depth=8, sign_hide=True,
                   strong_intra_smoothing=True, psy_rd=2.0)
    want = _run_batch(scan, [x0, x1], cfg, decide)
    n0 = ctu_scan_cuda.LAUNCHES
    monkeypatch.setattr(
        ctu_scan_cuda, "ctu_step",
        lambda s, inter, d, carry, xs, plain: ctu_scan_cuda.launch(
            lib, s, inter, d, carry, xs))
    got = _run_batch(scan, [x0, x1], cfg, decide)
    assert ctu_scan_cuda.LAUNCHES - n0 == scan.t["n_levels"]
    for w, gg in zip(want, got):
        _assert_same(w, gg)


@pytest.mark.parametrize("cfg,psy,sign_hide", CONFIGS[1:])
def test_scan_matches_reference_10bit(cfg, psy, sign_hide):
    """Main10: the port's scan (one frame) equals the reference's jnp scan
    at bit depth 10."""
    g, x = _inputs(bd=10)
    want = _call(_ref_scan(g.width, g.height, cfg, psy, sign_hide, 10), jnp,
                 x, cfg, True)
    got = _run(CtuScan(g, bit_depth=10, sign_hide=sign_hide,
                       strong_intra_smoothing=True, psy_rd=psy),
               torch, x, cfg, True)
    # the reference's uint16 values, held as int16 on the device
    assert want[0].dtype == np.uint16 and got[0].dtype == np.int16
    assert got[0].max() == 1023 and got[0].min() == 0
    _assert_same(want, got)


@pytest.mark.parametrize("cfg,psy,sign_hide", CONFIGS[1:])
def test_batched_scan_matches_reference_frames_10bit(cfg, psy, sign_hide):
    """Main10: two frames in one batched scan equal two single-frame
    reference scans at bit depth 10."""
    g, x0 = _inputs(seed=7, bd=10)
    _g, x1 = _inputs(seed=8, bd=10)
    ref = _ref_scan(g.width, g.height, cfg, psy, sign_hide, 10)
    got = _run_batch(CtuScan(g, bit_depth=10, sign_hide=sign_hide,
                             strong_intra_smoothing=True, psy_rd=psy),
                     [x0, x1], cfg, True)
    for x, frame in zip((x0, x1), got):
        _assert_same(_call(ref, jnp, x, cfg, True), frame)


@pytest.mark.parametrize("cfg", ["I", "P"])
@pytest.mark.parametrize("psy", [2.0, 0.0])
def test_k1_source_matches_plain_step_10bit(monkeypatch, cfg, psy):
    """K1's 10-bit instantiation (host build, through the wrapper's launch
    path) equals the plain step at bit depth 10, with samples at 0 and
    1023; the launches count as 10-bit launches."""
    lib = load_host_library()
    g, x = _inputs(seed=11, bd=10)
    scan = CtuScan(g, bit_depth=10, sign_hide=True,
                   strong_intra_smoothing=True, psy_rd=psy)
    want = _run(scan, torch, x, cfg, True)
    n0, t0 = ctu_scan_cuda.LAUNCHES, ctu_scan_cuda.LAUNCHES_10BIT
    monkeypatch.setattr(
        ctu_scan_cuda, "ctu_step",
        lambda s, inter, d, carry, xs, plain: ctu_scan_cuda.launch(
            lib, s, inter, d, carry, xs))
    got = _run(scan, torch, x, cfg, True)
    assert ctu_scan_cuda.LAUNCHES - n0 == scan.t["n_levels"]
    assert ctu_scan_cuda.LAUNCHES_10BIT - t0 == scan.t["n_levels"]
    _assert_same(want, got)


def test_k1_source_batched_lanes_10bit(monkeypatch):
    """K1's 10-bit host build over two frames' lanes (P, decide32) equals
    the plain step on the same batched carry."""
    lib = load_host_library()
    g, x0 = _inputs(seed=11, bd=10)
    _g, x1 = _inputs(seed=12, bd=10)
    scan = CtuScan(g, bit_depth=10, sign_hide=True,
                   strong_intra_smoothing=True, psy_rd=2.0)
    want = _run_batch(scan, [x0, x1], "P", True)
    monkeypatch.setattr(
        ctu_scan_cuda, "ctu_step",
        lambda s, inter, d, carry, xs, plain: ctu_scan_cuda.launch(
            lib, s, inter, d, carry, xs))
    got = _run_batch(scan, [x0, x1], "P", True)
    for w, gg in zip(want, got):
        _assert_same(w, gg)


def test_k1_refuses_other_bit_depths():
    """K1's wrapper takes bit depths 8 and 10 only."""
    g, _x = _inputs()
    scan = CtuScan(g, bit_depth=12)
    with pytest.raises(NotImplementedError):
        ctu_scan_cuda.kernel_args(scan, False, True, None, {
            "cx": torch.zeros(1, dtype=torch.int32)})


# --- RDOQ (psy-RDOQ 1.0) and noise reduction, together -------------------

def _nr_offsets(seed=5):
    """Seeded offsets: 0..39 at about 60% of the positions, DC zero."""
    rng = np.random.RandomState(seed)
    out = {}
    for cat, n in NR_CATS:
        for sfx in ("_i", "_p"):
            v = rng.randint(0, 40, n * n) * (rng.rand(n * n) < 0.6)
            v[0] = 0
            out[cat + sfx] = v.astype(np.int32)
    return out


KW_RDOQ_NR = dict(sign_hide=True, strong_intra_smoothing=True, psy_rd=2.0,
                  rdoq=True, noise_reduction=True, psy_rdoq=1.0)


@functools.lru_cache(maxsize=None)
def _ref_scan_rdoq_nr(w, h, cfg, bd):
    """The reference's jitted decide32 scan with RDOQ, psy-RDOQ and noise
    reduction, traced once per module and configuration."""
    scan = RefScan(RefGeometry(w, h, 6, 3), bit_depth=bd, **KW_RDOQ_NR)
    return jax.jit(scan.scan_fn(inter=cfg == "P", decide32=True))


def _scan_call(fn, arr, xs, cfg, nr):
    """``fn`` on the scan inputs of one frame (``xs`` a dict) or of several
    (a list, stacked on a leading dimension)."""
    if isinstance(xs, list):
        xs = {k: np.stack([x[k] for x in xs]) for k in xs[0]}
    a = {k: (jnp.asarray(v) if arr is jnp else torch.as_tensor(v))
         for k, v in xs.items()}
    kw = {}
    if cfg == "P":
        kw = {k: a[k] for k in ("is_inter", "ipred_y", "ipred_cb",
                                "ipred_cr", "m32_in")}
    use32 = a["use32"] & False
    return fn(a["oy"], a["ocb"], a["ocr"], a["modes"], a["mode32"], use32,
              a["qp"], a["qp"], a["qp"], lam=a["lam"], nr_offsets=nr, **kw)


def assert_scan_equal(want, got, frame=None):
    """All twelve scan outputs equal (``frame``: the frame of a batched
    ``got``), the NR sums of every category included."""
    for nm, a, b in zip(NAMES, want, got):
        if a is None and b is None:
            continue
        if nm == "nr":
            assert sorted(a) == sorted(b)
            for cat in a:
                for i in range(4):
                    v = b[cat][i] if frame is None else b[cat][i][frame]
                    assert np.array_equal(np.asarray(a[cat][i]),
                                          np.asarray(v)), (cat, i)
            continue
        b = b if frame is None else b[frame]
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (nm, a.shape, b.shape)
        assert np.array_equal(a, b), (nm, int((a != b).sum()))


@pytest.mark.parametrize("cfg,bd", [("I", 8), ("P", 10)])
def test_scan_matches_reference_rdoq_nr(cfg, bd):
    """RDOQ + psy-RDOQ + noise reduction, I at 8 bits and P at 10: one
    frame, then two frames batched, each equal to the reference's scan of
    it, the NR sums included (P at 8 bits: tests/test_torch_rdoq.py)."""
    g, x0 = _inputs(seed=7, bd=bd)
    _g, x1 = _inputs(seed=8, bd=bd)
    nr = _nr_offsets()
    ref = _ref_scan_rdoq_nr(g.width, g.height, cfg, bd)
    fn = CtuScan(g, bit_depth=bd, **KW_RDOQ_NR).scan_fn(inter=cfg == "P",
                                                        decide32=True)
    w0 = _scan_call(ref, jnp, x0, cfg, nr)
    assert_scan_equal(w0, _scan_call(fn, torch, x0, cfg, nr))
    got = _scan_call(fn, torch, [x0, x1], cfg, nr)
    assert_scan_equal(w0, got, 0)
    assert_scan_equal(_scan_call(ref, jnp, x1, cfg, nr), got, 1)
