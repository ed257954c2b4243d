"""The lookahead on the CPU: x265_tpu_torch's ``encoder/lookahead.py`` and
the Encoder's lookahead plumbing (cuTree offsets, the b-adapt trellis, the
lookahead scenecut) against x265_tpu's.

* The lowres program (35-mode intra SATD, full-search SAD, MV argmin) and
  the bidir program equal the reference's (``np.array_equal``) on random,
  flat, 0/255 and panning content, at 96x64's lowres size and at one the
  ``& ~7`` crop made; the bidir program with MVs at and beyond +-r.
* Two ``Lookahead``s fed the same frames and AQ offsets pop the same
  cuTree offsets (float64, equal), complexity and scenecut decisions.
* The trellis picks the reference's mini-GOP lengths on synthetic costs.
* Main10: the lowres and bidir programs on 10-bit planes (uint16, 0..1023),
  and a ``Lookahead`` at bit depth 10 popping the reference's cuTree
  offsets.  Both packages run the lowres intra at bit depth 8 even then
  (an inherited reference fault, kept so that the streams stay equal).
* Two encodes through push_frame / flush, byte-identical to the
  reference's with matching picture hashes in x265_tpu's decoder:
  (a) AQ + cuTree, bframes=2, rc_lookahead=3, b-adapt 0, on
  ``test_aq_lookahead.structured_clip``; (b) b-adapt 2, bframes=3, on
  ``test_badapt._clip``'s pan-then-noise content, ten frames: the fewest
  with which the trellis emits less than the full queue (on the pan) and
  the lookahead scenecut starts new GOPs (on the noise).  The noise
  frames' lowres cost ratio is ~0.52, under the default threshold's 0.6,
  and the default minimum GOP is 25 frames, so (b) sets
  ``scenecut_threshold=60`` and ``keyint_min=2``.

The reference's device programs (pipelines and lookahead programs) are
built once for the module and shared by its encoders, whose geometry and
search / scan parameters are the same: tracing them is most of the time."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import x265_tpu.encoder as ref_encoder
import x265_tpu.encoder.lookahead as ref_la
from test_aq_lookahead import structured_clip
from test_badapt import _clip
from x265_tpu.common.params import Params as RefParams
from x265_tpu.decoder import decode_annexb
from x265_tpu_torch import Params
from x265_tpu_torch.encoder import ctu_scan_cuda, me_cuda
from x265_tpu_torch.encoder import lookahead as la
from x265_tpu_torch.encoder.aq import aq_offsets
from x265_tpu_torch.encoder.intra_encoder import Encoder
from ref_memo import ref_programs  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

R = 10


def _planes(kind, lw, lh, seed, bd=8):
    """Two lowres planes (cur, prev) of one content kind (``bd``-bit
    samples: uint8, or uint16 at 10 bits)."""
    rng = np.random.RandomState(seed)
    hi = 1 << bd
    if kind == "random":
        a, b = rng.randint(0, hi, (2, lh, lw))
    elif kind == "flat":
        a = b = np.full((lh, lw), 77 << (bd - 8))
    elif kind == "binary":
        a, b = (hi - 1) * rng.randint(0, 2, (2, lh, lw))
    else:                                    # pan: prev shifted by (3, 5)
        base = rng.randint(0, hi, (lh + 2 * R, lw + 2 * R))
        a, b = base[3:3 + lh, 5:5 + lw], base[:lh, :lw]
    dt = np.uint8 if bd == 8 else np.uint16
    return a.astype(dt), b.astype(dt)


# 96x64's lowres plane, and 120x84's after the & ~7 crop (60x42 -> 56x40)
SIZES = [(48, 32), (56, 40)]


def _lowres_pair(size, kind, bd):
    lw, lh = size
    cur, prev = _planes(kind, lw, lh, 1, bd)
    rprog, rgrid = ref_la._build_lowres_program(lw, lh, R)
    pprog, pgrid = la._build_lowres_program(lw, lh, R, "cpu")
    assert pgrid == rgrid == (lh // 8, lw // 8)
    want = rprog(jnp.asarray(cur), jnp.asarray(prev))
    got = pprog(torch.as_tensor(cur), torch.as_tensor(prev))
    for name, a, b in zip(("intra", "inter", "mv"), want, got):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype == np.int32 and a.shape == b.shape, name
        assert np.array_equal(a, b), (name, int((a != b).sum()))
    # the pair cost is the same program's inter half
    for a, b in zip(want[1:], pprog.inter(torch.as_tensor(cur),
                                          torch.as_tensor(prev))):
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("kind", ["random", "flat", "binary", "pan"])
@pytest.mark.parametrize("size", SIZES)
def test_lowres_program_matches_reference(size, kind):
    _lowres_pair(size, kind, 8)


@pytest.mark.parametrize("kind", ["random", "flat", "binary", "pan"])
def test_lowres_program_matches_reference_10bit(kind):
    """Main10 lowres planes (0..1023; "binary": 0 / 1023)."""
    _lowres_pair(SIZES[0], kind, 10)


def _bidir_pair(size, bd):
    lw, lh = size
    cur, p0 = _planes("random", lw, lh, 2, bd)
    p1 = _planes("pan", lw, lh, 3, bd)[0]
    rng = np.random.RandomState(4)
    grid = (lh // 8, lw // 8, 2)
    # at, inside and beyond +-r: the program clips MVs to +-r
    mv0 = rng.choice([-R - 4, -R - 1, -R, -3, 0, 5, R, R + 1, R + 4],
                     grid).astype(np.int32)
    mv1 = rng.randint(-R - 4, R + 5, grid).astype(np.int32)
    want = ref_la._build_bidir_program(lw, lh, R)(
        *(jnp.asarray(x) for x in (cur, p0, p1, mv0, mv1)))
    got = la._build_bidir_program(lw, lh, R, "cpu")(
        *(torch.as_tensor(x) for x in (cur, p0, p1, mv0, mv1)))
    want, got = np.asarray(want), got.numpy()
    assert want.dtype == got.dtype == np.int32
    assert np.array_equal(want, got)


@pytest.mark.parametrize("size", SIZES)
def test_bidir_program_matches_reference(size):
    _bidir_pair(size, 8)


def test_bidir_program_matches_reference_10bit():
    _bidir_pair(SIZES[0], 10)


def _to10(frames, seed=3):
    """8-bit planes as 10-bit ones: times 4 plus 0..3 (not all multiples
    of 4)."""
    rng = np.random.RandomState(seed)
    return [tuple((p.astype(np.int32) * 4 + rng.randint(0, 4, p.shape))
                  .astype(np.uint16) for p in f) for f in frames]


POP_CASES = {
    # AQ + cuTree over a 3-deep window
    "structured": (lambda: structured_clip(96, 64, 6), dict(rc_lookahead=3)),
    # pan then noise: the scenecut decision goes both ways
    "pan_noise": (lambda: _clip(10), dict(rc_lookahead=4,
                                          scenecut_threshold=60)),
    # 120x84: the lowres plane is cropped to 56x40, the AQ grid is 5x7
    "cropped": (lambda: structured_clip(120, 84, 5, seed=5),
                dict(rc_lookahead=2)),
}


def _pops(case, bd):
    make, kw = POP_CASES[case]
    frames = make() if bd == 8 else _to10(make())
    h, w = frames[0][0].shape
    rla = ref_la.Lookahead(RefParams(source_width=w, source_height=h, **kw),
                           bd)
    pla = la.Lookahead(Params(source_width=w, source_height=h, **kw), bd,
                       device="cpu")
    want, got = [], []
    for planes in frames:
        off = aq_offsets(planes, 2, 1.0, bd, normalize=True)
        want += rla.push(planes, off.copy())
        got += pla.push(planes, off.copy())
    want += rla.flush()
    got += pla.flush()
    assert len(got) == len(want) == len(frames)
    assert pla.calls["lowres"] == len(frames) and pla.devices == {"cpu"}
    for i, (a, b) in enumerate(zip(want, got)):
        assert a[0] is b[0]                          # the planes, in order
        assert a[1].dtype == b[1].dtype == np.float64
        assert a[1].shape == b[1].shape
        assert np.array_equal(a[1], b[1]), (i, np.abs(a[1] - b[1]).max())
        assert a[2] == b[2] and a[3] == b[3], i       # satd_cost, scenecut
        for slot in ("intra_cost", "inter_cost", "mv", "invq"):
            x, y = getattr(a[4], slot), getattr(b[4], slot)
            assert x.dtype == y.dtype and np.array_equal(x, y), (i, slot)
        assert np.array_equal(np.asarray(a[4].low), b[4].low.numpy())
    if case == "pan_noise":
        assert {b[3] for b in got} == {False, True}


@pytest.mark.parametrize("case", list(POP_CASES))
def test_lookahead_pops_match_reference(case):
    _pops(case, 8)


def test_lookahead_pops_match_reference_10bit():
    """Main10: a bit-depth-10 Lookahead on 10-bit frames (AQ offsets at
    10 bits) pops the reference's cuTree offsets, costs and decisions."""
    _pops("structured", 10)


@pytest.mark.parametrize("costs", ["bidir_cheaper", "bidir_dearer", "tie",
                                   "seed0", "seed1", "seed2"])
def test_trellis_matches_reference(costs):
    """``_slicetype_decide`` on synthetic costs (test_badapt's three, and
    seeded random pair costs) in both packages: the same mini-GOP length,
    and for the three the expected one (a full B run, P only, ties to
    P)."""
    fixed = dict(bidir_cheaper=(1000.0, 400.0, 4),
                 bidir_dearer=(1000.0, 1600.0, 1), tie=(1000.0, 1000.0, 1))
    picks = []
    for pkg, P, LA, LF in ((ref_encoder, RefParams, ref_la.Lookahead,
                            ref_la.LowresFrame),
                           (None, Params, la.Lookahead, la.LowresFrame)):
        p = P(source_width=96, source_height=64, qp=32, bframes=3,
              b_adapt=2, rc_lookahead=8, me_range=8, log_level=0)
        if pkg is None:
            enc = Encoder(p, device="cpu")
            enc.lookahead = look = LA(p, device="cpu")
        else:
            enc = pkg.Encoder(p)
            enc.lookahead = look = LA(p)
        lows = []
        for _ in range(5):
            fr = LF((None, None, None), None, None)
            fr.intra_cost = np.full((8, 12), 10_000, np.int32)
            fr.low = np.zeros((64, 96), np.uint8)
            lows.append(fr)
        idx = {id(fr): i for i, fr in enumerate(lows)}
        if costs in fixed:
            pc, bc, _ = fixed[costs]
            look.p_cost = lambda b, a, pc=pc: pc
            look.bidir_cost = lambda b, r0, r1, bc=bc: bc
        else:
            rng = np.random.RandomState(int(costs[-1]))
            tab_p = rng.randint(500, 1500, (5, 5)).astype(float)
            tab_b = rng.randint(200, 1200, (5, 5, 5)).astype(float)
            look.p_cost = lambda b, a: tab_p[idx[id(b)], idx[id(a)]]
            look.bidir_cost = lambda b, r0, r1: tab_b[
                idx[id(b)], idx[id(r0)], idx[id(r1)]]
        enc._anchor_low = lows[0]
        enc._queue = [(i, None, (None, 0.0, False, lows[i]))
                      for i in range(1, 5)]
        picks.append(enc._slicetype_decide())
    assert picks[0] == picks[1]
    if costs in fixed:
        assert picks[1] == fixed[costs][2]


STREAMS = {
    "aq_cutree": (lambda: structured_clip(96, 64, 8),
                  dict(qp=30, bframes=2, rc_lookahead=3, b_adapt=0,
                       decoded_picture_hash=1)),
    "badapt": (lambda: _clip(10),
               dict(qp=32, bframes=3, b_adapt=2, rc_lookahead=8,
                    scenecut_threshold=60, keyint_min=2,
                    decoded_picture_hash=1, log_level=0)),
}


def _encode(enc, frames):
    efs = []
    for planes in frames:
        efs += enc.push_frame(planes)
    efs += enc.flush()
    return enc.headers(), efs


@pytest.fixture(scope="module", params=list(STREAMS))
def stream(request):
    """One encode per case in each package; the port's with a spy on its
    trellis (the length it emits and the queue's) and on its IDRs."""
    case = request.param
    make, kw = STREAMS[case]
    frames = make()
    h, w = frames[0][0].shape
    common = dict(source_width=w, source_height=h, me_range=8, **kw)
    want = _encode(ref_encoder.Encoder(RefParams(**common)), frames)
    enc = Encoder(Params(**common), device="cpu")
    decisions = []
    real = enc._slicetype_decide

    def spy():
        n = real()
        decisions.append((n, len(enc._queue)))
        return n
    enc._slicetype_decide = spy
    n1, n2 = ctu_scan_cuda.LAUNCHES, me_cuda.LAUNCHES
    got = _encode(enc, frames)
    launches = (ctu_scan_cuda.LAUNCHES - n1, me_cuda.LAUNCHES - n2)
    return case, want, got, decisions, launches, enc


def test_lookahead_stream_is_byte_identical(stream):
    case, (hw, want), (hg, got), _d, launches, enc = stream
    # CPU tensors: the plain versions ran, not the kernels
    assert launches == (0, 0)
    assert enc.lookahead.devices == {"cpu"}
    assert enc.lookahead.calls["lowres"] == len(got)
    assert hg == hw
    assert [(e.poc, e.kind) for e in got] == [(e.poc, e.kind) for e in want]
    assert [len(e.au) for e in got] == [len(e.au) for e in want]
    for a, b in zip(want, got):
        assert a.au == b.au, f"access unit of poc {a.poc} differs"
    for a, b in zip(sorted(want, key=lambda e: e.display_idx),
                    sorted(got, key=lambda e: e.display_idx)):
        for pa, pb in zip(a.recon, b.recon):
            assert np.array_equal(np.asarray(pa), pb)


def test_lookahead_stream_decodes_with_hashes(stream):
    _case, _want, (hg, got), _d, _l, _enc = stream
    pics = decode_annexb(hg + b"".join(e.au for e in got))
    assert len(pics) == len(got)
    assert all(p.hash_ok for p in pics)


def test_lookahead_stream_paths(stream):
    """(a) runs cuTree with the fixed pattern; (b) the trellis emits less
    than the full queue and the lookahead scenecut starts GOPs."""
    case, _want, (_hg, got), decisions, _l, enc = stream
    kinds = [e.kind for e in sorted(got, key=lambda e: e.display_idx)]
    if case == "aq_cutree":
        assert enc.lookahead.cutree and not decisions
        assert kinds == ["I", "B", "B", "P", "B", "B", "P", "P"]
    else:
        assert enc.lookahead.calls["pair"] and enc.lookahead.calls["bidir"]
        assert any(n < m for n, m in decisions), decisions
        assert kinds.count("I") > 1, kinds
