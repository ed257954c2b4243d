"""x265_tpu_torch ops against their x265_tpu (jnp) twins on the CPU.

Every comparison is exact (np.array_equal): the math is integer, and the
float costs are integer-valued or rounded the reference's way.  Each op
runs at bit depth 8 and at 10 (Main10: samples 0..1023, QPs up to 63).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x265_tpu.common import rdcost as r_rdcost
from x265_tpu.common.geometry import PictureGeometry
from x265_tpu.encoder import wavefront as r_wf
from x265_tpu.ops import cost as r_cost
from x265_tpu.ops import deblock as r_db
from x265_tpu.ops import interp as r_interp
from x265_tpu.ops import intra as r_intra
from x265_tpu.ops import quantize as r_quant
from x265_tpu.ops import sao as r_sao
from x265_tpu.ops import transforms as r_tr
from x265_tpu_torch import convert
from x265_tpu_torch.common import rdcost as p_rdcost
from x265_tpu_torch.common.geometry import PictureGeometry as PGeometry
from x265_tpu_torch.encoder import wavefront as p_wf
from x265_tpu_torch.encoder.me_cuda import mv_bits, mv_bits_table
from x265_tpu_torch.ops import cost as p_cost
from x265_tpu_torch.ops import deblock as p_db
from x265_tpu_torch.ops import interp as p_interp
from x265_tpu_torch.ops import intra as p_intra
from x265_tpu_torch.ops import quantize as p_quant
from x265_tpu_torch.ops import sao as p_sao
from x265_tpu_torch.ops import transforms as p_tr
from torch_threads import one_torch_thread  # noqa: F401


def _t(a):
    return torch.as_tensor(np.array(a))


BDS = pytest.mark.parametrize("bd", [8, 10])


def _eq(ref, port):
    ref = np.asarray(ref)
    port = port.cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    assert ref.shape == port.shape, (ref.shape, port.shape)
    assert np.array_equal(ref, port), int((ref != port).sum())


@BDS
@pytest.mark.parametrize("n,dst", [(4, True), (4, False), (8, False),
                                   (16, False), (32, False)])
def test_transforms(n, dst, bd):
    rng = np.random.RandomState(n)
    m = (1 << bd) - 1
    resi = rng.randint(-m, m + 1, (6, n, n)).astype(np.int32)
    if bd == 10:
        resi[0] = m                     # the forward rows' extreme
        resi[1] = -m
    _eq(r_tr.forward_transform(jnp.asarray(resi), bd, dst=dst),
        p_tr.forward_transform(_t(resi), bd, dst=dst))
    coef = rng.randint(-32768, 32768, (6, n, n)).astype(np.int32)
    coef[:3] //= 64
    _eq(r_tr.inverse_transform(jnp.asarray(coef), bd, dst=dst),
        p_tr.inverse_transform(_t(coef), bd, dst=dst))


@BDS
@pytest.mark.parametrize("n", [8, 16, 32])
def test_quant_dequant_sign_hide(n, bd):
    rng = np.random.RandomState(n)
    coef = (rng.randint(-4000, 4001, (8, n, n))
            * (rng.rand(8, n, n) < 0.4)).astype(np.int32)
    # QP' = QP + 6 * (bd - 8): up to 63 at 10 bits
    qp = rng.randint(0, 52 + 6 * (bd - 8), 8).astype(np.int32)
    mask = rng.rand(8) < 0.5
    for intra in (True, False):
        _eq(r_quant.quant(jnp.asarray(coef), jnp.asarray(qp), bd, intra),
            p_quant.quant(_t(coef), _t(qp), bd, intra))
    lv = r_quant.quant_masked(jnp.asarray(coef), jnp.asarray(qp),
                              jnp.asarray(mask), bd)
    _eq(lv, p_quant.quant_masked(_t(coef), _t(qp), _t(mask), bd))
    lv = np.asarray(lv)
    _eq(r_quant.dequant(jnp.asarray(lv), jnp.asarray(qp), bd),
        p_quant.dequant(_t(lv), _t(qp), bd))
    _eq(r_quant.sign_hide_diag(jnp.asarray(lv)), p_quant.sign_hide_diag(
        _t(lv)))


@BDS
@pytest.mark.parametrize("n,luma", [(4, True), (8, True), (8, False),
                                    (16, True), (16, False), (32, True)])
def test_intra_predict(n, luma, bd):
    rng = np.random.RandomState(n + luma)
    raw = rng.randint(0, 1 << bd, (5, 4 * n + 1)).astype(np.int32)
    av = rng.rand(5, 4 * n + 1) < 0.7
    av[0] = False                       # nothing available: mid-grey
    av[1, :n] = False                   # leading gap
    if bd == 10:                        # the edge filters' clamps
        raw[2, :2 * n] = 1023
        raw[3, 2 * n + 1:] = 0
    ref_sub = r_intra.substitute_references(jnp.asarray(raw), jnp.asarray(av),
                                            bd)
    _eq(ref_sub, p_intra.substitute_references(_t(raw), _t(av), bd))
    refs = np.asarray(ref_sub)
    _eq(r_intra.predict_all_modes(jnp.asarray(refs), n, luma, bd),
        p_intra.predict_all_modes(_t(refs), n, luma, bd))
    modes = rng.randint(0, 35, 5).astype(np.int32)
    _eq(r_wf._substitute(jnp.asarray(raw), jnp.asarray(av), bd),
        p_wf._substitute(_t(raw), _t(av), bd))
    _eq(r_wf._predict_lanes(jnp.asarray(refs), jnp.asarray(modes), n, luma,
                            bd),
        p_wf._predict_lanes(_t(refs), _t(modes), n, luma, bd))


@BDS
@pytest.mark.parametrize("n", [8, 16, 32])
def test_costs(n, bd):
    rng = np.random.RandomState(n)
    a = rng.randint(0, 1 << bd, (7, n, n)).astype(np.int32)
    b = rng.randint(0, 1 << bd, (7, n, n)).astype(np.int32)
    _eq(r_cost.sad(jnp.asarray(a), jnp.asarray(b)), p_cost.sad(_t(a), _t(b)))
    _eq(r_cost.satd(jnp.asarray(a), jnp.asarray(b)),
        p_cost.satd(_t(a), _t(b)))
    _eq(r_cost.psy_cost(jnp.asarray(a), jnp.asarray(b)),
        p_cost.psy_cost(_t(a), _t(b)))


@BDS
@pytest.mark.parametrize("n", [8, 16, 32])
@pytest.mark.parametrize("name", ["sse", "sa8d"])
def test_sse_sa8d(name, n, bd):
    """The reference's SSE and SA8D, which no encoder path calls."""
    rng = np.random.RandomState(n + bd)
    a = rng.randint(0, 1 << bd, (5, n, n)).astype(np.int32)
    b = rng.randint(0, 1 << bd, (5, n, n)).astype(np.int32)
    _eq(getattr(r_cost, name)(jnp.asarray(a), jnp.asarray(b)),
        getattr(p_cost, name)(_t(a), _t(b)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bdrate(seed):
    """BD-rate and BD-PSNR of two seeded four-point RD curves, equal to
    the reference's."""
    from x265_tpu.tools import bdrate as r_bd
    from x265_tpu_torch.tools import bdrate as p_bd
    rng = np.random.RandomState(seed)
    rates = np.sort(rng.uniform(200, 4000, (2, 4)), 1)
    psnr = np.sort(rng.uniform(30, 44, (2, 4)), 1)
    anchor, test = (list(zip(rates[k], psnr[k])) for k in range(2))
    for fn in ("bd_rate", "bd_psnr"):
        assert getattr(p_bd, fn)(anchor, test) == getattr(r_bd, fn)(anchor,
                                                                    test)


@BDS
@pytest.mark.parametrize("kind", ["luma", "luma_ps", "chroma", "chroma_ps",
                                  "bi_avg", "uni_round"])
def test_interp(kind, bd):
    rng = np.random.RandomState(len(kind))
    if kind in ("bi_avg", "uni_round"):
        # 14-bit predictions of the whole range (the clip both ways)
        p0, p1 = (rng.randint(-10000, 26000, (12, 16, 16)).astype(np.int32)
                  for _ in range(2))
        if kind == "bi_avg":
            _eq(r_interp.bi_avg(jnp.asarray(p0), jnp.asarray(p1), bd),
                p_interp.bi_avg(_t(p0), _t(p1), bd))
        else:
            _eq(r_interp.uni_round(jnp.asarray(p0), bd),
                p_interp.uni_round(_t(p0), bd))
        return
    luma = kind.startswith("luma")
    n, taps, phases = (16, 8, 4) if luma else (8, 4, 8)
    win = rng.randint(0, 1 << bd, (12, n + taps - 1, n + taps - 1)).astype(
        np.int32)
    if bd == 10:                        # samples at 0 and 1023
        win[0] = 0
        win[1] = 1023
        win[2, ::2] = 1023
        win[2, 1::2] = 0
    fx = rng.randint(0, phases, 12).astype(np.int32)
    fy = rng.randint(0, phases, 12).astype(np.int32)
    fr = getattr(r_interp, f"mc_{kind.split('_')[0]}_batch"
                 + ("_ps" if kind.endswith("_ps") else ""))
    fp = getattr(p_interp, f"mc_{kind.split('_')[0]}_batch"
                 + ("_ps" if kind.endswith("_ps") else ""))
    _eq(fr(jnp.asarray(win), jnp.asarray(fx), jnp.asarray(fy), n, n, bd),
        fp(_t(win), _t(fx), _t(fy), n, n, bd))


@pytest.mark.parametrize("n", [8, 16, 32])
def test_level_bits(n):
    rng = np.random.RandomState(n)
    lv = (rng.randint(-3000, 3001, (9, n, n))
          * (rng.rand(9, n, n) < 0.2)).astype(np.int32)
    lv[0] = 0
    _eq(r_rdcost.level_bits_jnp(jnp.asarray(lv)), p_rdcost.level_bits(_t(lv)))


def _picture(seed, ph=128, pw=192, bd=8):
    """Blocky content with a little noise; at 10 bits scaled by 4 with 4
    times the noise and a band at each end of the range."""
    rng = np.random.RandomState(seed)
    base = rng.randint(40, 200, (ph // 8, pw // 8))
    s = 1 << (bd - 8)
    y = (np.kron(s * base, np.ones((8, 8), int))
         + rng.randint(-6 * s, 6 * s + 1, (ph, pw)))
    if bd == 10:
        y[:, :16] -= 1024
        y[:, pw // 2:pw // 2 + 16] += 1024
    return rng, np.clip(y, 0, (1 << bd) - 1).astype(np.int32)


@BDS
@pytest.mark.parametrize("inter", [False, True])
def test_deblock_picture(inter, bd):
    rng, y = _picture(3, bd=bd)
    ph, pw = y.shape
    g = PictureGeometry(176, 120, 6, 3)
    s, m = 1 << (bd - 8), (1 << bd) - 1
    cb = np.clip(y[::2, ::2] + rng.randint(-9 * s, 9 * s + 1,
                                           (ph // 2, pw // 2)), 0,
                 m).astype(np.int32)
    cr = np.clip(m - cb, 0, m).astype(np.int32)
    h4, w4 = ph // 4, pw // 4
    intra4 = (rng.rand(h4, w4) < 0.5) if inter else np.ones((h4, w4), bool)
    cbf4 = rng.rand(h4, w4) < 0.5
    mv4 = rng.randint(-9, 10, (h4, w4, 2)).astype(np.int32)
    use32 = rng.rand(ph // 32, pw // 32) < 0.5
    masks = r_db.edge_masks_np(g, 6)
    motion_b = None
    if inter:
        poc = rng.randint(0, 3, (h4, w4)).astype(np.int32)
        motion_b = (np.ones((h4, w4), np.int32), mv4, mv4, poc, poc)
    qps = (37, 35, 36)
    ref = r_db.deblock_picture_jnp(
        tuple(jnp.asarray(p) for p in (y, cb, cr)), jnp.asarray(intra4),
        jnp.asarray(cbf4), jnp.asarray(mv4), jnp.asarray(use32), masks,
        *qps, bd, 1, -1,
        motion_b=None if motion_b is None else tuple(
            jnp.asarray(m) for m in motion_b))
    port = p_db.deblock_picture(
        tuple(_t(p) for p in (y, cb, cr)), _t(intra4), _t(cbf4), _t(mv4),
        _t(use32), p_db.edge_masks_np(PGeometry(176, 120, 6, 3), 6), *qps,
        bd, 1, -1,
        motion_b=None if motion_b is None else tuple(_t(m)
                                                     for m in motion_b))
    for a, b in zip(ref, port):
        _eq(a, b)


@BDS
@pytest.mark.parametrize("chroma", [False, True])
def test_sao(chroma, bd):
    rng, orig = _picture(5, bd=bd)
    if chroma:
        orig = orig[::2, ::2]
    ph, pw = orig.shape
    s, m = 1 << (bd - 8), (1 << bd) - 1
    rec = np.clip(orig + rng.randint(-7 * s, 7 * s + 1, orig.shape), 0,
                  m).astype(np.int32)
    ctb = 32 if chroma else 64
    chh, cww = ph // ctb, pw // ctb
    eo, inside = r_sao.eo_valid_masks_np(ph, pw, pw - 8, ph - 8)
    peo, pinside = p_sao.eo_valid_masks_np(ph, pw, pw - 8, ph - 8)
    ref = r_sao.sao_estimate_plane_jnp(jnp.asarray(orig), jnp.asarray(rec),
                                       chh, cww, ctb, jnp.asarray(eo),
                                       jnp.asarray(inside), bd)
    port = p_sao.sao_estimate_plane(_t(orig), _t(rec), chh, cww, ctb,
                                    _t(peo), _t(pinside), bd)
    for a, b in zip(ref, port):
        _eq(a, b)
    types = rng.randint(0, 3, (chh, cww)).astype(np.int32)
    classes = rng.randint(0, 4, (chh, cww)).astype(np.int32)
    bpos = rng.randint(0, 32, (chh, cww)).astype(np.int32)
    # offsets up to 2^(min(bd, 10) - 5) - 1 (7 at 8 bits, 31 at 10)
    om = (1 << (min(bd, 10) - 5)) - 1
    offs = rng.randint(-om, om + 1, (chh, cww, 4)).astype(np.int32)
    _eq(r_sao.sao_apply_plane_jnp(jnp.asarray(rec), chh, cww, ctb,
                                  jnp.asarray(types), jnp.asarray(classes),
                                  jnp.asarray(bpos), jnp.asarray(offs),
                                  jnp.asarray(eo), bd),
        p_sao.sao_apply_plane(_t(rec), chh, cww, ctb, _t(types), _t(classes),
                              _t(bpos), _t(offs), _t(peo), bd))


def test_mv_bits_table_is_jnp_under_jit():
    """The committed table equals the reference's own mv_bits evaluated by
    XLA on the CPU (device_pipeline.py ``mv_bits``), and the lookup
    reproduces it; torch's log2 would differ by one ulp on many inputs."""
    def ref_bits(dq):
        a = jnp.abs(dq).astype(jnp.float32)
        return jnp.where(a == 0, 0.718, 2.0 * jnp.log2(a + 1.0) + 1.718)

    d = np.arange(-1023, 1024, dtype=np.int32)
    want = np.asarray(jax.jit(ref_bits)(jnp.asarray(d)))
    _eq(want, mv_bits(_t(d)))
    assert mv_bits_table().dtype == np.float32
    with pytest.raises(RuntimeError):
        mv_bits(_t(np.array([1024], np.int32)))


def test_tables_match_reference():
    """tables_to_torch over x265_tpu's arrays equals the port's tables."""
    from x265_tpu.ops.intra import ANGLES, INV_ANGLES

    ref = {f"dct{n}": r_tr.dct_matrix(n) for n in (4, 8, 16, 32)}
    ref.update(dst4=r_tr.DST4, quant_scales=r_quant.QUANT_SCALES,
               inv_quant_scales=r_quant.INV_QUANT_SCALES,
               diag4_rank=r_quant.DIAG4_RANK,
               luma_filters=r_interp.LUMA_FILTERS,
               chroma_filters=r_interp.CHROMA_FILTERS,
               intra_angles=ANGLES,
               intra_inv_angles=np.array(sorted(INV_ANGLES.items()),
                                         np.int32),
               mv_bits=mv_bits_table())
    a = convert.tables_to_torch(ref, "cpu")
    b = convert.tables_to_torch(convert.port_tables(), "cpu")
    for k in convert.TABLE_NAMES:
        assert torch.equal(a[k], b[k]), k
