"""x265_tpu_torch ops against their x265_tpu (jnp) twins on the CPU.

Every comparison is exact (np.array_equal): the math is integer, and the
float costs are integer-valued or rounded the reference's way.
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


def _eq(ref, port):
    ref = np.asarray(ref)
    port = port.cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    assert ref.shape == port.shape, (ref.shape, port.shape)
    assert np.array_equal(ref, port), int((ref != port).sum())


@pytest.mark.parametrize("n,dst", [(4, True), (4, False), (8, False),
                                   (16, False), (32, False)])
def test_transforms(n, dst):
    rng = np.random.RandomState(n)
    resi = rng.randint(-255, 256, (6, n, n)).astype(np.int32)
    _eq(r_tr.forward_transform(jnp.asarray(resi), 8, dst=dst),
        p_tr.forward_transform(_t(resi), 8, dst=dst))
    coef = rng.randint(-32768, 32768, (6, n, n)).astype(np.int32)
    coef[:3] //= 64
    _eq(r_tr.inverse_transform(jnp.asarray(coef), 8, dst=dst),
        p_tr.inverse_transform(_t(coef), 8, dst=dst))


@pytest.mark.parametrize("n", [8, 16, 32])
def test_quant_dequant_sign_hide(n):
    rng = np.random.RandomState(n)
    coef = (rng.randint(-4000, 4001, (8, n, n))
            * (rng.rand(8, n, n) < 0.4)).astype(np.int32)
    qp = rng.randint(0, 52, 8).astype(np.int32)
    mask = rng.rand(8) < 0.5
    for intra in (True, False):
        _eq(r_quant.quant(jnp.asarray(coef), jnp.asarray(qp), 8, intra),
            p_quant.quant(_t(coef), _t(qp), 8, intra))
    lv = r_quant.quant_masked(jnp.asarray(coef), jnp.asarray(qp),
                              jnp.asarray(mask), 8)
    _eq(lv, p_quant.quant_masked(_t(coef), _t(qp), _t(mask), 8))
    lv = np.asarray(lv)
    _eq(r_quant.dequant(jnp.asarray(lv), jnp.asarray(qp), 8),
        p_quant.dequant(_t(lv), _t(qp), 8))
    _eq(r_quant.sign_hide_diag(jnp.asarray(lv)), p_quant.sign_hide_diag(
        _t(lv)))


@pytest.mark.parametrize("n,luma", [(4, True), (8, True), (8, False),
                                    (16, True), (16, False), (32, True)])
def test_intra_predict(n, luma):
    rng = np.random.RandomState(n + luma)
    raw = rng.randint(0, 256, (5, 4 * n + 1)).astype(np.int32)
    av = rng.rand(5, 4 * n + 1) < 0.7
    av[0] = False                       # nothing available: mid-grey
    av[1, :n] = False                   # leading gap
    ref_sub = r_intra.substitute_references(jnp.asarray(raw), jnp.asarray(av),
                                            8)
    _eq(ref_sub, p_intra.substitute_references(_t(raw), _t(av), 8))
    refs = np.asarray(ref_sub)
    _eq(r_intra.predict_all_modes(jnp.asarray(refs), n, luma, 8),
        p_intra.predict_all_modes(_t(refs), n, luma, 8))
    modes = rng.randint(0, 35, 5).astype(np.int32)
    _eq(r_wf._substitute(jnp.asarray(raw), jnp.asarray(av), 8),
        p_wf._substitute(_t(raw), _t(av), 8))
    _eq(r_wf._predict_lanes(jnp.asarray(refs), jnp.asarray(modes), n, luma,
                            8),
        p_wf._predict_lanes(_t(refs), _t(modes), n, luma, 8))


@pytest.mark.parametrize("n", [8, 16, 32])
def test_costs(n):
    rng = np.random.RandomState(n)
    a = rng.randint(0, 256, (7, n, n)).astype(np.int32)
    b = rng.randint(0, 256, (7, n, n)).astype(np.int32)
    _eq(r_cost.sad(jnp.asarray(a), jnp.asarray(b)), p_cost.sad(_t(a), _t(b)))
    _eq(r_cost.satd(jnp.asarray(a), jnp.asarray(b)),
        p_cost.satd(_t(a), _t(b)))
    _eq(r_cost.psy_cost(jnp.asarray(a), jnp.asarray(b)),
        p_cost.psy_cost(_t(a), _t(b)))


@pytest.mark.parametrize("kind", ["luma", "luma_ps", "chroma", "chroma_ps",
                                  "bi_avg"])
def test_interp(kind):
    rng = np.random.RandomState(len(kind))
    if kind == "bi_avg":
        # two 14-bit predictions of the whole range (the clip both ways)
        p0, p1 = (rng.randint(-10000, 26000, (12, 16, 16)).astype(np.int32)
                  for _ in range(2))
        _eq(r_interp.bi_avg(jnp.asarray(p0), jnp.asarray(p1), 8),
            p_interp.bi_avg(_t(p0), _t(p1), 8))
        return
    luma = kind.startswith("luma")
    n, taps, phases = (16, 8, 4) if luma else (8, 4, 8)
    win = rng.randint(0, 256, (12, n + taps - 1, n + taps - 1)).astype(
        np.int32)
    fx = rng.randint(0, phases, 12).astype(np.int32)
    fy = rng.randint(0, phases, 12).astype(np.int32)
    fr = getattr(r_interp, f"mc_{kind.split('_')[0]}_batch"
                 + ("_ps" if kind.endswith("_ps") else ""))
    fp = getattr(p_interp, f"mc_{kind.split('_')[0]}_batch"
                 + ("_ps" if kind.endswith("_ps") else ""))
    _eq(fr(jnp.asarray(win), jnp.asarray(fx), jnp.asarray(fy), n, n, 8),
        fp(_t(win), _t(fx), _t(fy), n, n, 8))


@pytest.mark.parametrize("n", [8, 16, 32])
def test_level_bits(n):
    rng = np.random.RandomState(n)
    lv = (rng.randint(-3000, 3001, (9, n, n))
          * (rng.rand(9, n, n) < 0.2)).astype(np.int32)
    lv[0] = 0
    _eq(r_rdcost.level_bits_jnp(jnp.asarray(lv)), p_rdcost.level_bits(_t(lv)))


def _picture(seed, ph=128, pw=192):
    rng = np.random.RandomState(seed)
    base = rng.randint(40, 200, (ph // 8, pw // 8))
    y = np.kron(base, np.ones((8, 8), int)) + rng.randint(-6, 7, (ph, pw))
    return rng, np.clip(y, 0, 255).astype(np.int32)


@pytest.mark.parametrize("inter", [False, True])
def test_deblock_picture(inter):
    rng, y = _picture(3)
    ph, pw = y.shape
    g = PictureGeometry(176, 120, 6, 3)
    cb = np.clip(y[::2, ::2] + rng.randint(-9, 10, (ph // 2, pw // 2)), 0,
                 255).astype(np.int32)
    cr = np.clip(255 - cb, 0, 255).astype(np.int32)
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
        *qps, 8, 1, -1,
        motion_b=None if motion_b is None else tuple(
            jnp.asarray(m) for m in motion_b))
    port = p_db.deblock_picture(
        tuple(_t(p) for p in (y, cb, cr)), _t(intra4), _t(cbf4), _t(mv4),
        _t(use32), p_db.edge_masks_np(PGeometry(176, 120, 6, 3), 6), *qps,
        8, 1, -1,
        motion_b=None if motion_b is None else tuple(_t(m)
                                                     for m in motion_b))
    for a, b in zip(ref, port):
        _eq(a, b)


@pytest.mark.parametrize("chroma", [False, True])
def test_sao(chroma):
    rng, orig = _picture(5)
    if chroma:
        orig = orig[::2, ::2]
    ph, pw = orig.shape
    rec = np.clip(orig + rng.randint(-7, 8, orig.shape), 0, 255).astype(
        np.int32)
    ctb = 32 if chroma else 64
    chh, cww = ph // ctb, pw // ctb
    eo, inside = r_sao.eo_valid_masks_np(ph, pw, pw - 8, ph - 8)
    peo, pinside = p_sao.eo_valid_masks_np(ph, pw, pw - 8, ph - 8)
    ref = r_sao.sao_estimate_plane_jnp(jnp.asarray(orig), jnp.asarray(rec),
                                       chh, cww, ctb, jnp.asarray(eo),
                                       jnp.asarray(inside), 8)
    port = p_sao.sao_estimate_plane(_t(orig), _t(rec), chh, cww, ctb,
                                    _t(peo), _t(pinside), 8)
    for a, b in zip(ref, port):
        _eq(a, b)
    types = rng.randint(0, 3, (chh, cww)).astype(np.int32)
    classes = rng.randint(0, 4, (chh, cww)).astype(np.int32)
    bpos = rng.randint(0, 32, (chh, cww)).astype(np.int32)
    offs = rng.randint(-7, 8, (chh, cww, 4)).astype(np.int32)
    _eq(r_sao.sao_apply_plane_jnp(jnp.asarray(rec), chh, cww, ctb,
                                  jnp.asarray(types), jnp.asarray(classes),
                                  jnp.asarray(bpos), jnp.asarray(offs),
                                  jnp.asarray(eo), 8),
        p_sao.sao_apply_plane(_t(rec), chh, cww, ctb, _t(types), _t(classes),
                              _t(bpos), _t(offs), _t(peo), 8))


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
