"""x265_tpu_torch stands on its own.

* No module of the port and no line of ``chip_smoke.py`` imports
  ``x265_tpu`` or ``bench``, at any depth (an ``ast`` walk, so imports
  inside functions count too).
* The port's copies agree with their originals: ``Params`` has the
  reference's fields and defaults; the deblock / SAO tables and masks and
  the CABAC context init are equal; and ``Encoder.headers()`` (VPS, SPS,
  PPS and the info SEI) is byte-identical between the two packages.

The encode with both ``jax`` and ``x265_tpu`` blocked is
``tests/test_torch_nojax.py``.
"""

import ast
import dataclasses
import glob
import os

import numpy as np
import pytest

import x265_tpu.encoder as ref_encoder
from x265_tpu.cabac import tables as r_tables
from x265_tpu.common import params as r_params
from x265_tpu.common.geometry import PictureGeometry as RefGeometry
from x265_tpu.ops import deblock as r_db
from x265_tpu.ops import sao as r_sao
from x265_tpu_torch.cabac import tables as p_tables
from x265_tpu_torch.common import params as p_params
from x265_tpu_torch.common.geometry import PictureGeometry
from x265_tpu_torch.encoder.intra_encoder import Encoder
from x265_tpu_torch.ops import deblock as p_db
from x265_tpu_torch.ops import sao as p_sao

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_sources():
    files = sorted(glob.glob(os.path.join(ROOT, "x265_tpu_torch", "**",
                                          "*.py"), recursive=True))
    return files + [os.path.join(ROOT, "chip_smoke.py")]


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("x265_tpu", "bench")


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_import_of_the_reference(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [(node.lineno, a.name) for a in node.names
                    if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append((node.lineno, node.module))
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)
              and _forbidden(str(node.args[0].value))):
            bad.append((node.lineno, node.args[0].value))
    assert not bad, bad


def test_params_fields_and_defaults():
    def fields(mod):
        return [(f.name, f.default, f.default_factory)
                for f in dataclasses.fields(mod.Params)]
    assert fields(p_params) == fields(r_params)
    # tests/conftest.py gives the reference's Params other defaults for
    # me_range and b_adapt, so instances are compared with both explicit
    for kw in (dict(), dict(source_width=1920, source_height=1080,
                            bframes=0)):
        kw.update(me_range=57, b_adapt=2)
        assert (dataclasses.asdict(p_params.Params(**kw))
                == dataclasses.asdict(r_params.Params(**kw)))
    for k in ("RC_CQP", "RC_CRF", "RC_ABR", "HASH_CHECKSUM", "ME_HEX"):
        assert getattr(p_params, k) == getattr(r_params, k), k
    p = dict(source_width=64, source_height=64, subme=5, rect=True)
    assert (p_params.unsupported_param_warnings(p_params.Params(**p))
            == r_params.unsupported_param_warnings(r_params.Params(**p)))


def test_copied_tables_and_masks():
    assert np.array_equal(p_db.BETA_TABLE, r_db.BETA_TABLE)
    assert np.array_equal(p_db.TC_TABLE, r_db.TC_TABLE)
    qp = np.arange(-20, 70)
    for off in (-12, 0, 5):
        assert np.array_equal(p_db._chroma_qp_arr(qp, off),
                              r_db._chroma_qp_arr(qp, off))
    for w, h in ((176, 120), (1920, 1088)):
        for a, b in zip(p_db.edge_masks_np(PictureGeometry(w, h, 6, 3), 6),
                        r_db.edge_masks_np(RefGeometry(w, h, 6, 3), 6)):
            assert np.array_equal(a, b)
        ph, pw = -(-h // 64) * 64, -(-w // 64) * 64
        for a, b in zip(p_sao.eo_valid_masks_np(ph, pw, w, h),
                        r_sao.eo_valid_masks_np(ph, pw, w, h)):
            assert np.array_equal(a, b)
    assert p_sao.EO_NEIGHBORS == r_sao.EO_NEIGHBORS
    assert p_tables.NUM_CTX == r_tables.NUM_CTX
    for init_type in (0, 1, 2):
        for qp in (0, 22, 37, 51):
            assert np.array_equal(p_tables.init_context_states(init_type, qp),
                                  r_tables.init_context_states(init_type, qp))


@pytest.mark.parametrize("kw", [dict(), dict(qp=27, ctu_size=64, aud=True,
                                             weightp=False, sao=False)])
def test_headers_byte_identical(kw):
    """VPS, SPS, PPS and the info SEI (on by default) of the two packages'
    encoders are the same bytes."""
    p = dict(source_width=1920, source_height=1080, bframes=0, me_range=57,
             b_adapt=2, **kw)
    want = ref_encoder.Encoder(r_params.Params(**p)).headers()
    got = Encoder(p_params.Params(**p), device="cpu").headers()
    assert b"x265_tpu 0.1.0 - TPU-native HEVC encoder" in got
    assert got == want
