"""Streams at 32x32 and 16x16 CTBs on the CPU: x265_tpu_torch's Encoder
against x265_tpu's, byte for byte, each stream decoding with matching MD5
picture hashes in x265_tpu's decoder.  192x128, QP 32, ``me_range=16``,
the MD5 hash SEI, on the bench's panning content:

* superfast: ``default_params("superfast")`` (CTU 32, ``bframes=3`` with a
  fixed GOP, one reference, subme 1, no AQ or cuTree), six frames through
  ``push_frame`` / ``flush``: I0 P4 B2 B1 B3 P5;
* ultrafast: ``default_params("ultrafast")`` (also subme 0, no SAO, no
  sign hiding), the same six frames and order;
* ctu16: ``Params(ctu_size=16, bframes=0)``, I P P through
  ``encode_frame``.

Both packages get the same explicit fields (tests/conftest.py patches the
reference's ``Params`` defaults); the preset tables themselves are held
equal by tests/test_torch_rdoq_streams.py."""

import dataclasses

import numpy as np
import pytest

from x265_tpu.common.params import Params as RefParams
from x265_tpu.decoder import decode_annexb
from x265_tpu.encoder import Encoder as RefEncoder
from x265_tpu_torch import Params
from x265_tpu_torch.common.params import default_params
from x265_tpu_torch.encoder import ctu_scan_cuda, me_cuda
from x265_tpu_torch.encoder.intra_encoder import Encoder
from x265_tpu_torch.smoke_config import synthetic_frame
from torch_threads import one_torch_thread  # noqa: F401

W, H = 192, 128
KW = dict(source_width=W, source_height=H, qp=32, me_range=16,
          decoded_picture_hash=1)
ORDER = [(0, "I"), (4, "P"), (2, "B"), (1, "B"), (3, "B"), (5, "P")]


def _params(case):
    """The port's parameters of ``case``."""
    if case == "ctu16":
        return Params(ctu_size=16, bframes=0, **KW)
    return default_params(case, **KW)


def _frames(n):
    base = synthetic_frame(W, H, 0)
    return [(np.roll(base[0], 3 * t, axis=1), base[1], base[2])
            for t in range(n)]


def _encode(enc, case):
    """Access units (headers first), encode-order (POC, kind), recons."""
    aus, order, recs = [enc.headers()], [], []
    if case == "ctu16":
        for t, planes in enumerate(_frames(3)):
            au, rec = enc.encode_frame(planes)
            aus.append(au)
            order.append((t, "I" if t == 0 else "P"))
            recs.append(rec)
        return aus, order, recs
    for planes in _frames(6) + [None]:
        for ef in enc.flush() if planes is None else enc.push_frame(planes):
            aus.append(ef.au)
            order.append((ef.poc, ef.kind))
            recs.append(ef.recon)
    return aus, order, recs


@pytest.fixture(scope="module", params=["superfast", "ultrafast", "ctu16"])
def pair(request):
    case = request.param
    p = _params(case)
    want = _encode(RefEncoder(RefParams(**dataclasses.asdict(p))), case)
    n1, n2 = ctu_scan_cuda.LAUNCHES, me_cuda.LAUNCHES
    enc = Encoder(p, device="cpu")
    got = _encode(enc, case)
    # CPU tensors: the plain versions ran, not the kernels
    assert (ctu_scan_cuda.LAUNCHES, me_cuda.LAUNCHES) == (n1, n2)
    return case, want, got, enc


def test_access_units_are_byte_identical(pair):
    case, (aw, ow, _rw), (ag, og, _rg), enc = pair
    assert og == ow
    if case != "ctu16":
        assert og == ORDER
    assert [len(a) for a in ag] == [len(a) for a in aw]
    for i, (a, b) in enumerate(zip(aw, ag)):
        assert a == b, f"access unit {i} of {case} differs"
    ctb = 16 if case == "ctu16" else 32
    assert enc.geom.log2_ctb == ctb.bit_length() - 1
    assert enc._get_ctu_scan().t["has32"] == (ctb == 32)


def test_recons_are_the_references(pair):
    _case, (_aw, _ow, rw), (_ag, _og, rg), _enc = pair
    assert len(rg) == len(rw)
    for ra, rb in zip(rw, rg):
        for pa, pb in zip(ra, rb):
            assert np.array_equal(np.asarray(pa), np.asarray(pb))


def test_stream_decodes_with_hashes(pair):
    _case, _want, (ag, og, _rg), _enc = pair
    pics = decode_annexb(b"".join(ag))
    assert len(pics) == len(og)
    assert all(p.hash_ok for p in pics)
