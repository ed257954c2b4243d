"""Streams with RDOQ and noise reduction on the CPU: x265_tpu_torch's
Encoder against x265_tpu's, byte for byte, each stream decoding with
matching picture hashes in x265_tpu's decoder.

* slow: ``default_params("slow")`` (RDOQ with psy-RDOQ 1.0, ref=4,
  cuTree) at 128x64, four frames of ``test_aq_lookahead.structured_clip``
  through the cuTree lookahead, with ``bframes=0`` and ``rc_lookahead=3``
  to keep the reference's programs few and the window short (B frames
  with RDOQ: the scan tests, and the slow slice on the card);
* nr: the twin of tests/test_noise_reduction.py's clip (96x64, six noisy
  frames, I P P ...) with ``noise_reduction_intra=inter=600``: the
  offsets the host learns after each frame equal the reference's;
* main10: an I P stream at Main10 with RDOQ (``rdoq_level=2``,
  psy-RDOQ 1.0) on ``smoke_config``'s 10-bit content.

The port's presets are a copy of the reference's (``default_params``)."""

import dataclasses

import numpy as np
import pytest

from test_aq_lookahead import structured_clip
from test_noise_reduction import _noisy_clip
from x265_tpu.common.params import Params as RefParams
from x265_tpu.common.params import default_params as ref_default_params
from x265_tpu.decoder import decode_annexb
from x265_tpu.encoder import Encoder as RefEncoder
from x265_tpu_torch import Params
from x265_tpu_torch.common.params import default_params
from x265_tpu_torch.encoder import ctu_scan_cuda
from x265_tpu_torch.encoder.intra_encoder import Encoder
from x265_tpu_torch.smoke_config import smoke_frames_bench10
from torch_threads import one_torch_thread  # noqa: F401

NR_KW = dict(source_width=96, source_height=64, qp=30, bframes=0,
             aq_mode=0, cu_tree=False, decoded_picture_hash=1, log_level=0,
             me_range=8, ref=1, weightp=False, noise_reduction_inter=600,
             noise_reduction_intra=600)
SLOW_KW = dict(source_width=128, source_height=64, decoded_picture_hash=1,
               log_level=0, me_range=8, bframes=0, rc_lookahead=3)
M10_KW = dict(source_width=128, source_height=64, me_range=8, bframes=0,
              rc_lookahead=0, internal_bit_depth=10, rdoq_level=2,
              psy_rdoq=1.0, decoded_picture_hash=1)


def _params(case, ref):
    if case == "slow":
        return (ref_default_params if ref else default_params)(
            "slow", **SLOW_KW)
    return (RefParams if ref else Params)(
        **(NR_KW if case == "nr" else M10_KW))


def _frames(case):
    if case == "slow":
        return structured_clip(128, 64, 4)
    if case == "nr":
        return _noisy_clip()
    return smoke_frames_bench10(128, 64, 2)


def _encode(enc, frames):
    """Access units (headers first), encode-order POCs, and the encoder's
    noise-reduction offsets after each finished frame."""
    aus, pocs, offs = [enc.headers()], [], []
    for planes in frames + [None]:
        out = enc.flush() if planes is None else enc.push_frame(planes)
        for ef in out:
            aus.append(ef.au)
            pocs.append(ef.poc)
            offs.append({k: v.copy() for k, v in enc._nr_offsets.items()})
    return aus, pocs, offs


@pytest.fixture(scope="module", params=["slow", "nr", "main10"])
def pair(request):
    case = request.param
    want = _encode(RefEncoder(_params(case, True)), _frames(case))
    counts = (ctu_scan_cuda.LAUNCHES, ctu_scan_cuda.LAUNCHES_RDOQ,
              ctu_scan_cuda.LAUNCHES_NR)
    enc = Encoder(_params(case, False), device="cpu")
    got = _encode(enc, _frames(case))
    assert (ctu_scan_cuda.LAUNCHES, ctu_scan_cuda.LAUNCHES_RDOQ,
            ctu_scan_cuda.LAUNCHES_NR) == counts    # CPU: the plain step
    return case, want, got, enc


def test_slow_preset_is_the_references():
    """The port's preset table is the reference's (tests/conftest.py
    patches the reference's Params defaults, so the tables are compared
    and the two parameter sets with the same explicit fields)."""
    from x265_tpu.common import params as ref_params
    from x265_tpu_torch.common import params as port_params
    assert port_params._PRESET_OVERRIDES == ref_params._PRESET_OVERRIDES
    assert port_params._TUNE_OVERRIDES == ref_params._TUNE_OVERRIDES
    assert dataclasses.asdict(_params("slow", False)) == dataclasses.asdict(
        _params("slow", True))
    p = default_params("slow")
    assert p.rdoq_level == 2 and p.psy_rdoq == 1.0 and p.ref == 4


def test_access_units_are_byte_identical(pair):
    case, (aw, pw, _ow), (ag, pg, _og), enc = pair
    assert pg == pw
    assert [len(a) for a in ag] == [len(a) for a in aw]
    for i, (a, b) in enumerate(zip(aw, ag)):
        assert a == b, f"access unit {i} of {case} differs"
    scan = enc._get_ctu_scan()
    assert scan.rdoq == (case != "nr")
    assert scan.noise_reduction == (case == "nr")
    if case == "slow":
        assert enc.num_ref == 4 and enc.lookahead.cutree


def test_stream_decodes_with_hashes(pair):
    _case, _want, (ag, pg, _og), _enc = pair
    pics = decode_annexb(b"".join(ag))
    assert len(pics) == len(pg)
    assert all(p.hash_ok for p in pics)


def test_nr_offsets_follow_the_reference(pair):
    """The offsets learned after every frame equal the reference's (the
    NR sums the device returns are the reference scan's); they move off
    zero, and DC is never denoised."""
    case, (_aw, _pw, ow), (_ag, _pg, og), _enc = pair
    assert len(og) == len(ow)
    for a, b in zip(ow, og):
        assert sorted(a) == sorted(b)
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    if case == "nr":
        assert any(v.any() for v in og[-1].values())
        assert all(v[0] == 0 for v in og[-1].values())
    else:
        assert og[-1] == {}
