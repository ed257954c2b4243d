"""The plain reference decoder judges a tiny stream that the port encodes
on the CPU: the stream as encoded passes, and one flipped byte in a
picture's residual data fails."""

import numpy as np
import pytest

from perfbench import check
from perfbench.refdec.decoder import index_stream


def _encode(preset, n=9, **kw):
    from x265_tpu_torch.common.params import default_params
    from x265_tpu_torch.encoder.intra_encoder import Encoder
    from perfbench import content
    from perfbench.harness import host_planes
    p = default_params(preset, source_width=128, source_height=96,
                       decoded_picture_hash=1, **kw)
    enc = Encoder(p, device="cpu")
    motion = []
    store = enc._store_col_motion

    def keep(ps, poc):
        store(ps, poc)
        motion.append(enc._col_store[poc])
    enc._store_col_motion = keep
    traffic = dict(pool_frames=n, pan_px=[2, 6], objects=[2, 3],
                   object_px=[2, 8], noise=2)
    aus, recon = [enc.headers()], []
    efs = []
    for f in content.generate(traffic, 128, 96, 21):
        efs += enc.push_frame(f)
    efs += enc.flush()
    for ef in efs:
        aus.append(ef.au)
        recon.append(host_planes(ef.coded))
    return aus, recon, motion


@pytest.fixture(scope="module")
def medium():
    return _encode("medium", rc_mode=1, crf=28.0, rc_lookahead=5)


def _judge(aus, recon, motion, sample):
    return check.judge(b"".join(aus), len(recon), recon, motion, sample,
                       None, "cpu")


def test_stream_as_encoded_passes(medium):
    aus, recon, motion = medium
    pics = index_stream(b"".join(aus))
    assert sorted(e.display for e in pics) == list(range(len(recon)))
    assert {e.slice_type for e in pics} >= {0, 1, 2}   # B, P and I
    nums = _judge(aus, recon, motion, list(range(len(recon))))
    assert nums == dict(pictures_missing=0, samples_differing=0,
                        hash_mismatches=0, motion_mismatches=0)
    assert check.verdict(nums)


def _flip_residual_byte(au: bytes) -> bytes:
    """One byte flipped three quarters into the AU's first NAL unit (its
    slice data: the residual is most of it)."""
    end = au.find(b"\x00\x00\x01", 4)
    end = len(au) if end < 0 else end
    i = 4 + (end - 4) * 3 // 4
    return au[:i] + bytes([au[i] ^ 0x21]) + au[i + 1:]


@pytest.mark.parametrize("k", [0, 1, 3])
def test_flipped_residual_byte_fails(medium, k):
    aus, recon, motion = medium
    bad = list(aus)
    bad[k + 1] = _flip_residual_byte(bad[k + 1])
    nums = _judge(bad, recon, motion, [k])
    assert not check.verdict(nums)
    assert nums["samples_differing"] > 0 or nums["hash_mismatches"] > 0


def test_wrong_reference_planes_fail(medium):
    aus, recon, motion = medium
    pics = index_stream(b"".join(aus))
    k = next(e.order for e in pics if e.refs_l0)
    ref = next(p.order for p in pics if p.poc == pics[k].refs_l0[0]
               and p.cvs == pics[k].cvs)
    wrong = list(recon)
    wrong[ref] = tuple(np.clip(p.astype(np.int16) + 3, 0, 255).astype(
        np.uint8) for p in recon[ref])
    nums = _judge(aus, wrong, motion, [k])
    assert nums["samples_differing"] > 0 and nums["hash_mismatches"] == 1


def test_live_stream_passes():
    aus, recon, motion = _encode("ultrafast", n=10, rc_mode=2, bitrate=30,
                                 vbv_max_bitrate=30, vbv_buffer_size=30)
    nums = _judge(aus, recon, motion, list(range(len(recon))))
    assert check.verdict(nums), nums


def test_references_import_nothing_of_the_program():
    import subprocess
    import sys
    code = ("import sys; import perfbench.refdec.decoder, "
            "perfbench.refenc.step, perfbench.refenc.refine, "
            "perfbench.refenc.settings; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('x265_tpu', 'x265_tpu_torch', 'jax')))")
    root = __file__.rsplit("/perfbench/", 1)[0]
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("preset", ["ultrafast", "superfast", "veryfast",
                                    "faster", "fast", "medium", "slow",
                                    "slower", "veryslow", "placebo"])
@pytest.mark.parametrize("tune", [None, "psnr", "ssim", "grain",
                                  "fastdecode", "zerolatency"])
def test_step_settings_follow_the_presets(preset, tune):
    """The reference's frozen copy of the preset and tune values that the
    two steps read agrees with the port's tables."""
    from x265_tpu_torch.common.params import default_params
    from perfbench.refenc.settings import DEFAULTS, configured
    p = default_params(preset, tune=tune)
    c = configured(dict(preset=preset, tune=tune, params={}))
    assert c == {k: getattr(p, k) for k in DEFAULTS}
