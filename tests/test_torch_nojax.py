"""x265_tpu_torch without JAX and without x265_tpu, as on the GPU machine:
in a fresh process where ``import jax`` and ``import x265_tpu`` both fail,
the port imports and encodes a 128x64 I P pair, then one B mini-GOP
(I0 P3 B1 B2, the two Bs batched), then six frames at the Params()
defaults through the lookahead (cuTree, the b-adapt trellis), then a
Main10 mini-GOP (10-bit frames, the lookahead on), then a B mini-GOP with
RDOQ (psy-RDOQ 1.0) and noise reduction, then an I P pair at CTU 32, then
the CLI at CRF with VBV and HRD and a lossless encode_sequence, then two
closed GOPs through encode_gop_parallel and the wavefront intra recon of a
luma plane, then decodes the I P pair and the B mini-GOP with the port's
own decoder (every picture hash good), all on the CPU, and the streams
have the expected structure."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["x265_tpu"] = None     # and so does any `import x265_tpu...`
sys.path.insert(0, ROOT)
import torch
torch.set_num_threads(1)           # the suite's workers share the cores
import numpy as np
import x265_tpu_torch
from x265_tpu_torch import Encoder, Params
from x265_tpu_torch.encoder import ctu_scan, device_pipeline, me_cuda
rng = np.random.RandomState(0)
y = rng.randint(0, 256, (64, 128)).astype(np.uint8)
c = [rng.randint(0, 256, (32, 64)).astype(np.uint8) for _ in range(2)]
enc = Encoder(Params(source_width=128, source_height=64, bframes=0,
                     me_range=16, decoded_picture_hash=3), device="cpu")
hdr = enc.headers()
aus = [enc.encode_frame((np.roll(y, 2 * t, axis=1), c[0], c[1]))
       for t in range(2)]
assert hdr.startswith(b"\x00\x00\x00\x01") and b"x265_tpu 0.1.0" in hdr
for au, rec in aus:
    assert au.startswith(b"\x00\x00\x00\x01") and len(au) > 100
    assert [p.shape for p in rec] == [(64, 128), (32, 64), (32, 64)]
assert [enc.last_slice_type_str] == ["P"]
encb = Encoder(Params(source_width=128, source_height=64, bframes=2,
                      b_pyramid=False, rc_lookahead=0, me_range=16,
                      decoded_picture_hash=3), device="cpu")
efs = []
for t in range(4):
    efs += encb.push_frame((np.roll(y, 2 * t, axis=1), c[0], c[1]))
efs += encb.flush()
assert [(ef.poc, ef.kind) for ef in efs] == [(0, "I"), (3, "P"), (1, "B"),
                                             (2, "B")]
assert all(ef.au.startswith(b"\x00\x00\x00\x01") for ef in efs)
assert all(ef.recon[0].shape == (64, 128) for ef in efs)
# Params() defaults: bframes 4, b-adapt 2, cuTree over rc_lookahead 20
encl = Encoder(Params(source_width=128, source_height=64, me_range=16,
                      decoded_picture_hash=3), device="cpu")
efl = []
for t in range(6):
    efl += encl.push_frame((np.roll(y, 2 * t, axis=1), c[0], c[1]))
assert not efl                     # the window holds every frame
efl += encl.flush()
assert sorted(ef.poc for ef in efl) == list(range(6)) and efl[0].kind == "I"
assert encl.lookahead.calls["lowres"] == 6 and encl.lookahead.calls["pair"]
assert encl.lookahead.devices == {"cpu"}
# Main10: a B mini-GOP of 10-bit frames through the cuTree lookahead
from x265_tpu_torch.smoke_config import smoke_frames_bench10
enc10 = Encoder(Params(source_width=128, source_height=64, bframes=2,
                       b_pyramid=False, b_adapt=0, rc_lookahead=3,
                       me_range=16, internal_bit_depth=10,
                       decoded_picture_hash=1), device="cpu")
ef10 = []
for planes in smoke_frames_bench10(128, 64, 4):
    ef10 += enc10.push_frame(planes)
ef10 += enc10.flush()
assert [(ef.poc, ef.kind) for ef in ef10] == [(0, "I"), (3, "P"), (1, "B"),
                                              (2, "B")]
assert all(ef.recon[0].dtype == np.uint16 for ef in ef10)
assert enc10.sps.bit_depth_luma == 10 and enc10.headers()
# RDOQ + psy-RDOQ and noise reduction through a B mini-GOP
encr = Encoder(Params(source_width=128, source_height=64, bframes=2,
                      b_pyramid=False, rc_lookahead=0, me_range=16,
                      rdoq_level=2, psy_rdoq=1.0, noise_reduction_intra=600,
                      noise_reduction_inter=600, decoded_picture_hash=3),
               device="cpu")
efr = []
for t in range(4):
    efr += encr.push_frame((np.roll(y, 2 * t, axis=1), c[0], c[1]))
efr += encr.flush()
assert [(ef.poc, ef.kind) for ef in efr] == [(0, "I"), (3, "P"), (1, "B"),
                                             (2, "B")]
scan = encr._get_ctu_scan()
assert scan.rdoq and scan.noise_reduction
assert any(v.any() for v in encr._nr_offsets.values())
# CTU 32: 4 x 2 CTBs, 6 wavefront levels
encc = Encoder(Params(source_width=128, source_height=64, bframes=0,
                      ctu_size=32, me_range=16, decoded_picture_hash=1),
               device="cpu")
auc = [encc.encode_frame((np.roll(y, 2 * t, axis=1), c[0], c[1]))[0]
       for t in range(2)]
assert encc._get_ctu_scan().t["n_levels"] == 6 and encc.headers()
assert all(au.startswith(b"\x00\x00\x00\x01") and len(au) > 100
           for au in auc)
# the CLI at CRF with ABR's VBV and HRD (I P P: buffering period on the
# IDR, picture timing on every AU), then a lossless encode_sequence
import os
import tempfile
from x265_tpu_torch import cli, io
from x265_tpu_torch.encoder import encode_sequence
with tempfile.TemporaryDirectory() as tmp:
    inp, out = os.path.join(tmp, "in.y4m"), os.path.join(tmp, "out.265")
    io.write_y4m(inp, [(np.roll(y, 2 * t, axis=1), c[0], c[1])
                       for t in range(3)], 128, 64)
    assert cli.main([inp, "-o", out, "--crf", "28", "--vbv-maxrate", "100",
                     "--vbv-bufsize", "100", "--hrd", "--bframes", "0",
                     "--merange", "16", "--hash", "md5", "--no-progress",
                     "--csv", os.path.join(tmp, "log.csv"),
                     "--device", "cpu"]) == 0
    hrd_stream = open(out, "rb").read()
    csv_lines = open(os.path.join(tmp, "log.csv")).read().splitlines()
assert len(csv_lines) == 4 and csv_lines[1].startswith("0,I,")
sei_heads = [n[2:4] for n in hrd_stream.split(b"\x00\x00\x01")[1:]
             if (n[0] >> 1) & 0x3F == 39 and n[2] in (0, 1)]
assert sei_heads[0][0] == 0 and len(sei_heads) == 3, sei_heads
lframes = [tuple(rng.randint(0, 256, s).astype(np.uint8)
                 for s in ((64, 128), (32, 64), (32, 64)))
           for _ in range(2)]
ll_stream, ll_rec = encode_sequence(
    lframes, Params(source_width=128, source_height=64, lossless=True,
                    decoded_picture_hash=1, log_level=0), device="cpu")
assert all(np.array_equal(a, b) for fa, fb in zip(lframes, ll_rec)
           for a, b in zip(fa, fb))
# GOP-parallel: two closed IPPP GOPs of two frames, a batched dispatch a
# round; then the wavefront intra recon of one luma plane
from x265_tpu_torch.encoder.wavefront import WavefrontIntraRecon
from x265_tpu_torch.parallel import encode_gop_parallel
gop_stream = encode_gop_parallel(
    [(np.roll(y, 2 * t, axis=1), c[0], c[1]) for t in range(4)],
    Params(source_width=128, source_height=64, bframes=0, keyint_max=2,
           scenecut_threshold=0, cu_tree=False, me_range=16,
           decoded_picture_hash=3), 2, device="cpu")
assert gop_stream.count(b"\x00\x00\x01\x26\x01") == 2     # an IDR a GOP
wf = WavefrontIntraRecon(128, 64, 6, 16, is_luma=True, device="cpu")
wf_plane, wf_levels = wf.encode(
    y.astype(np.int32).reshape(4, 16, 8, 16).transpose(0, 2, 1, 3).reshape(
        -1, 16, 16), np.arange(32, dtype=np.int32) % 35, 30)
assert torch.equal(wf.decode(wf_levels, np.arange(32) % 35, 30), wf_plane)
# the port's decoder on the I P pair and the B mini-GOP
from x265_tpu_torch.decoder import decode_annexb
pics = decode_annexb(hdr + b"".join(au for au, _ in aus), device="cpu")
assert [p.poc for p in pics] == [0, 1]
assert all(p.hash_ok is True for p in pics)
pics_b = decode_annexb(encb.headers() + b"".join(ef.au for ef in efs),
                       device="cpu")
assert [p.poc for p in pics_b] == [0, 1, 2, 3]
assert all(p.hash_ok is True for p in pics_b)
assert np.array_equal(pics[1].planes[0], aus[1][1][0])
assert not any(m == "jax" or m.startswith(("jax.", "x265_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("NOJAX-OK", len(hdr), [len(au) for au, _ in aus],
      [len(ef.au) for ef in efs], [(ef.poc, ef.kind) for ef in efl],
      [len(ef.au) for ef in ef10], [len(ef.au) for ef in efr],
      [len(au) for au in auc], len(hrd_stream), len(ll_stream),
      len(gop_stream))
"""


def test_port_runs_without_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", f"ROOT = {ROOT!r}\n" + SCRIPT],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NOJAX-OK" in r.stdout
