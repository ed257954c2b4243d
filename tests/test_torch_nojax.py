"""x265_tpu_torch without JAX, as on the GPU machine: in a fresh process
where ``import jax`` fails, the port imports and encodes a 64x64 I frame
whose stream has the expected structure."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.path.insert(0, ROOT)
import numpy as np
import x265_tpu_torch
from x265_tpu_torch import Encoder, Params
from x265_tpu_torch.encoder import ctu_scan, device_pipeline, me_cuda
rng = np.random.RandomState(0)
planes = (rng.randint(0, 256, (64, 64)).astype(np.uint8),
          rng.randint(0, 256, (32, 32)).astype(np.uint8),
          rng.randint(0, 256, (32, 32)).astype(np.uint8))
enc = Encoder(Params(source_width=64, source_height=64, bframes=0,
                     decoded_picture_hash=3), device="cpu")
hdr = enc.headers()
au, rec = enc.encode_frame(planes)
assert hdr.startswith(b"\x00\x00\x00\x01") and len(au) > 100
assert [p.shape for p in rec] == [(64, 64), (32, 32), (32, 32)]
print("NOJAX-OK", len(hdr), len(au))
"""


def test_port_runs_without_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", f"ROOT = {ROOT!r}\n" + SCRIPT],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NOJAX-OK" in r.stdout
