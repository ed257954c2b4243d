"""x265_tpu_torch — the PyTorch / CUDA port of x265_tpu.

The port runs the encoder's device work on an NVIDIA GPU (Hopper, sm_90a)
with PyTorch for the plain tensor code and two hand-written CUDA kernels
for the two hot loops that were Pallas kernels in ``x265_tpu``:

  * K1, the CTU-wavefront step (``encoder/ctu_scan_cuda.py``,
    ``csrc/k1_ctu_step.cuh``, instantiated per CTB size in
    ``csrc/k1_ctu_step.cu``, ``k1_ctb32.cu``, ``k1_ctb16.cu``), one launch
    per wavefront level;
  * K2, the subpel motion refine (``encoder/me_cuda.py``,
    ``csrc/k2_subpel_refine.cu``), one launch per reference.

Layout mirrors ``x265_tpu`` (``ops/``, ``encoder/``, ``common/``,
``cabac/``, ``native/``, ``io/``, ``api.py``, ``cli.py``) with the same
module and function names.  The port stands on its own: it imports
nothing of ``x265_tpu``.  The host modules it needs (params with
``param_parse``, geometry, headers, SEI with the HRD's messages, level,
the picture syntax arrays and CABAC context init, the native C serializer
with the lossless bypass flag and the input dithering, the deblock/SAO
tables, the ``Encoder`` host logic with HRD and lossless, AQ, rate
control, weightp, the CTU tables, Y4M / YUV I/O, SSIM, the x265-style
procedural API and the CLI) are copies, line for line where the stream
depends on them; only the tests import both packages.

Device policy: ``Encoder``, ``encode_sequence``, ``api.x265_encoder_open``
and the CLI (``python -m x265_tpu_torch.cli``, ``--device``) run on the
card (``device="cuda"``) unless the caller asks for the CPU
(``device="cpu"``, as the tests do); nothing falls back silently.  TF32 is switched off for matmul and cuDNN at import: every
float product in the port is meant to be exact (integer operands) or IEEE
float32.
"""

import torch

from .common.params import Params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
__all__ = ["Encoder", "Params"]


def __getattr__(name):
    # the encoder pulls in the whole host stack; load it on first use
    if name == "Encoder":
        from .encoder import intra_encoder
        return getattr(intra_encoder, name)
    raise AttributeError(name)
