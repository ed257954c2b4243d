"""x265_tpu_torch — the PyTorch / CUDA port of x265_tpu.

The port runs the encoder's device work on an NVIDIA GPU (Hopper, sm_90a)
with PyTorch for the plain tensor code and two hand-written CUDA kernels
for the two hot loops that were Pallas kernels in ``x265_tpu``:

  * K1, the CTU-wavefront step (``encoder/ctu_scan_cuda.py``,
    ``csrc/k1_ctu_step.cu``), one launch per wavefront level;
  * K2, the subpel motion refine (``encoder/me_cuda.py``,
    ``csrc/k2_subpel_refine.cu``), one launch per reference.

Layout mirrors ``x265_tpu`` (``ops/``, ``encoder/``) with the same function
names.  Host-only modules of ``x265_tpu`` that do not touch JAX (CABAC,
headers, params, SEI, motion derivation, the native C serializer, the
deblock/SAO numpy helpers) are imported as they are; host modules that
``x265_tpu`` can only import together with JAX (the ``Encoder`` host
logic, AQ, rate control, weightp, the CTU tables) are carried as copies.

Device policy: the device is always explicit — a ``torch.device`` passed by
the caller (``"cuda"`` on the card, ``"cpu"`` in the tests), never a silent
choice.  TF32 is switched off for matmul and cuDNN at import: every float
product in the port is meant to be exact (integer operands) or IEEE float32.
"""

import torch

from x265_tpu.common.params import Params

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
