"""x265_tpu_torch — the PyTorch / CUDA port of x265_tpu.

The port runs the encoder's device work on an NVIDIA GPU (Hopper, sm_90a)
with PyTorch for the plain tensor code and two hand-written CUDA kernels
for the two hot loops that were Pallas kernels in ``x265_tpu``:

  * K1, the CTU-wavefront step (``encoder/ctu_scan_cuda.py``,
    ``csrc/k1_ctu_step.cuh``, instantiated per CTB size in
    ``csrc/k1_ctu_step.cu``, ``k1_ctb32.cu``, ``k1_ctb16.cu`` and, with the
    inter RQT split, ``k1_rqt_ctb{64,32,16}.cu``), one launch per
    wavefront level;
  * K2, the subpel motion refine (``encoder/me_cuda.py``,
    ``csrc/k2_subpel_refine.cu``), one launch per reference.

Layout mirrors ``x265_tpu`` (``ops/``, ``encoder/``, ``decoder/``,
``common/``, ``cabac/``, ``native/``, ``io/``, ``parallel/``, ``tools/``,
``api.py``, ``cli.py``) with the same module and function names; ``parallel``'s
GOP-parallel encoder batches G GOPs' frames on one card, or G / D on each
of D devices (``devices=``, one host thread and stream a shard), where the
reference shards them over a mesh.  The port stands on its own: it imports
nothing of ``x265_tpu``.  The host modules it needs (params with
``param_parse``, geometry, headers, SEI with the HRD's messages, level,
the picture syntax arrays and CABAC context init, the native C serializer
with the lossless bypass flag and the input dithering, the deblock/SAO
tables, the ``Encoder`` host logic with HRD and lossless, AQ, rate
control, weightp, the CTU tables, Y4M / YUV I/O, SSIM, the x265-style
procedural API and the CLI, and the decoder's parsers, CABAC decoder,
motion-vector prediction and host recon) are copies, line for line where
the stream or a decoded sample depends on them; only the tests import both
packages.  The decoder (``decoder.decode_annexb``, ``decoder.Decoder``)
parses and reconstructs on the host and runs its picture-wide passes
(deblocking, SAO, the batched all-intra wavefront recon) on the device.

Device policy: ``Encoder``, ``encode_sequence``, ``api.x265_encoder_open``,
``parallel.encode_gop_parallel``, ``encoder.wavefront.WavefrontIntraRecon``,
``decoder.Decoder``, ``decoder.decode_annexb`` and the CLI (``python -m x265_tpu_torch.cli``, ``--device``) run on the
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
