"""GOP-parallel encoding: G closed GOPs a round through one batched
dispatch (``gop.py``)."""

from .gop import GopParallelEncoder, encode_gop_parallel  # noqa: F401
