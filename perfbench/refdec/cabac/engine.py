"""CABAC arithmetic decoder (ITU-T H.265 §9.3.4.3: DecodeDecision,
DecodeBypass, DecodeTerminate) — the decoder side of
``x265_tpu/cabac/engine.py``, copied line for line.  The port's encoder
writes its bins with the native C serializer (``x265_tpu_torch.native``).

Context states are packed (pStateIdx << 1 | valMps) in a flat numpy array,
as ``tables.init_context_states`` builds them.
"""

from __future__ import annotations

import numpy as np

from ..common.bitstream import BitReader
from .tables import LPS_TABLE, NEXT_STATE_LPS, NEXT_STATE_MPS

_LPS = LPS_TABLE  # [64][4] uint8
_NEXT_MPS = NEXT_STATE_MPS
_NEXT_LPS = NEXT_STATE_LPS


class CabacDecoder:
    """H.265 §9.3.4.3 arithmetic decoder reading from a BitReader."""

    __slots__ = ("br", "offset", "range", "ctx")

    def __init__(self, br: BitReader, ctx: np.ndarray | None = None) -> None:
        self.br = br
        self.range = 510
        self.offset = br.read(9)
        self.ctx = ctx

    def decode_bin(self, ctx_idx: int) -> int:
        packed = int(self.ctx[ctx_idx])
        state = packed >> 1
        mps = packed & 1
        lps = int(_LPS[state, (self.range >> 6) & 3])
        self.range -= lps
        if self.offset >= self.range:
            bin_val = 1 - mps
            self.offset -= self.range
            self.range = lps
            if state == 0:
                mps = 1 - mps
            state = int(_NEXT_LPS[state])
        else:
            bin_val = mps
            state = int(_NEXT_MPS[state])
        self.ctx[ctx_idx] = (state << 1) | mps
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self.br.read(1)
        return bin_val

    def decode_bypass(self) -> int:
        self.offset = (self.offset << 1) | self.br.read(1)
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def decode_bypass_bins(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.decode_bypass()
        return v

    def decode_terminate(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self.br.read(1)
        return 0

    def decode_eg_k(self, k: int) -> int:
        value = 0
        while self.decode_bypass():
            value += 1 << k
            k += 1
        if k:
            value += self.decode_bypass_bins(k)
        return value
