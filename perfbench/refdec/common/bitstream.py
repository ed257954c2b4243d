"""Bit writer and reader and Annex-B NAL assembly and splitting (H.265
§7.3, §7.4.2, Annex B) — ``x265_tpu/common/bitstream.py`` copied line
for line, without the RDO bit counter.
"""

from __future__ import annotations


class BitReader:
    """MSB-first bit reader over bytes (decoder side)."""

    __slots__ = ("_data", "_pos")

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0  # bit position

    def read(self, nbits: int) -> int:
        v = 0
        pos = self._pos
        data = self._data
        for _ in range(nbits):
            byte = data[pos >> 3]
            v = (v << 1) | ((byte >> (7 - (pos & 7))) & 1)
            pos += 1
        self._pos = pos
        return v

    def read_flag(self) -> int:
        return self.read(1)

    def read_ue(self) -> int:
        zeros = 0
        while self.read(1) == 0:
            zeros += 1
            assert zeros < 32, "invalid exp-golomb code"
        if zeros == 0:
            return 0
        return (1 << zeros) - 1 + self.read(zeros)

    def read_se(self) -> int:
        k = self.read_ue()
        return (k + 1) >> 1 if (k & 1) else -(k >> 1)

    def byte_align(self) -> None:
        self._pos = (self._pos + 7) & ~7

    @property
    def bit_pos(self) -> int:
        return self._pos

    def more_rbsp_data(self) -> bool:
        # True if there are bits left beyond the final stop-bit pattern.
        nbits = len(self._data) * 8
        if self._pos >= nbits:
            return False
        # find last set bit in the stream (rbsp_stop_one_bit)
        last = nbits - 1
        while last >= 0:
            byte = self._data[last >> 3]
            if (byte >> (7 - (last & 7))) & 1:
                break
            last -= 1
        return self._pos < last


# ---------------------------------------------------------------------------
# NAL units (Annex B)
# ---------------------------------------------------------------------------

# NAL unit types (H.265 Table 7-1)
NAL_TRAIL_N = 0
NAL_TRAIL_R = 1
NAL_BLA_W_LP = 16
NAL_IDR_W_RADL = 19
NAL_IDR_N_LP = 20
NAL_CRA_NUT = 21
NAL_VPS = 32
NAL_SPS = 33
NAL_PPS = 34
NAL_AUD = 35
NAL_EOS = 36
NAL_EOB = 37
NAL_FD = 38
NAL_PREFIX_SEI = 39
NAL_SUFFIX_SEI = 40


def remove_emulation_prevention(data: bytes) -> bytes:
    """Strip emulation_prevention_three_byte from an EBSP payload."""
    out = bytearray()
    zeros = 0
    i = 0
    n = len(data)
    while i < n:
        b = data[i]
        if zeros >= 2 and b == 0x03 and i + 1 < n and data[i + 1] <= 0x03:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


def split_annexb(stream: bytes):
    """Yield (nal_type, temporal_id, rbsp_bytes) for each NAL in an Annex-B
    stream (start-code scan + emulation removal, decoder entry point;
    parity with libde265/libde265/nal-parser.cc behaviour)."""
    i = 0
    n = len(stream)
    starts = []
    while i + 2 < n:
        if stream[i] == 0 and stream[i + 1] == 0 and stream[i + 2] == 1:
            starts.append(i + 3)
            i += 3
        else:
            i += 1
    for k, s in enumerate(starts):
        e = starts[k + 1] - 3 if k + 1 < len(starts) else n
        # trim the 4-byte start code's leading zero of the *next* NAL
        while e > s and stream[e - 1] == 0 and k + 1 < len(starts):
            e -= 1
        nal = stream[s:e]
        if len(nal) < 2:
            continue
        nal_type = (nal[0] >> 1) & 0x3F
        temporal_id = (nal[1] & 0x07) - 1
        yield nal_type, temporal_id, remove_emulation_prevention(nal[2:])
