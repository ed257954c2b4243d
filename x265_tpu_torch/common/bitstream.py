"""Bit writer and reader and Annex-B NAL assembly and splitting (H.265
§7.3, §7.4.2, Annex B) — ``x265_tpu/common/bitstream.py`` copied line
for line, without the RDO bit counter.
"""

from __future__ import annotations


class BitWriter:
    """MSB-first bit writer over a growable bytearray.

    Equivalent role to the reference's ``Bitstream`` class
    (x265_1.9/source/common/bitstream.h:57).
    """

    __slots__ = ("_buf", "_bitpos", "_cur")

    def __init__(self) -> None:
        self._buf = bytearray()
        self._cur = 0       # current partial byte (bits packed from MSB)
        self._bitpos = 0    # number of bits valid in _cur (0..7)

    def write(self, value: int, nbits: int) -> None:
        """Write ``nbits`` bits of ``value`` (MSB first)."""
        if nbits == 0:
            return
        assert 0 <= nbits <= 32
        assert value >> nbits == 0, f"value {value} does not fit in {nbits} bits"
        cur = self._cur
        pos = self._bitpos
        total = pos + nbits
        # accumulate into an int, then flush full bytes
        acc = (cur << nbits) | value
        while total >= 8:
            total -= 8
            self._buf.append((acc >> total) & 0xFF)
        self._cur = acc & ((1 << total) - 1)
        self._bitpos = total

    def write_flag(self, flag: bool | int) -> None:
        self.write(1 if flag else 0, 1)

    def byte_align(self) -> None:
        """SEI payload alignment (§D.3.1 payload_bit_equal_to_one +
        zeros) — only when not already byte-aligned (x265 SEI
        writeByteAlign, sei.h)."""
        if self._bitpos:
            self.write_flag(1)
            if self._bitpos:
                self.write(0, 8 - self._bitpos)

    def write_ue(self, value: int) -> None:
        """Unsigned Exp-Golomb ue(v) (H.265 §9.2)."""
        assert value >= 0
        code = value + 1
        nbits = code.bit_length()
        # (nbits-1) zeros, then the code
        self.write(0, nbits - 1)
        self.write(code, nbits)

    def write_se(self, value: int) -> None:
        """Signed Exp-Golomb se(v) (H.265 §9.2.2): k>0 -> 2k-1, k<=0 -> -2k."""
        self.write_ue(2 * value - 1 if value > 0 else -2 * value)

    def write_bytes(self, data: bytes) -> None:
        assert self._bitpos == 0, "write_bytes requires byte alignment"
        self._buf.extend(data)

    @property
    def bit_length(self) -> int:
        return len(self._buf) * 8 + self._bitpos

    def byte_aligned(self) -> bool:
        return self._bitpos == 0

    def rbsp_trailing_bits(self) -> None:
        """rbsp_stop_one_bit + alignment zeros (H.265 §7.3.2.11)."""
        self.write_flag(1)
        if self._bitpos:
            self.write(0, 8 - self._bitpos)

    def byte_alignment(self) -> None:
        """alignment_bit_equal_to_one + zeros (H.265 §7.3.2.12, slice data)."""
        self.rbsp_trailing_bits()

    def getvalue(self) -> bytes:
        assert self._bitpos == 0, "bitstream not byte aligned"
        return bytes(self._buf)


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


def add_emulation_prevention(rbsp: bytes) -> bytes:
    """Insert emulation_prevention_three_byte (0x03) per H.265 §7.4.2
    (same contract as the reference's NALList::serialize, nal.cpp:60)."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 0x03:
            out.append(0x03)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


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


def nal_header(nal_type: int, layer_id: int = 0, temporal_id: int = 0) -> bytes:
    """two-byte nal_unit_header (H.265 §7.3.1.2)."""
    b0 = (nal_type & 0x3F) << 1 | (layer_id >> 5)
    b1 = ((layer_id & 0x1F) << 3) | ((temporal_id + 1) & 0x07)
    return bytes((b0, b1))


def wrap_nal(nal_type: int, rbsp: bytes, *, long_start_code: bool = True,
             temporal_id: int = 0) -> bytes:
    """Annex-B NAL unit: start code + header + emulation-prevented RBSP."""
    start = b"\x00\x00\x00\x01" if long_start_code else b"\x00\x00\x01"
    return start + nal_header(nal_type, 0, temporal_id) + add_emulation_prevention(rbsp)


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
