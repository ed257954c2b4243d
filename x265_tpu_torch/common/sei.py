"""SEI message writing and parsing (ITU-T H.265 Annex D): the decoded
picture hash, user data, mastering display, content light level, and the
HRD's buffering period and picture timing — ``x265_tpu/common/sei.py``,
copied line for line.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .bitstream import BitReader, BitWriter

SEI_BUFFERING_PERIOD = 0
SEI_PICTURE_TIMING = 1
SEI_USER_DATA_UNREGISTERED = 5
SEI_RECOVERY_POINT = 6
SEI_ACTIVE_PARAMETER_SETS = 129
SEI_BUFFERING_PERIOD = 0
SEI_PIC_TIMING = 1
SEI_DECODED_PICTURE_HASH = 132
SEI_MASTERING_DISPLAY = 137
SEI_CONTENT_LIGHT_LEVEL = 144

HASH_MD5, HASH_CRC, HASH_CHECKSUM = 0, 1, 2


def plane_md5(plane: np.ndarray, bit_depth: int = 8) -> bytes:
    """MD5 over one plane's samples, raster order; >8-bit = 2 bytes LE
    per sample (D.3.19)."""
    if bit_depth <= 8:
        data = np.ascontiguousarray(plane, dtype=np.uint8).tobytes()
    else:
        data = np.ascontiguousarray(plane, dtype="<u2").tobytes()
    return hashlib.md5(data).digest()


def plane_crc(plane: np.ndarray, bit_depth: int = 8) -> bytes:
    """CRC-16 per D.3.19 (poly 0x1021, init 0xFFFF, 16 zero bits appended;
    >8-bit samples contribute low byte then high byte).  The augmented
    bit-serial form with init 0xFFFF equals the non-augmented table CRC
    (binascii.crc_hqx) with init 0x1D0F — the CRC-16/AUG-CCITT identity
    (libde265 sei.cc compute_CRC_8bit_fast uses the same trick)."""
    import binascii
    if bit_depth <= 8:
        data = np.ascontiguousarray(plane, dtype=np.uint8).tobytes()
    else:
        data = np.ascontiguousarray(plane, dtype="<u2").tobytes()
    return binascii.crc_hqx(data, 0x1D0F).to_bytes(2, "big")


def plane_checksum(plane: np.ndarray, bit_depth: int = 8) -> bytes:
    """32-bit checksum per D.3.19: sum of sample bytes XOR a position mask."""
    h, w = plane.shape
    xs = np.arange(w, dtype=np.uint32)
    ys = np.arange(h, dtype=np.uint32)
    mask = (((xs & 0xFF) ^ (xs >> 8))[None, :]
            ^ ((ys & 0xFF) ^ (ys >> 8))[:, None]).astype(np.uint32)
    p = np.asarray(plane, dtype=np.uint32)
    s = np.sum((p & 0xFF) ^ mask, dtype=np.uint64)
    if bit_depth > 8:
        s += np.sum((p >> 8) ^ mask, dtype=np.uint64)
    return (int(s) & 0xFFFFFFFF).to_bytes(4, "big")


def picture_hash_payload(planes, bit_depth: int = 8,
                         hash_type: int = HASH_MD5) -> bytes:
    fn = {HASH_MD5: plane_md5, HASH_CRC: plane_crc,
          HASH_CHECKSUM: plane_checksum}[hash_type]
    out = bytes([hash_type])
    for p in planes:
        out += fn(p, bit_depth)
    return out


def buffering_period_payload(sps, initial_delay: int,
                             initial_offset: int) -> bytes:
    """buffering_period SEI (§D.2.2; x265 sei.h:257 SEIBufferingPeriod):
    NAL HRD only, no RAP CPB params, au_cpb_removal_delay_delta == 1."""
    from .bitstream import BitWriter
    bw = BitWriter()
    bw.write_ue(0)                      # bp_seq_parameter_set_id
    bw.write_flag(0)                    # irap_cpb_params_present
    bw.write_flag(0)                    # concatenation_flag
    bw.write(0, sps.hrd_cpb_removal_len)   # au_cpb_removal_delay_delta-1
    mx = (1 << sps.hrd_initial_cpb_len) - 1
    bw.write(min(initial_delay, mx), sps.hrd_initial_cpb_len)
    bw.write(min(initial_offset, mx), sps.hrd_initial_cpb_len)
    bw.byte_align()
    return bw.getvalue()


def pic_timing_payload(sps, au_cpb_removal_delay: int,
                       pic_dpb_output_delay: int) -> bytes:
    """pic_timing SEI (§D.2.3; x265 sei.h:291 SEIPictureTiming) with
    frame_field_info off: just the CPB/DPB delays."""
    from .bitstream import BitWriter
    bw = BitWriter()
    bw.write(au_cpb_removal_delay - 1, sps.hrd_cpb_removal_len)
    bw.write(min(pic_dpb_output_delay,
                 (1 << sps.hrd_dpb_output_len) - 1), sps.hrd_dpb_output_len)
    bw.byte_align()
    return bw.getvalue()


def write_sei_rbsp(messages: list[tuple[int, bytes]]) -> bytes:
    """messages: [(payload_type, payload_bytes)] -> SEI RBSP."""
    bw = BitWriter()
    for ptype, payload in messages:
        t = ptype
        while t >= 255:
            bw.write(255, 8)
            t -= 255
        bw.write(t, 8)
        s = len(payload)
        while s >= 255:
            bw.write(255, 8)
            s -= 255
        bw.write(s, 8)
        for b in payload:
            bw.write(b, 8)
    bw.rbsp_trailing_bits()
    return bw.getvalue()


def parse_sei_rbsp(rbsp: bytes) -> list[tuple[int, bytes]]:
    br = BitReader(rbsp)
    out = []
    while br.more_rbsp_data():
        ptype = 0
        b = br.read(8)
        while b == 255:
            ptype += 255
            b = br.read(8)
        ptype += b
        size = 0
        b = br.read(8)
        while b == 255:
            size += 255
            b = br.read(8)
        size += b
        payload = bytes(br.read(8) for _ in range(size))
        out.append((ptype, payload))
    return out


def parse_picture_hash(payload: bytes):
    """Returns (hash_type, [digest per plane])."""
    hash_type = payload[0]
    body = payload[1:]
    if hash_type == HASH_MD5:
        n = len(body) // 16
        return hash_type, [body[i * 16:(i + 1) * 16] for i in range(n)]
    if hash_type == HASH_CRC:
        n = len(body) // 2
        return hash_type, [body[i * 2:(i + 1) * 2] for i in range(n)]
    n = len(body) // 4
    return hash_type, [body[i * 4:(i + 1) * 4] for i in range(n)]


def mastering_display_payload(text: str) -> bytes:
    """SMPTE ST 2086 mastering display colour volume (D.2.27; x265
    --master-display, sei.h SEIMasteringDisplayColorVolume).

    ``text``: x265's CLI form "G(x,y)B(x,y)R(x,y)WP(x,y)L(max,min)"
    with primaries/white point in 0.00002-units and luminance in
    0.0001 cd/m2 units.
    """
    import re
    m = re.match(r"G\((\d+),(\d+)\)B\((\d+),(\d+)\)R\((\d+),(\d+)\)"
                 r"WP\((\d+),(\d+)\)L\((\d+),(\d+)\)", text)
    if not m:
        raise ValueError(f"bad --master-display string: {text!r}")
    v = [int(x) for x in m.groups()]
    out = bytearray()
    # display_primaries in x[0]/y[0..2] order: the payload order is
    # G, B, R as parsed (x265 stores them already reordered)
    for i in range(3):
        out += v[2 * i].to_bytes(2, "big")
        out += v[2 * i + 1].to_bytes(2, "big")
    out += v[6].to_bytes(2, "big") + v[7].to_bytes(2, "big")
    out += v[8].to_bytes(4, "big") + v[9].to_bytes(4, "big")
    return bytes(out)


def content_light_level_payload(max_cll: int, max_fall: int) -> bytes:
    """Content light level info (D.2.28; x265 --max-cll "cll,fall")."""
    return max_cll.to_bytes(2, "big") + max_fall.to_bytes(2, "big")
