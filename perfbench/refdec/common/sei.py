"""SEI message writing and parsing (ITU-T H.265 Annex D): the decoded
picture hash, user data, mastering display, content light level, and the
HRD's buffering period and picture timing — ``x265_tpu/common/sei.py``,
copied line for line.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .bitstream import BitReader

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

