"""CABAC constant tables (ITU-T H.265 §9.3: the arithmetic decoder's
Tables 9-46 / 9-47 and the context initValue tables 9-5..9-32) — the
context layout, ``init_context_states`` and the state tables of
``x265_tpu/cabac/tables.py``, copied line for line.  The native slice
encoder (``x265_tpu_torch.native``) takes the initial states from here,
the decoder's ``CabacDecoder`` the state tables.
"""

from __future__ import annotations

import numpy as np

# Table 9-46: rangeTabLps[pStateIdx][qRangeIdx]
LPS_TABLE = np.array([
    [128, 176, 208, 240], [128, 167, 197, 227], [128, 158, 187, 216],
    [123, 150, 178, 205], [116, 142, 169, 195], [111, 135, 160, 185],
    [105, 128, 152, 175], [100, 122, 144, 166], [95, 116, 137, 158],
    [90, 110, 130, 150], [85, 104, 123, 142], [81, 99, 117, 135],
    [77, 94, 111, 128], [73, 89, 105, 122], [69, 85, 100, 116],
    [66, 80, 95, 110], [62, 76, 90, 104], [59, 72, 86, 99],
    [56, 69, 81, 94], [53, 65, 77, 89], [51, 62, 73, 85],
    [48, 59, 69, 80], [46, 56, 66, 76], [43, 53, 63, 72],
    [41, 50, 59, 69], [39, 48, 56, 65], [37, 45, 54, 62],
    [35, 43, 51, 59], [33, 41, 48, 56], [32, 39, 46, 53],
    [30, 37, 43, 50], [29, 35, 41, 48], [27, 33, 39, 45],
    [26, 31, 37, 43], [24, 30, 35, 41], [23, 28, 33, 39],
    [22, 27, 32, 37], [21, 26, 30, 35], [20, 24, 29, 33],
    [19, 23, 27, 31], [18, 22, 26, 30], [17, 21, 25, 28],
    [16, 20, 23, 27], [15, 19, 22, 25], [14, 18, 21, 24],
    [14, 17, 20, 23], [13, 16, 19, 22], [12, 15, 18, 21],
    [12, 14, 17, 20], [11, 14, 16, 19], [11, 13, 15, 18],
    [10, 12, 15, 17], [10, 12, 14, 16], [9, 11, 13, 15],
    [9, 11, 12, 14], [8, 10, 12, 14], [8, 9, 11, 13],
    [7, 9, 11, 12], [7, 9, 10, 12], [7, 8, 10, 11],
    [6, 8, 9, 11], [6, 7, 9, 10], [6, 7, 8, 9], [2, 2, 2, 2],
], dtype=np.uint8)

# Table 9-47: state transitions
NEXT_STATE_MPS = np.array(
    list(range(1, 63)) + [62, 63], dtype=np.uint8)
NEXT_STATE_LPS = np.array([
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12,
    13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
    24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
    33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63,
], dtype=np.uint8)

# ---------------------------------------------------------------------------
# Context model layout (flat array, our own ordering)
# ---------------------------------------------------------------------------

_CTX_SIZES = [
    ("SAO_MERGE", 1),
    ("SAO_TYPE_IDX", 1),
    ("SPLIT_CU", 3),
    ("CU_TRANSQUANT_BYPASS", 1),
    ("CU_SKIP", 3),
    ("PRED_MODE", 1),
    ("PART_MODE", 4),
    ("PREV_INTRA_LUMA", 1),
    ("INTRA_CHROMA", 1),
    ("CBF_LUMA", 2),
    ("CBF_CHROMA", 4),
    ("SPLIT_TRANSFORM", 3),
    ("LAST_X_PREFIX", 18),
    ("LAST_Y_PREFIX", 18),
    ("CODED_SUB_BLOCK", 4),
    ("SIG_COEFF", 42),
    ("GREATER1", 24),
    ("GREATER2", 6),
    ("MERGE_FLAG", 1),
    ("MERGE_IDX", 1),
    ("INTER_PRED_IDC", 5),
    ("REF_IDX", 2),
    ("MVD_GREATER", 2),
    ("MVP_FLAG", 1),
    ("RQT_ROOT_CBF", 1),
    ("CU_QP_DELTA", 2),
    ("TRANSFORM_SKIP", 2),
]

CTX_OFFSET: dict[str, int] = {}
_off = 0
for _name, _n in _CTX_SIZES:
    CTX_OFFSET[_name] = _off
    _off += _n
NUM_CTX = _off

# initValue tables per initType (0 = I, 1 = P, 2 = B), H.265 Tables 9-5..9-32
_SIG_COEFF_INIT = [
    [111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179, 153, 125, 107,
     125, 141, 179, 153, 125, 107, 125, 141, 179, 153, 125, 140, 139, 182, 182, 152,
     136, 152, 136, 153, 136, 139, 111, 136, 139, 111],
    [155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140, 136, 153, 154, 166,
     183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 170, 153, 123, 123, 107,
     121, 107, 121, 167, 151, 183, 140, 151, 183, 140],
    [170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140, 136, 153, 154, 166,
     183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 170, 153, 138, 138, 122,
     121, 122, 121, 167, 151, 183, 140, 151, 183, 140],
]

_LAST_PREFIX_INIT = [
    [110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111, 79, 108, 123, 63],
    [125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94, 108, 123, 108],
    [125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111, 79, 108, 123, 93],
]

_GREATER1_INIT = [
    [140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139, 107, 122, 152,
     140, 179, 166, 182, 140, 227, 122, 197],
    [154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 137,
     169, 194, 166, 167, 154, 167, 137, 182],
    [154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 122,
     169, 208, 166, 167, 154, 152, 167, 182],
]

_GREATER2_INIT = [
    [138, 153, 136, 167, 152, 152],
    [107, 167, 91, 122, 107, 167],
    [107, 167, 91, 107, 107, 167],
]

CTX_INIT: dict[str, list[list[int]]] = {
    "SAO_MERGE": [[153], [153], [153]],
    "SAO_TYPE_IDX": [[200], [185], [160]],
    "SPLIT_CU": [[139, 141, 157], [107, 139, 126], [107, 139, 126]],
    "CU_TRANSQUANT_BYPASS": [[154], [154], [154]],
    "CU_SKIP": [[154, 154, 154], [197, 185, 201], [197, 185, 201]],
    "PRED_MODE": [[154], [149], [134]],
    "PART_MODE": [[184, 154, 139, 154], [154, 139, 154, 154], [154, 139, 154, 154]],
    "PREV_INTRA_LUMA": [[184], [154], [183]],
    "INTRA_CHROMA": [[63], [152], [152]],
    "CBF_LUMA": [[111, 141], [153, 111], [153, 111]],
    "CBF_CHROMA": [[94, 138, 182, 154], [149, 107, 167, 154], [149, 92, 167, 154]],
    "SPLIT_TRANSFORM": [[153, 138, 138], [124, 138, 94], [224, 167, 122]],
    "LAST_X_PREFIX": _LAST_PREFIX_INIT,
    "LAST_Y_PREFIX": _LAST_PREFIX_INIT,
    "CODED_SUB_BLOCK": [[91, 171, 134, 141], [121, 140, 61, 154], [121, 140, 61, 154]],
    "SIG_COEFF": _SIG_COEFF_INIT,
    "GREATER1": _GREATER1_INIT,
    "GREATER2": _GREATER2_INIT,
    "MERGE_FLAG": [[154], [110], [154]],
    "MERGE_IDX": [[154], [122], [137]],
    "INTER_PRED_IDC": [[95, 79, 63, 31, 31]] * 3,
    "REF_IDX": [[153, 153], [153, 153], [153, 153]],
    "MVD_GREATER": [[154, 154], [140, 198], [169, 198]],
    "MVP_FLAG": [[168], [168], [168]],
    "RQT_ROOT_CBF": [[79], [79], [79]],
    "CU_QP_DELTA": [[154, 154], [154, 154], [154, 154]],
    "TRANSFORM_SKIP": [[139, 139], [139, 139], [139, 139]],
}


def init_context_states(init_type: int, qp: int) -> np.ndarray:
    """Context initialization (H.265 §9.3.2.2).

    Returns an array of shape [NUM_CTX] with packed (state << 1) | valMps.
    """
    qp = max(0, min(51, qp))
    out = np.zeros(NUM_CTX, dtype=np.uint8)
    for name, size in _CTX_SIZES:
        inits = CTX_INIT[name][init_type]
        assert len(inits) == size, name
        base = CTX_OFFSET[name]
        for i, init_value in enumerate(inits):
            slope = (init_value >> 4) * 5 - 45
            offset = ((init_value & 15) << 3) - 16
            pre = min(max(1, ((slope * qp) >> 4) + offset), 126)
            if pre <= 63:
                state, mps = 63 - pre, 0
            else:
                state, mps = pre - 64, 1
            out[base + i] = (state << 1) | mps
    return out
