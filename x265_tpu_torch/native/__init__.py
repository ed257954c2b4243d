"""Native (C) host runtime of the port, loaded with ctypes: the CABAC
slice-data serializer (with ``cu_transquant_bypass_flag`` for lossless),
the merge/AMVP/skip derivation and the input dithering — a copy of
``x265_tpu/native`` (``slice_enc.c`` and its bindings).

The C source ships in the package and is compiled at first use with the
system C compiler into ``x265_tpu_torch/_build/``, keyed by the source's
digest.  A failed build raises: the encoder has no other entropy coder.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")
_LOCK = threading.Lock()
_LIB = None


def _build_lib() -> str:
    src = os.path.join(_DIR, "slice_enc.c")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(_BUILD, f"slice_enc_{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD, exist_ok=True)
    tmp = so + ".tmp.%d" % os.getpid()
    r = subprocess.run(["cc", "-O2", "-shared", "-fPIC", "-o", tmp, src],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError("building the native slice encoder failed:\n"
                           + (r.stdout + r.stderr)[-4000:])
    os.replace(tmp, so)
    return so


def get_lib():
    """The loaded native library (built on first call; raises if the C
    compiler fails or the library cannot be loaded)."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(_build_lib())
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        fn = lib.encode_slice_data
        fn.restype = ctypes.c_long
        fn.argtypes = [u8p] * 14 + [i16p] * 2 + [i32p] * 3 + [i64p] \
            + [i8p] * 4 + [ctypes.c_int] * 19 \
            + [i32p, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int] \
            + [u8p, ctypes.c_int, u8p, ctypes.c_long]
        dr = lib.derive_inter_syntax
        dr.restype = ctypes.c_long
        dr.argtypes = [u8p] * 5 + [i16p] * 2 + [i32p] * 3 + [i64p] \
            + [ctypes.c_int] * 8 \
            + [i32p, ctypes.c_int, i32p, ctypes.c_int] \
            + [u8p] * 4 + [i16p] * 2 + [u8p]
        dt = lib.derive_inter_syntax_tmvp
        dt.restype = ctypes.c_long
        dt.argtypes = list(dr.argtypes) \
            + [u8p, u8p, i16p, i16p, i32p, i32p, ctypes.c_int]
        u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
        lib.dither_plane.argtypes = [u16p, u16p, ctypes.c_int, ctypes.c_int,
                                     i16p, ctypes.c_int]
        lib.dither_plane.restype = None
        _LIB = lib
        return _LIB


SLICE_TYPE_B, SLICE_TYPE_I, SLICE_TYPE_P = 0, 2, 1


def encode_slice_data_native(ps, qp: int, *, log2_min_cb=3, log2_min_tb=2,
                             log2_max_tb=5, slice_type=SLICE_TYPE_I,
                             sao_luma=False, sao_chroma=False,
                             bit_depth=8, num_ref_l0=1, num_ref_l1=1,
                             mvd_l1_zero=False,
                             transquant_bypass=False) -> bytes:
    """Encode a full slice's CTU data natively (I, P or B).  Returns the
    CABAC byte payload (terminated + aligned).

    ``ps`` is a cabac.ctu.PicSyntax; output is byte-identical to the
    reference's Python CtuCoder/CabacEncoder path.  With
    ``transquant_bypass`` (the PPS's transquant_bypass_enabled) every CU
    starts with its ``cu_transquant_bypass_flag`` from ``ps.tq_bypass``.
    """
    lib = get_lib()
    from ..cabac.tables import NUM_CTX, init_context_states

    g = ps.geom
    init_type = {SLICE_TYPE_I: 0, SLICE_TYPE_P: 1,
                 SLICE_TYPE_B: 2}[slice_type]
    ctx = np.ascontiguousarray(init_context_states(init_type, qp), np.uint8)
    cap = ps.coeff_y.size * 8 + (1 << 16)
    out = np.empty(cap, np.uint8)
    arrs = [np.ascontiguousarray(a, np.uint8)
            for a in (ps.depth, ps.part, ps.luma_mode, ps.chroma_mode,
                      ps.tu_depth, ps.pred_mode, ps.skip, ps.merge_flag,
                      ps.merge_idx, ps.mvp_flag, ps.inter_dir, ps.mvp_flag1,
                      ps.ref_idx0, ps.ref_idx1)]
    n = lib.encode_slice_data(
        *arrs,
        np.ascontiguousarray(ps.mvd, np.int16),
        np.ascontiguousarray(ps.mvd1, np.int16),
        np.ascontiguousarray(ps.coeff_y, np.int32),
        np.ascontiguousarray(ps.coeff_cb, np.int32),
        np.ascontiguousarray(ps.coeff_cr, np.int32),
        np.ascontiguousarray(g.zscan, np.int64),
        np.ascontiguousarray(ps.sao_type, np.int8),
        np.ascontiguousarray(ps.sao_eo_class, np.int8),
        np.ascontiguousarray(ps.sao_band_pos, np.int8),
        np.ascontiguousarray(ps.sao_offsets, np.int8),
        int(sao_luma), int(sao_chroma), bit_depth,
        g.width, g.height, g.w4, g.h4,
        g.log2_ctb, log2_min_cb, log2_min_tb, log2_max_tb,
        ps.max_tr_depth_intra, ps.max_tr_depth_inter, int(ps.sign_hiding),
        slice_type, ps.max_merge_cand,
        num_ref_l0, num_ref_l1, int(mvd_l1_zero),
        np.ascontiguousarray(ps.qp_ctb, np.int32), ps.slice_qp,
        int(ps.cu_qp_delta_enabled),
        np.ascontiguousarray(ps.tq_bypass, np.uint8), int(transquant_bypass),
        ctx, NUM_CTX, out, cap)
    if n < 0:
        raise RuntimeError(f"native slice encode failed: {n}")
    return out[:n].tobytes()


def derive_inter_syntax_native(ps) -> None:
    """Fill ps.merge_flag/merge_idx/mvp_flag(1)/mvd(1)/skip from the
    chosen motion (native port of the reference encoder's
    _derive_inter_syntax + _derive_skip over common/motion.py).
    """
    lib = get_lib()
    g = ps.geom
    pocs0 = np.ascontiguousarray(ps.ref_pocs_l0 or (0,), np.int32)
    pocs1 = np.ascontiguousarray(ps.ref_pocs_l1 or (0,), np.int32)
    ins = [np.ascontiguousarray(a, np.uint8)
           for a in (ps.depth, ps.pred_mode, ps.inter_dir,
                     ps.ref_idx0, ps.ref_idx1)]
    mv0 = np.ascontiguousarray(ps.mv0, np.int16)
    mv1 = np.ascontiguousarray(ps.mv1, np.int16)
    cy = np.ascontiguousarray(ps.coeff_y, np.int32)
    ccb = np.ascontiguousarray(ps.coeff_cb, np.int32)
    ccr = np.ascontiguousarray(ps.coeff_cr, np.int32)
    zs = np.ascontiguousarray(g.zscan, np.int64)
    # outputs written in place (must be the ps arrays themselves)
    for name in ("merge_flag", "merge_idx", "mvp_flag", "mvp_flag1",
                 "skip"):
        a = getattr(ps, name)
        assert a.dtype == np.uint8 and a.flags["C_CONTIGUOUS"], name
    assert ps.mvd.dtype == np.int16 and ps.mvd1.dtype == np.int16
    base_args = (*ins, mv0, mv1, cy, ccb, ccr, zs,
                 g.width, g.height, g.w4, g.h4, g.log2_ctb, 3,
                 ps.max_merge_cand, ps.cur_poc,
                 pocs0, len(ps.ref_pocs_l0), pocs1, len(ps.ref_pocs_l1),
                 ps.merge_flag, ps.merge_idx, ps.mvp_flag, ps.mvp_flag1,
                 ps.mvd, ps.mvd1, ps.skip)
    if getattr(ps, "temporal_mvp", False) and ps.col is not None:
        col = ps.col
        lib.derive_inter_syntax_tmvp(
            *base_args,
            np.ascontiguousarray(col["pred_mode"], np.uint8),
            np.ascontiguousarray(col["inter_dir"], np.uint8),
            np.ascontiguousarray(col["mv0"], np.int16),
            np.ascontiguousarray(col["mv1"], np.int16),
            np.ascontiguousarray(col["poc0"], np.int32),
            np.ascontiguousarray(col["poc1"], np.int32),
            int(col["poc"]))
    else:
        lib.derive_inter_syntax(*base_args)


def dither_image(planes, input_depth: int, output_depth: int):
    """x265_dither_image analogue (x265-extras.cpp:284): error-diffusion
    down-conversion of high-bit-depth input planes to ``output_depth``.
    planes: list of uint16 numpy arrays at ``input_depth``; returns the
    dithered planes (uint8 when output_depth == 8, else uint16)."""
    lib = get_lib()
    out = []
    shift_up = 16 - input_depth
    for p in planes:
        h, w = p.shape
        src = np.ascontiguousarray(
            p.astype(np.uint16) << shift_up)
        dst = np.zeros_like(src)
        errs = np.zeros((w + 1,), np.int16)
        lib.dither_plane(dst, src, w, h, errs, output_depth)
        dt = np.uint8 if output_depth == 8 else np.uint16
        out.append(dst.astype(dt))
    return out
