"""K1: the CTU-wavefront step as one hand-written CUDA kernel per level.

Replaces ``x265_tpu/encoder/ctu_scan_pallas.py`` (``make_pallas_step``:
kernel body ``kernel`` at :494, ``pallas_call`` at :927).  Source:
``x265_tpu_torch/csrc/k1_ctu_step.cu``; plain version: ``CtuScan.make_step``
(``ctu_scan.py``), which the wrapper runs for tensors on the CPU.

Design.  One 256-thread block per lane CTU of the level (L = 15 at 1080p,
62 levels per frame).  The lane's reconstruction buffers -- luma ``C``
97x129 and chroma ``Cc`` 2x49x65 int32 -- and the work buffers of the TU
chains stay in dynamic shared memory for the whole CTU (``sizeof(K1Smem)``
= 132,516 bytes by the struct's layout, so the launch raises the block's
dynamic shared memory limit), and the CTU's
4 quadrants x 4 slots run in z-order inside the block: reference assembly
and substitution, the angular formula per pixel (no 35-mode weight
tensor), integer transforms, quant/sign-hide/dequant, recon, the SSD +
lambda*bits RD compares with the psy term, and the inter TU32 trial.
What bounds it on an H100: one level puts at most 15 blocks on 132 SMs,
and each block walks ~60 dependent stages separated by barriers, so the
kernel is latency-bound, not bandwidth-bound (~60 KB of inputs per lane,
counted from the shapes).
Measured on an H100 80GB HBM3 at 700 W: the 62-level 1080p scan takes
41.10 ms through K1 against 14634.72 ms through the plain step (PERF.md).
A persistent kernel over all levels and wider per-CTU parallelism are
later work.

Exactness.  All pixel math is integer.  The float costs follow the
reference's rounding: SSD and bit counts converted to float32, sums in
the reference's order, ``lam * bits`` and ``plam * psy`` as single-rounding
FMAs (``__fmaf_rn``), everything else compiled with ``--fmad=false``.  The
psy lambda comes in precomputed (``xs["plam"]``) so kernel and plain step
read the same float32 values.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._util import dev_table
from ..build import load_library
from ..ops._dct_matrix import T32

#: launches of K1 made by ``ctu_step`` (the wrapper counts here, once per
#: kernel launch, and nowhere else)
LAUNCHES = 0

_IN_KEYS = ("cx", "cy", "m16", "m32", "qp_y", "qp_cb", "qp_cr", "o16y",
            "o8c", "o32y", "o16cb", "o16cr", "l16_av", "c8_av", "l32_av",
            "c16_av", "quad_ok")


def ctu_step(scan, inter: bool, decide32: bool, carry, xs, plain):
    """One wavefront level.  CPU tensors: the plain torch step.  CUDA
    tensors: one launch of K1 (or an exception)."""
    if xs["cx"].device.type != "cuda":
        return plain(carry, xs)
    return launch(load_library(), scan, inter, decide32, carry, xs)


def launch(lib, scan, inter: bool, decide32: bool, carry, xs):
    """Launch K1 from ``lib`` on the device of ``xs`` (the CUDA library on
    CUDA tensors; the host build of the same source on CPU tensors, which
    is how the CPU tests reach the kernel's arithmetic)."""
    global LAUNCHES
    dev = xs["cx"].device

    def _check(name, x, dtype, shape):
        if x.device != dev or x.dtype != dtype or tuple(
                x.shape) != tuple(shape) or not x.is_contiguous():
            raise ValueError(
                f"K1 input {name}: expected contiguous {dev} {dtype} "
                f"{shape}, got {x.device} {x.dtype} {tuple(x.shape)} "
                f"contiguous={x.is_contiguous()}")

    t = scan.t
    g = t["geom"]
    if g.log2_ctb != 6 or scan.bit_depth != 8:
        raise NotImplementedError("K1 covers 8-bit, 64x64 CTBs only")
    psy = scan.psy_rd > 0.0 and decide32
    L = xs["cx"].shape[0]
    cw, ch = g.ctbs_w, g.ctbs_h
    i32, b8, f32 = torch.int32, torch.bool, torch.float32
    shapes = dict(cx=(L,), cy=(L,), m16=(L, 16), m32=(L, 4), qp_y=(L,),
                  qp_cb=(L,), qp_cr=(L,), o16y=(L, 16, 16, 16),
                  o8c=(L, 16, 2, 8, 8), o32y=(L, 4, 32, 32),
                  o16cb=(L, 4, 16, 16), o16cr=(L, 4, 16, 16),
                  l16_av=(L, 16, 65), c8_av=(L, 16, 33), l32_av=(L, 4, 129),
                  c16_av=(L, 4, 65), quad_ok=(L, 4))
    for k in _IN_KEYS:
        _check(k, xs[k], b8 if k.endswith("_av") or k == "quad_ok" else i32,
               shapes[k])
    dummy_f = torch.zeros((L,), dtype=f32, device=dev)
    dummy_b = torch.zeros((L, 4), dtype=b8, device=dev)
    lam = xs["lam"] if decide32 else dummy_f
    plam = xs["plam"] if psy else dummy_f
    use32 = dummy_b if decide32 else xs["use32"]
    _check("lam", lam, f32, (L,))
    _check("plam", plam, f32, (L,))
    _check("use32", use32, b8, (L, 4))
    if inter:
        iv, ipy, ipc = xs["inter"], xs["ipy"], xs["ipc"]
        m32in = xs["m32_in"] if decide32 else dummy_b
        _check("inter", iv, b8, (L, 16))
        _check("ipy", ipy, i32, (L, 16, 16, 16))
        _check("ipc", ipc, i32, (L, 16, 2, 8, 8))
        _check("m32_in", m32in, b8, (L, 4))
    else:
        iv = torch.zeros((L, 16), dtype=b8, device=dev)
        ipy = torch.zeros((1,), dtype=i32, device=dev)
        ipc = ipy
        m32in = dummy_b
    (rowf, colf, cornf, rowfb, colfb, cornfb, rowfr, colfr, cornfr) = carry
    for nm, x, shp in (("rowf", rowf, (cw + 1, 64)), ("colf", colf,
                                                        (ch + 1, 64)),
                       ("rowfb", rowfb, (cw + 1, 32)),
                       ("colfb", colfb, (ch + 1, 32)),
                       ("rowfr", rowfr, (cw + 1, 32)),
                       ("colfr", colfr, (ch + 1, 32)),
                       ("cornf", cornf, (cw + 2, 2)),
                       ("cornfb", cornfb, (cw + 2, 2)),
                       ("cornfr", cornfr, (cw + 2, 2))):
        _check(nm, x, i32, shp)

    def out(*shape):
        return torch.empty(shape, dtype=i32, device=dev)

    lv16, lv8 = out(16, L, 16, 16), out(16, 2 * L, 8, 8)
    lv32, lvc16 = out(4, L, 32, 32), out(4, 2 * L, 16, 16)
    sel32 = out(4, L)
    int_y, int_c = out(L, 64, 64), out(2 * L, 32, 32)
    new = [x.clone() for x in (rowf, colf, rowfb, colfb, rowfr, colfr)]
    ptrs = [xs[k] for k in _IN_KEYS] + [
        lam, plam, use32, iv, ipy, ipc, m32in,
        rowf, colf, cornf, rowfb, colfb, cornfb, rowfr, colfr, cornfr,
        lv16, lv8, lv32, lvc16, sel32, int_y, int_c] + new + [
        dev_table("t32", lambda: T32.astype(np.int32), dev)]
    arr = (ctypes.c_void_p * len(ptrs))(*[p.data_ptr() for p in ptrs])
    flags = ((1 if inter else 0) | (2 if decide32 else 0) | (4 if psy else 0)
             | (8 if scan.sign_hide else 0) | (16 if scan.strong else 0))
    stream = (torch.cuda.current_stream(dev).cuda_stream
              if dev.type == "cuda" else 0)
    rc = lib.k1_ctu_step(arr, len(ptrs), L, cw, ch, flags,
                         ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"K1 launch failed: {lib.k_error_string(rc).decode()}")
    LAUNCHES += 1
    rowf, colf, rowfb, colfb, rowfr, colfr = new
    cx, cy = xs["cx"].long(), xs["cy"].long()
    # corner carry (parity-slotted): the lane's new bottom-right sample
    cornf, cornfb, cornfr = cornf.clone(), cornfb.clone(), cornfr.clone()
    cornf[cx + 1, cy & 1] = rowf[cx, 63]
    cornfb[cx + 1, cy & 1] = rowfb[cx, 31]
    cornfr[cx + 1, cy & 1] = rowfr[cx, 31]
    ys = (lv16, lv8, lv32, lvc16, sel32.to(torch.bool), int_y, int_c)
    return (rowf, colf, cornf, rowfb, colfb, cornfb, rowfr, colfr,
            cornfr), ys
