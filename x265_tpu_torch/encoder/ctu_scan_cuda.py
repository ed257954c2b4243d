"""K1: the CTU-wavefront step as one hand-written CUDA kernel per level.

Replaces ``x265_tpu/encoder/ctu_scan_pallas.py`` (``make_pallas_step``:
kernel body ``kernel`` at :494, ``pallas_call`` at :927).  Source:
``x265_tpu_torch/csrc/k1_ctu_step.cuh`` (the entry point and the CTB-64
instantiations in ``k1_ctu_step.cu``, CTB 32 and 16 in ``k1_ctb32.cu``,
``k1_ctb16.cu``); plain version: ``CtuScan.make_step``
(``ctu_scan.py``), which the wrapper runs for tensors on the CPU.

Design.  One 768-thread block per lane CTU of the level (at 1080p, L = 15
and 62 levels per frame at CTB 64, 30 and 126 at CTB 32, 60 and 254 at
CTB 16); a launch may carry the lanes of F frames (the carry has a
leading frame dimension, lanes are frame-major), so the batched B frames
of a mini-GOP share one launch per level.  The lane's inputs are staged in
shared memory once (bulk asynchronous copies for the sample tiles), its
reconstruction buffers (at CTB 64 luma 97x129 and chroma 2x49x65 int16)
stay there for the whole CTU, and the CTU's quadrants (4 at CTB 64, 1 at
32) of 4 slots each run in z-order inside the block, each candidate as one
joint luma + chroma TU chain of five barrier-separated stages; at CTB 16
the lane is one 16x16 slot.  The source's header comment has the details.
What bounds it on an H100: one level of a frame puts at most 15 (CTB 64)
to 60 (CTB 16) blocks on 132 SMs and each block is one chain of dependent
stages, so the kernel is bound by the latency of one CTU, not by its bytes
or its integer MACs (``chip_smoke.py`` prints the bound beside the
measured time).

State.  The kernel writes the new frontier rows, columns and corner
samples into the carry tensors in place (the lanes of a level touch
disjoint entries), so ``launch`` returns the carry it was given; the plain
step returns new tensors with the same contents.

Bit depth and CTB size.  The kernel is a template on the CTB size (64,
32, 16: an argument of the entry point) and on the bit depth,
instantiated for 8 and 10 (the flag bit 32 picks the 10-bit one); any
other depth raises.  At CTB 16 there is no 32x32 candidate: the step's
``lv32``, ``lvc16`` and ``sel32`` are None, as the plain step's.

Exactness.  All pixel math is integer.  The float costs follow the
reference's rounding: SSD and bit counts converted to float32, sums in
the reference's order, ``lam * bits`` and ``plam * psy`` as single-rounding
FMAs (``__fmaf_rn``), everything else compiled with ``--fmad=false``.  The
psy lambda comes in precomputed (``xs["plam"]``) so kernel and plain step
read the same float32 values.

RDOQ and noise reduction (flags 64 and 128).  With RDOQ every chain
chooses its levels as ``ops.quantize._rdoq_core`` does (psy-RDOQ on luma),
reading the same lambda and rate tables, in the same float order (the
prefix sums blocked by 16, the group sums in (y, x) order, first minima);
with noise reduction the position offsets (``xs["nr_pack"]``) come off
|coef| and the statistics of each frame add up in a zeroed per-launch
buffer, the step's ``ys[7]``.  Such a launch is also counted in
``LAUNCHES_RDOQ`` / ``LAUNCHES_NR``; on CUDA tensors these modes run the
kernel or raise, like every other.

The RQT split (flag 256, on when the level's inputs hold ``rqt_ok``, as an
inter ``scan_fn(..., rqt=True)`` stages them): every inter slot also runs
its depth-1 split (four 8x8 luma and 4x4 chroma TUs) and keeps the cheaper
configuration, as the plain step does; the step's ``ys[8]`` is ``tu8``
[nslots, L].  Such a launch is also counted in ``LAUNCHES_RQT``.

Devices and threads.  A launch runs on the device of its tensors (the
wrapper makes it the current one around the C call) on that device's
current stream, so several host threads may each drive their own device
or stream; the counts are bumped under one lock.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from .._util import dev_table, on_device
from ..build import load_library
from ..ops._dct_matrix import T32
from ..ops.quantize import rdoq_lambda_table, rdoq_rate_table
from .ctu_scan import nr_layout

#: launches of K1 made by ``ctu_step`` (the wrapper counts here, once per
#: kernel launch, and nowhere else), and of those the launches of its
#: 10-bit instantiation, with RDOQ, with noise reduction, with the RQT
#: split and at CTB 32 and 16; ``LAUNCHES_FRAMES`` sums the frames of each
#: launch's lanes.  Bumped under ``_COUNT_LOCK``.
LAUNCHES = 0
LAUNCHES_RQT = 0
LAUNCHES_FRAMES = 0
LAUNCHES_10BIT = 0
LAUNCHES_RDOQ = 0
LAUNCHES_NR = 0
LAUNCHES_CTB32 = 0
LAUNCHES_CTB16 = 0
_COUNT_LOCK = threading.Lock()

#: the level inputs K1 reads; of the original samples only the quads'
#: tiling (the slots' o16y / o8c hold the same samples as its sub-blocks);
#: at CTB 16, which has no quads, the slot's: ``_ORIG16`` stands in for
#: the quads' keys, and m32 is not read
_IN_KEYS = ("cx", "cy", "m16", "m32", "qp_y", "qp_cb", "qp_cr", "o32y",
            "o16cb", "o16cr", "l16_av", "c8_av", "l32_av", "c16_av",
            "quad_ok")
_ORIG16 = dict(o32y="o16y", o16cb="o8c")


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
    global LAUNCHES, LAUNCHES_10BIT, LAUNCHES_RDOQ, LAUNCHES_NR
    global LAUNCHES_CTB32, LAUNCHES_CTB16, LAUNCHES_FRAMES, LAUNCHES_RQT
    args, ys = kernel_args(scan, inter, decide32, carry, xs)
    with on_device(xs["cx"].device):
        rc = lib.k1_ctu_step(*args)
    if rc != 0:
        raise RuntimeError(
            f"K1 launch failed: {lib.k_error_string(rc).decode()}")
    rqt = "rqt_ok" in xs
    ctb = 1 << scan.t["geom"].log2_ctb
    with _COUNT_LOCK:
        LAUNCHES += 1
        LAUNCHES_FRAMES += carry[0].shape[0]
        if scan.bit_depth == 10:
            LAUNCHES_10BIT += 1
        if scan.rdoq:
            LAUNCHES_RDOQ += 1
        if scan.noise_reduction:
            LAUNCHES_NR += 1
        if rqt:
            LAUNCHES_RQT += 1
        if ctb == 32:
            LAUNCHES_CTB32 += 1
        elif ctb == 16:
            LAUNCHES_CTB16 += 1
    lv16, lv8, lv32, lvc16, sel32, int_y, int_c, nr, tu8 = ys
    if not scan.t["has32"]:
        lv32 = lvc16 = sel32 = None
    return carry, (lv16, lv8, lv32, lvc16,
                   None if sel32 is None else sel32.to(torch.bool), int_y,
                   int_c, nr if scan.noise_reduction else None,
                   tu8.to(torch.bool) if rqt else None)


def kernel_args(scan, inter: bool, decide32: bool, carry, xs):
    """Check the level's tensors and allocate its outputs; returns the
    arguments of the C entry point ``k1_ctu_step`` and the outputs ``ys``
    that a launch fills.  The arguments hold raw pointers: the caller keeps
    ``carry``, ``xs`` and ``ys`` alive while it uses them."""
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
    if scan.bit_depth not in (8, 10):
        raise NotImplementedError("K1 covers bit depths 8 and 10 only")
    ctb, has32 = 1 << g.log2_ctb, t["has32"]
    ctbc = ctb // 2
    nq, ns = t["n_quads"], t["nslots"]
    rqt = "rqt_ok" in xs            # the RQT split (inter scans only)
    psy = scan.psy_rd > 0.0 and (decide32 or rqt)
    L = xs["cx"].shape[0]
    F = carry[0].shape[0]           # frames: L / F lanes each, frame-major
    if F < 1 or L % F:
        raise ValueError(f"K1: {L} lanes do not split into {F} frames")
    cw, ch = g.ctbs_w, g.ctbs_h
    i32, b8, f32 = torch.int32, torch.bool, torch.float32
    dummy = _dummies(scan, dev, L)
    # the inputs in K1's order: at CTB 16 the slot's samples for the
    # quads' (o8c holds both chroma planes) and no 32x32 mode
    ins = {k: xs[k] for k in _IN_KEYS if has32 or k not in (
        "m32", "o32y", "o16cb", "o16cr")}
    if not has32:
        ins.update({k: xs[v] for k, v in _ORIG16.items()},
                   m32=dummy["iq"], o16cr=dummy["i1"])
    shapes = dict(cx=(L,), cy=(L,), m16=(L, ns), m32=(L, nq), qp_y=(L,),
                  qp_cb=(L,), qp_cr=(L,), o32y=(L, nq, 32, 32),
                  o16cb=(L, nq, 16, 16), o16cr=(L, nq, 16, 16),
                  l16_av=(L, ns, 65), c8_av=(L, ns, 33), l32_av=(L, nq, 129),
                  c16_av=(L, nq, 65), quad_ok=(L, nq))
    if not has32:
        shapes.update(o32y=(L, 1, 16, 16), o16cb=(L, 1, 2, 8, 8),
                      o16cr=(1,))
    for k in _IN_KEYS:
        _check(k, ins[k], b8 if k.endswith("_av") or k == "quad_ok" else i32,
               shapes[k])
    lam = xs["lam"] if decide32 or rqt else dummy["f"]
    plam = xs["plam"] if psy else dummy["f"]
    use32 = xs["use32"] if has32 and not decide32 else dummy["bq"]
    _check("lam", lam, f32, (L,))
    _check("plam", plam, f32, (L,))
    _check("use32", use32, b8, (L, nq))
    bulk = ("o32y", "o16cb", "o16cr") if has32 else ("o32y", "o16cb")
    if inter:
        iv, ipy, ipc = xs["inter"], xs["ipy"], xs["ipc"]
        m32in = xs["m32_in"] if has32 and decide32 else dummy["bq"]
        _check("inter", iv, b8, (L, ns))
        _check("ipy", ipy, i32, (L, ns, 16, 16))
        _check("ipc", ipc, i32, (L, ns, 2, 8, 8))
        _check("m32_in", m32in, b8, (L, nq))
        ins.update(ipy=ipy, ipc=ipc)
        bulk += ("ipy", "ipc")
    else:
        iv, ipy, ipc, m32in = dummy["bs"], dummy["i1"], dummy["i1"], \
            dummy["bq"]
    if rqt:
        if not inter:
            raise ValueError("K1: the RQT split needs an inter scan")
        rqt_ok = xs["rqt_ok"]
        _check("rqt_ok", rqt_ok, b8, (L, ns))
    else:
        rqt_ok = dummy["bs"]
    for k in bulk:   # the kernel stages these with 16-byte bulk copies
        if ins[k].data_ptr() % 16:
            raise ValueError(f"K1 input {k} is not 16-byte aligned")
    avk = ("l16_av", "c8_av", "l32_av", "c16_av")
    if not any(ins[k][0].numel() % 4 for k in avk):
        for k in avk:  # whole words a lane: the kernel's 4-byte copies
            if ins[k].data_ptr() % 4:
                raise ValueError(f"K1 input {k} is not 4-byte aligned")
    (rowf, colf, cornf, rowfb, colfb, cornfb, rowfr, colfr, cornfr) = carry
    for nm, x, shp in (("rowf", rowf, (F, cw + 1, ctb)),
                       ("colf", colf, (F, ch + 1, ctb)),
                       ("rowfb", rowfb, (F, cw + 1, ctbc)),
                       ("colfb", colfb, (F, ch + 1, ctbc)),
                       ("rowfr", rowfr, (F, cw + 1, ctbc)),
                       ("colfr", colfr, (F, ch + 1, ctbc)),
                       ("cornf", cornf, (F, cw + 2, 2)),
                       ("cornfb", cornfb, (F, cw + 2, 2)),
                       ("cornfr", cornfr, (F, cw + 2, 2))):
        _check(nm, x, i32, shp)

    if scan.noise_reduction:
        nro = xs["nr_pack"]
        _check("nr_pack", nro, i32, (nr_layout()[1],))
        nrs = torch.zeros((F, nr_layout()[1]), dtype=i32, device=dev)
    else:
        nro = nrs = dummy["i1"]

    def out(*shape):
        return torch.empty(shape, dtype=i32, device=dev)

    lv16, lv8 = out(ns, L, 16, 16), out(ns, 2 * L, 8, 8)
    if has32:
        lv32, lvc16 = out(nq, L, 32, 32), out(nq, 2 * L, 16, 16)
        sel32 = out(nq, L)
    else:                       # not written at CTB 16
        lv32 = lvc16 = sel32 = dummy["i1"]
    int_y, int_c = out(L, ctb, ctb), out(2 * L, ctbc, ctbc)
    tu8 = out(ns, L) if rqt else dummy["i1"]
    # the new frontiers and corners are written into the carry in place
    ptrs = [ins[k] for k in _IN_KEYS] + [
        lam, plam, use32, iv, ipy, ipc, m32in, rqt_ok, tu8,
        rowf, colf, cornf, rowfb, colfb, cornfb, rowfr, colfr, cornfr,
        lv16, lv8, lv32, lvc16, sel32, int_y, int_c,
        rowf, colf, rowfb, colfb, rowfr, colfr,
        dev_table("k1_tr_tt", _transform_tables, dev),
        dev_table("rdoq_lam", rdoq_lambda_table, dev),
        dev_table("rdoq_rate", rdoq_rate_table, dev), nro, nrs]
    arr = (ctypes.c_void_p * len(ptrs))(*[p.data_ptr() for p in ptrs])
    flags = ((1 if inter else 0) | (2 if decide32 else 0) | (4 if psy else 0)
             | (8 if scan.sign_hide else 0) | (16 if scan.strong else 0)
             | (32 if scan.bit_depth == 10 else 0)
             | (64 if scan.rdoq else 0)
             | (128 if scan.noise_reduction else 0)
             | (256 if rqt else 0))
    stream = (torch.cuda.current_stream(dev).cuda_stream
              if dev.type == "cuda" else 0)
    ys = (lv16, lv8, lv32, lvc16, sel32, int_y, int_c, nrs, tu8)
    psyq = scan.psy_rdoq if scan.rdoq else 0.0
    return (arr, len(ptrs), L, F, cw, ch, ctb, flags, ctypes.c_float(psyq),
            ctypes.c_void_p(stream)), ys


def _transform_tables():
    """The DCT matrices T8, T16, T32 (T[k][m]: rows k * 2^(5 - lg) of T32,
    first 2^lg columns) as signed bytes, four to an int32 word, in the four
    layouts of K1's transform passes (``k1_tp`` in the source), each layout
    T8 | T16 | T32: 4 x 336 words that K1 stages with one bulk copy; then
    T4 in the four layouts, 4 x 4 words, which only the RQT split reads
    (``k1_tpp``)."""
    def words(a):               # [..., 4] int8 -> [...] int32 (little-endian)
        return np.ascontiguousarray(a.astype(np.int8)).view("<i4")[..., 0]

    kinds = [[], [], [], []]
    for lg in (3, 4, 5, 2):
        t = T32[::1 << (5 - lg), :1 << lg].astype(np.int64)
        n = 1 << lg
        rows = t.reshape(n, n // 4, 4)           # [k][m4][4]
        cols = t.T.reshape(n, n // 4, 4)         # [m][k4][4]
        kinds[0].append(words(rows.transpose(1, 0, 2)))   # [m4][k]
        kinds[1].append(words(rows))                      # [k][m4]
        kinds[2].append(words(cols))                      # [m][k4]
        kinds[3].append(words(cols.transpose(1, 0, 2)))   # [k4][m]
    big = [w.ravel() for k in kinds for w in k[:3]]
    t4 = [k[3].ravel() for k in kinds]
    return np.concatenate(big + t4).astype(np.int32)


def _dummies(scan, dev, L):
    """Zero stand-ins for the inputs a configuration does not use (per
    lane, per quad or per slot), made once per scan object, device and
    lane count."""
    cache = scan.__dict__.setdefault("_k1_dummies", {})
    key = (str(dev), L)
    if key not in cache:
        nq, ns = scan.t["n_quads"], scan.t["nslots"]
        cache[key] = dict(
            f=torch.zeros((L,), dtype=torch.float32, device=dev),
            bq=torch.zeros((L, nq), dtype=torch.bool, device=dev),
            bs=torch.zeros((L, ns), dtype=torch.bool, device=dev),
            iq=torch.zeros((L, nq), dtype=torch.int32, device=dev),
            i1=torch.zeros((1,), dtype=torch.int32, device=dev))
    return cache[key]
