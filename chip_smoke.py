#!/usr/bin/env python3
"""Smoke test of x265_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):
  1. the card's name and power limit (nvidia-smi), then the build of the
     kernels K1 and K2 from x265_tpu_torch/csrc/ with nvcc for sm_90a (one
     nvcc per source, all started together: K1's instantiations at CTB
     64, 32 and 16 are three sources), its time and ptxas's registers and
     spills per instantiation;
  2. K1 against its plain torch step on the card, I and P, psy-rd 2.0:
     the whole 62-level CTU scan of seeded random 1920x1088 inputs (every
     output equal), then the busiest level alone (L = 15 real lanes): one
     launch against one plain step (outputs and carry equal), K1's time
     for one launch with CUDA events (each on a fresh copy of the level's
     carry), the plain step's time, and the bound of that launch; then the
     same busiest level of a batched scan of two frames (F = 2, 30 lanes
     in one launch, each frame its own frontiers): outputs and both
     frames' carries equal to the plain step, its one-launch time, the
     plain step's time and the bound;
  3. K2 against its plain torch version on the card at 8160 blocks,
     merange 57: q0, pred and cost must be equal on four seeded sets
     (``k2_inputs``: random; flat, where every candidate ties; samples at
     0 and 255; mvi at the range's edge, where candidates are masked and
     tie among themselves), subme 2 (and 1, 0 on the last three); then
     on the random set K2's one-launch time, the plain version's time and
     the bound; then the blocks of two frames in one launch (B = 16320,
     each half with its own lambda, as a batched B dispatch gives them):
     equal to the plain version, with time and bound;
  4. the IPPP slice: 1080p (4 frames of panning synthetic content) at
     Params() defaults with bframes=0 through Encoder.encode_frame on the
     card; K1 must launch 62 x 4 times and K2 3 x 3 times, and the stream's
     MD5 must equal the golden digest of x265_tpu's own encode
     (x265_tpu_torch/data/golden_1080p_ippp.json, tools/make_golden.py);
  5. the B slice: the same content, 6 frames, bframes=4 with b-pyramid and
     the lookahead off, through push_frame / flush (encode order I0 P5 B3
     B1+B2 B4: the reference B, one batched dispatch of two Bs, one single
     B); K1 must launch 62 x 5 times (the batched pair shares its 62) and
     K2 9 times (3 for P5, 2 for each B dispatch), and the MD5 and size
     must equal x265_tpu_torch/data/golden_1080p_b.json;
  6. the bench slice: bench.py's own configuration and frames (1080p, 10
     frames, Params(qp=32, decoded_picture_hash=3) at the defaults:
     bframes=4, b-pyramid, b-adapt 2, rc_lookahead=20, cuTree, merange 57)
     through push_frame / flush, so the lookahead (lowres programs, cuTree,
     the b-adapt trellis, the lookahead scenecut) chooses the mini-GOPs;
     a warm encode, then a timed one, each with a fresh Encoder.  The MD5,
     size, encode-order POCs and slice kinds must equal
     x265_tpu_torch/data/golden_1080p_bench.json; K1 and K2 must launch
     the counts that the golden's encode order and the dispatch shapes
     give (``bench_launches``); the lookahead's programs must have run,
     with their outputs on the card.  It prints the wall of every call,
     the fps over the 10 frames and the synchronised time spent in the
     lookahead;
  7. the Main10 bench slice: the bench slice at internal_bit_depth=10 on
     ten frames of 10-bit content (smoke_config.smoke_frames_bench10), a
     warm and a timed encode with fresh Encoders; MD5, size, encode-order
     POCs and kinds equal to x265_tpu_torch/data/golden_1080p_bench10.json,
     K1 and K2 launched the counts ``bench_launches`` gives, every one of
     them on the kernels' 10-bit path (counted apart), and the lookahead's
     programs on the card.
  8. the slow slice: the bench slice's ten frames at
     default_params("slow", qp=32, decoded_picture_hash=3) (RDOQ with
     psy-RDOQ 1.0, ref=4, b-adapt 2, rc_lookahead=25), a warm and a timed
     encode; MD5, size, encode-order POCs and kinds equal to
     x265_tpu_torch/data/golden_1080p_slow.json, K1 and K2 launched the
     counts ``bench_launches`` gives for 4 references, every K1 launch on
     its RDOQ path (counted apart);
  9. the NR slice: the B slice's configuration with
     noise_reduction_intra=noise_reduction_inter=600 on ten frames (the
     first mini-GOP is dispatched before any frame is fetched, so only the
     second uses learned offsets; with six frames the stream is the B
     slice's); MD5, size, encode order and kinds equal to
     x265_tpu_torch/data/golden_1080p_nr.json, K1 and K2 launched the
     counts ``bench_launches`` gives, every K1 launch on its
     noise-reduction path, offsets learned;
 10. the superfast slice: the bench slice's ten frames at
     default_params("superfast", qp=32, decoded_picture_hash=1) (CTU 32:
     126 wavefront levels; bframes=3 with a fixed GOP, one reference,
     subme 1), a warm and a timed encode; MD5, size, encode-order POCs and
     kinds equal to x265_tpu_torch/data/golden_1080p_superfast.json, K1
     and K2 launched the counts ``bench_launches`` gives for 126 levels,
     every K1 launch at CTB 32 (counted apart);
 11. the ultrafast slice: the same at default_params("ultrafast") (also
     subme 0, no SAO, no sign hiding) against golden_1080p_ultrafast.json;
 12. the IPPP slice at ctu_size=16 (254 levels, no 32x32 candidate) with
     the MD5 hash SEI through encode_frame, warm and timed, against
     golden_1080p_ctu16.json: K1 254 launches a frame, all at CTB 16;
 13. the CLI at CRF: the bench slice's ten frames written to a 1920x1080
     Y4M with the port's write_y4m, then x265_tpu_torch.cli.main(
     [in.y4m, -o, out.265, --crf, 28, --hash, md5, --csv, log.csv,
     --no-progress]) in-process on the card (the medium preset); the
     stream's MD5 and size, the encode order and the CSV's text equal to
     golden_1080p_crf_cli.json (x265_tpu's own CLI on the same Y4M), K1
     and K2 launched the counts ``bench_launches`` gives;
 14. ABR 1000 kbps with VBV 1000 kbps / 1000 kbit and HRD through the
     procedural API (x265_param_default_preset("medium"),
     x265_param_parse, x265_encoder_encode with each frame, then with None
     until it drains): MD5, size and encode order equal to
     golden_1080p_abr_vbv_hrd.json, a buffering-period SEI in every IRAP
     AU and a picture-timing SEI in every AU (the prefix SEI NALs' payload
     types, as the golden's), x265_encoder_get_stats the stream's bits,
     K1 and K2 the counts ``bench_launches`` gives;
 15. 2-pass ABR at 1000 kbps through encode_sequence: pass 1 writes the
     stats file into a temporary directory, pass 2 reads it; the stats
     file's text, pass 1's MD5 and pass 2's MD5, size and encode order
     equal to golden_1080p_twopass.json, pass 2's K1 and K2 launches the
     counts ``bench_launches`` gives;
 16. lossless: two frames at lossless=True with the MD5 hash SEI through
     encode_sequence (all-intra: the mode decision on the card, no scan,
     no search); the MD5 and size equal to golden_1080p_lossless.json,
     every recon equal to its source, and no K1 or K2 launch.
Phases 13-16 each run one timed encode (the earlier phases have built and
warmed the kernels) and print its fps.
Phase 2 also holds K1's RDOQ (psy-RDOQ 1.0) and noise-reduction paths: the
busiest level (I and P, F = 1 and 2, 8 and 10 bits) equal to the plain
step, NR sums included, with seeded offsets for NR and, for RDOQ, a P
frame's CTU planted to code a level of 8192; each with its one-launch
time, the plain step's time and the bound (RDOQ's float operations at the
float32 rate, ``RDOQ_FLOPS``).
Phase 2 also holds K1 at CTB 32 and 16 (``k1_inputs(..., log2_ctb)``, the
126- and 254-level scans of the same 1080p planes, decide32 at CTB 32 as
the pipelines run it): the whole scan, then the busiest level (30 and 60
lanes) I and P at F = 1 and 2, P at 10 bits, and at CTB 32 the RDOQ P
launch with a planted level of 8192, each equal to the plain step with
its one-launch time, the plain step's time and the bound.
Phases 2 and 3 also hold the kernels' 10-bit instantiations: K1's busiest
level (I and P, F = 1 and 2) on 10-bit inputs (samples 0..1023 with bands
at 0 and 1023, QPs with the 12 of the bit-depth offset) equal to the plain
step, and K2 on the four sets with 10-bit samples (0 and 1023 in the
extreme one) at B = 8160 and 16320 equal to the plain refine, each with
its one-launch time, the plain version's time and the bound.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.

Bounds: the least time the card could take for a launch's work, the
larger of its bytes (each input it needs read once, each output written
once) over 3.35 TB/s and its integer operations over the H100 SXM's rate
for them at the full 700 W.  The INT32 pipes run 132 SMs x 64 lanes x 1.98
GHz = 16.7 T instructions/s (half the data sheet's 67 TFLOP/s float32
rate).  K1's operations are the multiply-adds of its transforms, int16
residuals and levels times the int8 DCT matrix, counted as x265's
partial butterflies need them, at two a dp2a instruction: 33.4 T/s.  K2's
are instructions at 16.7 T/s: the 8-tap interpolation's, each filtered
sample counted once however many candidates of a block share it, as dp4a
in the horizontal pass (8-bit samples times int8 taps, two a sample; at
10 bits dp2a on int16 sample pairs, four a sample) and dp2a in the
vertical (int16 sums, four a sample), and the SATDs' adds, one each.
"""

import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.7e12
DP2A_MAC_PER_S = 2 * INT32_OPS_PER_S
FP32_FLOPS_PER_S = 67e12
# RDOQ's float operations a coefficient (k1_rdoq_level and the passes after
# it; a fused multiply-add counts two): the dequant step 1; per candidate
# the reconstruction, error, square, scale 4 and the rate term's fma 2, 18
# for three; the first-minimum 4; the (y, x) group sums and the prefix sums
# of both costs 4; the prefix carries, the block total and the end cost
# (2 adds, a subtract, an add, an fma, the compare) 9 -- 36; psy-RDOQ on
# luma 3 more per candidate, 9
RDOQ_FLOPS = 36
PSY_FLOPS = 9


def _events_ms(fn, reps):
    """Mean device milliseconds of ``fn()`` over ``reps`` calls (after one
    warm call), timed with CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def k1_launch_ms(lib, scan, inter, xs, carry0, reps):
    """Mean device milliseconds of one K1 launch (decide32 where the CTB
    has 32x32 quads, as the pipelines run it) from ``lib`` on level inputs
    ``xs``, timed with CUDA events around each launch alone.
    K1 writes the frontiers into its carry, so every launch gets a fresh
    copy of ``carry0``, made outside the timed events; the launches are
    queued behind a sleep on the card so that the host's launch time falls
    outside them too."""
    import torch
    from x265_tpu_torch.encoder import ctu_scan_cuda
    ck = tuple(c.clone() for c in carry0)
    # args holds raw pointers into ck, xs and the outputs _ys
    args, _ys = ctu_scan_cuda.kernel_args(scan, inter, scan.t["has32"], ck,
                                          xs)
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps + 1)]
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    for t0, t1 in ev:
        for c, c0 in zip(ck, carry0):
            c.copy_(c0)
        t0.record()
        rc = lib.k1_ctu_step(*args)
        t1.record()
        if rc != 0:
            raise RuntimeError(f"K1 launch failed: rc {rc}")
    torch.cuda.synchronize()
    return sum(t0.elapsed_time(t1) for t0, t1 in ev[1:]) / reps


def _max_abs_err(a, b):
    import torch
    errs = [0.0]
    for x, y in zip(a, b):
        if x is None and y is None:
            continue
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"shape/dtype differ: {x.shape} {x.dtype} "
                                 f"vs {y.shape} {y.dtype}")
        d = (x.to(torch.float64) - y.to(torch.float64)).abs()
        errs.append(float(d.max()) if d.numel() else 0.0)
    return max(errs)


def _report_diff(what, a, b):
    """Print, for each output that differs, how many entries differ."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x is not None and y is not None and not bool((x == y).all()):
            print(f"  {what}: output {i} {tuple(x.shape)} differs in "
                  f"{int((x != y).sum())} entries", flush=True)


def _bound(nbytes, ops, ops_per_s):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _butterfly_macs(n):
    """Multiplies of one n-point HEVC core transform of one line through
    x265's partial butterflies: the odd half's (n/2)^2, then the even half
    as an n/2-point transform; 8 for n = 4."""
    return 8 if n == 4 else (n // 2) ** 2 + _butterfly_macs(n // 2)


def _tu_chain_macs(n):
    """Multiply-adds of one K1 chain: the forward and inverse 2-D
    transforms (two passes of n lines each) of a luma n x n block and of
    its two chroma n/2 x n/2 blocks."""
    def tu(m):
        return 4 * m * _butterfly_macs(m)
    return tu(n) + 2 * tu(n // 2)


def k1_level_bound(xs, ys, inter, scan):
    """Bound of one K1 launch of ``scan`` on level inputs ``xs``: the bytes
    of the inputs it reads (the original samples in one tiling: the
    quads', at CTB 16 the slot's), the frontier entries it reads and
    writes, the transform tables and its outputs; the multiply-adds of its
    transforms (per quad the 32x32 candidate and four 16x16 slots, at CTB
    16 one slot), counting the inter TU32 trials this level's data asks
    for, at the dp2a rate.  With RDOQ (``scan.rdoq``) also its float
    operations (``RDOQ_FLOPS`` a coefficient, ``PSY_FLOPS`` more on luma
    with psy-RDOQ) at the float32 rate, and the lambda table; with noise
    reduction the offsets read and the statistics written, and (every quad
    then runs the trial) the trial of every quad.  The bound is the larger
    of the bytes' time and the slower pipe's time."""
    L = xs["cx"].shape[0]
    t = scan.t
    has32, nq, spq = t["has32"], t["n_quads"], t["slots_per_quad"]
    ctb = 1 << t["geom"].log2_ctb
    ctbc = ctb // 2
    keys = ["cx", "cy", "m16", "qp_y", "qp_cb", "qp_cr", "l16_av", "c8_av",
            "lam", "plam"]
    keys += (["m32", "o32y", "o16cb", "o16cr", "l32_av", "c16_av",
              "quad_ok"] if has32 else ["o16y", "o8c"])
    if inter:
        keys += ["inter", "ipy", "ipc", "m32_in"]
    # per lane: reads 2 rows + 1 column + 1 corner of each plane's frontier,
    # writes 1 row + 1 column + 1 corner of each
    frontier = L * 4 * ((3 * ctb + 1) + (2 * ctb + 1) + 2 * (
        (3 * ctbc + 1) + (2 * ctbc + 1)))
    tables = 4 * 4 * 336     # K1's packed DCT matrices, one bulk copy
    if scan.rdoq:
        tables += 4 * 2 * 64
    if scan.noise_reduction:
        tables += _nbytes([xs["nr_pack"]])
    nbytes = _nbytes([xs[k] for k in keys if k in xs]) + frontier + \
        tables + _nbytes([y for y in ys if y is not None])
    trials = ((L * nq if scan.noise_reduction else int(xs["m32_in"].sum()))
              if inter and has32 else 0)
    macs = (L * nq * ((_tu_chain_macs(32) if has32 else 0)
                      + spq * _tu_chain_macs(16))
            + trials * _tu_chain_macs(32))
    t_ops = macs / DP2A_MAC_PER_S
    if scan.rdoq:
        coefs = L * nq * ((1536 if has32 else 0) + spq * 384) + trials * 1536
        luma = L * nq * ((1024 if has32 else 0) + spq * 256) + trials * 1024
        flops = coefs * RDOQ_FLOPS + (luma * PSY_FLOPS if scan.psy_rdoq > 0
                                      else 0)
        t_ops = max(t_ops, flops / FP32_FLOPS_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# nonzero taps of HEVC's 8-tap luma filter per quarter-pel phase (phase 0
# is the sample itself)
_LUMA_TAPS = ((3,), tuple(range(7)), tuple(range(8)), tuple(range(1, 8)))


def _k2_interp_ops(cands, bd=8):
    """Instructions of K2's interpolation for one block's candidate qpel
    offsets ``cands`` (y, x): every horizontally filtered sample (window
    row, column, phase; two dp4a at 8 bits, four dp2a at 10) and every
    vertically filtered one (row, column, both phases; four dp2a) counted
    once, whichever candidates share it."""
    hs, vs = set(), set()
    for qy, qx in cands:
        iy1, ix1, fy, fx = (qy >> 2) + 1, (qx >> 2) + 1, qy & 3, qx & 3
        rows = {y + k for y in range(16) for k in _LUMA_TAPS[fy]}
        if fx:
            hs.update((iy1 + r, ix1 + x, fx) for r in rows for x in range(16))
        if fy:
            vs.update((iy1 + y, ix1 + x, fy, fx) for y in range(16)
                      for x in range(16))
    return (2 if bd == 8 else 4) * len(hs) + 4 * len(vs)


def k2_bound(W, ob, mvi, pmv, outs, lam, mrq, bd=8):
    """Bound of one K2 launch (subme 2): its bytes, and the instructions
    the candidates within the search range need: the interpolation once
    per shared filtered sample (``_k2_interp_ops``) and per distinct
    candidate the residual and sixteen 4x4 Hadamard SATDs (256 + 16 x 96
    adds).  The
    second round's candidates sit around the first round's winner, which
    the plain refine gives (subme 1: the first round alone)."""
    import numpy as np
    from x265_tpu_torch.encoder import me_cuda
    q1 = me_cuda.refine_plain(W, ob, mvi, pmv, lam, 1, mrq, bd)[0]
    q1, mv = q1.cpu().numpy(), mvi.cpu().numpy()
    d = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    r1 = np.array([(2 * dy, 2 * dx) for dy, dx in d])            # [9, 2]
    r2 = q1[:, None, :] + np.array([p for p in d if p != (0, 0)])  # [B, 8, 2]
    cands = np.concatenate([np.broadcast_to(r1, (len(q1), 9, 2)), r2], 1)
    inside = (np.abs(mv[:, None, :] * 4 + cands) <= 4 * mrq).all(2)
    keys = np.concatenate([q1, inside], 1)
    uniq, count = np.unique(keys, axis=0, return_counts=True)
    ops = 0
    for key, n in zip(uniq, count):
        cq = [tuple(c) for c, ok in zip(cands[np.all(keys == key, 1)][0],
                                        key[2:]) if ok]
        ops += n * (_k2_interp_ops(cq, bd) + len(cq) * (256 + 16 * 96))
    # a lambda per block (blocks of several frames) is read once each
    nbytes = _nbytes([W, ob, mvi, pmv] + list(outs)) + (
        4 * lam.numel() if lam.numel() > 1 else 0)
    return _bound(nbytes, ops, INT32_OPS_PER_S)


def _capture_level(li, run):
    """``run()`` with wavefront level ``li`` recorded on the way: its carry
    before the step (cloned), its lane inputs and the plain step."""
    from x265_tpu_torch.encoder import ctu_scan_cuda
    real = ctu_scan_cuda.ctu_step
    got, n = {}, [0]

    def spy(scan, inter, decide32, carry, xs, plain):
        if n[0] == li:
            got.update(carry=tuple(c.clone() for c in carry), xs=xs,
                       plain=plain)
        n[0] += 1
        return real(scan, inter, decide32, carry, xs, plain)

    ctu_scan_cuda.ctu_step = spy
    try:
        out = run()
    finally:
        ctu_scan_cuda.ctu_step = real
    return out, got


def k1_inputs(dev, bd=8, mode=None, log2_ctb=6):
    """Seeded random inputs of the 1080p CTU scan, psy-rd 2.0, at bit depth
    ``bd`` (10: samples and predictions 0..1023 with a band of columns at 0
    and one at 1023, QPs 36..51) and CTB size ``1 << log2_ctb``.  ``mode``
    "rdoq": the scan with RDOQ and psy-RDOQ 1.0, and a CTU of the busiest
    level planted so that a TU32 trial codes a level of 8192
    (``smoke_config.plant_level_8192``); "nr": with noise reduction, seeded
    offsets (some zero, DC zero).  Returns ``(scan, li, n_real, go)``: the
    busiest wavefront level ``li`` with its ``n_real`` real lanes, and
    ``go(cfg, route, frames=1)`` that runs the whole scan (62 levels at CTB
    64, 126 at 32, 254 at 16; decide32 where the CTB has 32x32 quads, as
    the pipelines run it), ``cfg`` "I" or "P", ``route`` "kernel" or
    "plain", of one frame or of two frames batched (the second from its own
    seed)."""
    import numpy as np
    import torch
    from x265_tpu_torch.common.geometry import PictureGeometry
    from x265_tpu_torch.encoder.ctu_scan import NR_CATS, CtuScan
    from x265_tpu_torch.smoke_config import plant_level_8192

    g = PictureGeometry(1920, 1088, log2_ctb, 3)
    ph, pw = g.ctbs_h << log2_ctb, g.ctbs_w << log2_ctb
    b16, b32, nctb = (ph // 16) * (pw // 16), (ph // 32) * (pw // 32), \
        g.n_ctbs

    def T(a):
        return torch.as_tensor(a).to(dev)

    hi, dt = 1 << bd, np.uint8 if bd == 8 else np.uint16

    def smp(rng, shape, dtype):
        a = rng.randint(0, hi, shape)
        if bd != 8:                   # the clamps: bands at 0 and 2^bd - 1
            w = shape[-1]
            a[..., :w // 8] = 0
            a[..., w // 2:w // 2 + w // 8] = hi - 1
        return a.astype(dtype)

    def frame(seed):
        rng = np.random.RandomState(seed)
        x = dict(
            oy=T(smp(rng, (ph, pw), dt)),
            ocb=T(smp(rng, (ph // 2, pw // 2), dt)),
            ocr=T(smp(rng, (ph // 2, pw // 2), dt)),
            qp=T((rng.randint(24, 40, nctb) + 6 * (bd - 8)).astype(
                np.int32)),
            lam=T((0.85 * 2.0 ** (rng.randint(24, 40, nctb) / 3.0 - 4.0)
                   ).astype(np.float32)),
            modes=T(rng.randint(0, 35, b16).astype(np.int32)),
            mode32=T(rng.randint(0, 35, b32).astype(np.int32)),
            use32=torch.zeros((b32,), dtype=torch.bool, device=dev),
            is_inter=T(rng.rand(b16) < 0.7),
            ipred_y=T(smp(rng, (b16, 16, 16), np.int32)),
            ipred_cb=T(smp(rng, (b16, 8, 8), np.int32)),
            ipred_cr=T(smp(rng, (b16, 8, 8), np.int32)),
            m32_in=T(rng.rand(b32) < 0.4))
        return x

    scan = CtuScan(g, bit_depth=bd, sign_hide=True,
                   strong_intra_smoothing=True, psy_rd=2.0,
                   rdoq=mode == "rdoq", noise_reduction=mode == "nr",
                   psy_rdoq=1.0 if mode == "rdoq" else 0.0)
    real = (scan.t["xs"]["ctu"] < nctb).sum(1)
    li = int(real.argmax())
    one = frame(1)
    if mode == "rdoq":   # a CTU of level li (cx + 2 cy = li)
        c = int(scan.t["xs"]["ctu"][li][0]) if log2_ctb != 6 else \
            5 * g.ctbs_w + li - 10
        plant_level_8192(one, c % g.ctbs_w, c // g.ctbs_w, g.ctbs_w, bd,
                         1 << log2_ctb)
    two = {k: torch.stack([v, w]) for (k, v), w in zip(
        one.items(), frame(2).values())}
    inter_keys = ("is_inter", "ipred_y", "ipred_cb", "ipred_cr", "m32_in")
    nr_offsets = None
    if mode == "nr":
        rng = np.random.RandomState(9)
        nr_offsets = {}
        for cat, n in NR_CATS:
            for sfx in ("_i", "_p"):
                v = rng.randint(0, 60, n * n) * (rng.rand(n * n) < 0.7)
                v[0] = 0
                nr_offsets[cat + sfx] = v.astype(np.int32)

    def go(cfg, route, frames=1):
        x = one if frames == 1 else two
        fn = scan.scan_fn(inter=cfg == "P", decide32=scan.t["has32"],
                          allow_kernel=route == "kernel")
        return fn(x["oy"], x["ocb"], x["ocr"], x["modes"], x["mode32"],
                  x["use32"], x["qp"], x["qp"], x["qp"], lam=x["lam"],
                  nr_offsets=nr_offsets,
                  **({k: x[k] for k in inter_keys} if cfg == "P" else {}))

    return scan, li, int(real[li]), go


def _k1_level(lib, scan, li, is_p, run, label):
    """K1 at wavefront level ``li`` of ``run()``, alone: one launch against
    one plain step on the level's carry (outputs and carry equal), the
    one-launch time, the plain step's time and the bound."""
    import torch
    from x265_tpu_torch.encoder import ctu_scan_cuda

    _out, lvl = _capture_level(li, run)
    xs, carry0, plain = lvl["xs"], lvl["carry"], lvl["plain"]
    ck = tuple(c.clone() for c in carry0)
    carry_k, ys_k = ctu_scan_cuda.launch(lib, scan, is_p, scan.t["has32"],
                                         ck, xs)
    carry_p, ys_p = plain(tuple(c.clone() for c in carry0), xs)
    torch.cuda.synchronize()
    err = max(_max_abs_err(carry_k, carry_p), _max_abs_err(ys_k, ys_p))
    if err != 0.0:
        _report_diff(f"{label} carry", carry_k, carry_p)
        _report_diff(f"{label} outputs", ys_k, ys_p)
    ms = k1_launch_ms(lib, scan, is_p, xs, carry0, 50)
    plain_ms = _events_ms(lambda: plain(carry0, xs), 3)
    bound_ms, bound_by = k1_level_bound(xs, ys_k, is_p, scan)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, err=err, L=xs["cx"].shape[0],
                F=carry0[0].shape[0],
                n8192=int((ys_p[2].abs() == 8192).sum())
                if ys_p[2] is not None else 0)


def _ctb_tag(log2_ctb):
    return "" if log2_ctb == 6 else f" CTB {1 << log2_ctb}"


def check_k1(dev, lib, bd=8, mode=None, log2_ctb=6, cfgs=("I", "P"),
             batched=True):
    """K1 vs the plain step at CTB size ``1 << log2_ctb``: at 8 bits full
    scans of random 1080p inputs, then (at ``bd``) the busiest level alone
    (equality, one-launch time, bound), for one frame and (``batched``)
    for two frames batched, for each of ``cfgs``.  ``mode`` "rdoq" / "nr"
    (``k1_inputs``): the busiest level alone, with the outputs and the NR
    sums equal, and with RDOQ a level of 8192 coded in the P frame's
    planted CTU."""
    import torch

    scan, li, n_real, run = k1_inputs(dev, bd, mode, log2_ctb)
    nl = scan.t["n_levels"]
    res = {}
    tag = (f"K1 {bd}-bit" if bd != 8 else "K1") + _ctb_tag(log2_ctb)
    if mode:
        tag += f" {mode}"
    for cfg in cfgs:
        is_p = cfg == "P"

        def go(route, frames=1, cfg=cfg):
            return run(cfg, route, frames)

        scan_err = 0.0
        if mode:
            scan_ms = _events_ms(lambda: go("kernel"), 1)
            scan_plain_ms = None
            print(f"{tag} {cfg}: {nl}-level scan {scan_ms:.3f} ms kernel",
                  flush=True)
        elif bd == 8:
            out_k = go("kernel")
            out_p = go("plain")
            torch.cuda.synchronize()
            scan_err = _max_abs_err(out_k, out_p)
            if scan_err != 0.0:
                _report_diff("scan", out_k, out_p)
            scan_ms = _events_ms(lambda: go("kernel"), 2)
            scan_plain_ms = _events_ms(lambda: go("plain"), 1)
            print(f"{tag} {cfg}: {nl}-level scan {scan_ms:.3f} ms kernel, "
                  f"{scan_plain_ms:.3f} ms plain, max_abs_err {scan_err}",
                  flush=True)
        else:
            scan_ms = _events_ms(lambda: go("kernel"), 2)
            scan_plain_ms = None
            print(f"{tag} {cfg}: {nl}-level scan {scan_ms:.3f} ms kernel",
                  flush=True)
        # the busiest level alone: one frame, then two frames batched
        rs = [_k1_level(lib, scan, li, is_p, lambda: go("kernel"),
                        f"{tag} {cfg} level")]
        if batched:
            rs.append(_k1_level(lib, scan, li, is_p,
                                lambda: go("kernel", frames=2),
                                f"{tag} {cfg} F=2 level"))
        for r in rs:
            print(f"{tag} {cfg}: level {li} (F = {r['F']}, L = {r['L']}, "
                  f"{r['F'] * n_real} real lanes): {r['ms']:.4f} ms per "
                  f"launch, plain step {r['plain_ms']:.3f} ms, bound "
                  f"{r['bound_ms']:.5f} ms ({r['bound_by']}), max_abs_err "
                  f"{r['err']}", flush=True)
        if scan_err != 0.0 or any(r["err"] != 0.0 for r in rs):
            raise AssertionError(
                f"{tag} differs from the plain step ({cfg})")
        if mode == "rdoq" and is_p:
            print(f"{tag} P: levels of 8192 at level {li}: "
                  f"{rs[0]['n8192']}", flush=True)
            if rs[0]["n8192"] == 0:
                raise AssertionError(f"{tag}: the planted level 8192 was "
                                     "not coded")
        res[cfg] = dict(rs[0], scan_ms=scan_ms, scan_plain_ms=scan_plain_ms,
                        F2=rs[1] if batched else None, level=li,
                        n_levels=nl)
    return res


def k2_inputs(kind, B, mrq, seed, bd=8):
    """Seeded numpy inputs of K2 (W [B, 25, 25], ob [B, 16, 16], mvi and
    pmv [B, 2], int32) of ``bd``-bit samples and its lambda's qp (None:
    lambda 0), by ``kind``:
      "random": noisy windows around random rows, search-range motion;
      "flat": each window and source block one value, lambda 0 and mvi
        inside the range, so every candidate of a round ties and the first
        wins;
      "extreme": every sample 0 or 2^bd - 1 (the clip and the filters'
        extreme intermediates);
      "edge": mvi at +-mrq and +-(mrq + 1), pmv = 4 * mvi: candidates
        beyond the range cost 2^30, and at mrq + 1 all of a block's do
        (ties among them); the others tie by symmetric mv bits."""
    import numpy as np
    rng = np.random.RandomState(seed)
    hi, noise = 1 << bd, 20 << (bd - 8)
    pmv = (4 * rng.randint(-(mrq - 8), mrq - 7, (B, 2))).astype(np.int32)
    mvi = rng.randint(-mrq, mrq + 1, (B, 2)).astype(np.int32)
    qp = 32
    if kind == "random":
        base = rng.randint(0, hi, (B, 1, 25))
        W = np.clip(base + rng.randint(-noise, noise + 1, (B, 25, 25)), 0,
                    hi - 1)
        ob = rng.randint(0, hi, (B, 16, 16))
    elif kind == "flat":
        W = np.broadcast_to(rng.randint(0, hi, (B, 1, 1)), (B, 25, 25))
        ob = np.broadcast_to(rng.randint(0, hi, (B, 1, 1)), (B, 16, 16))
        mvi = rng.randint(1 - mrq, mrq, (B, 2)).astype(np.int32)
        qp = None
    elif kind == "extreme":
        W = (hi - 1) * rng.randint(0, 2, (B, 25, 25))
        ob = (hi - 1) * rng.randint(0, 2, (B, 16, 16))
    elif kind == "edge":
        W = rng.randint(0, hi, (B, 25, 25))
        ob = rng.randint(0, hi, (B, 16, 16))
        mvi = (rng.choice([-1, 1], (B, 2))
               * (mrq + rng.randint(0, 2, (B, 2)))).astype(np.int32)
        pmv = 4 * mvi
    else:
        raise ValueError(kind)
    i32 = np.int32
    return (np.ascontiguousarray(W, i32), np.ascontiguousarray(ob, i32),
            mvi.astype(i32), pmv.astype(i32), qp)


def k2_case(kind, B, mrq, seed, dev, bd=8):
    """``k2_inputs`` as tensors on ``dev``, with the lambda as the
    encoder's float32 scalar (0 where the kind has none)."""
    import torch
    from x265_tpu_torch.encoder.device_pipeline import me_lambda
    W, ob, mvi, pmv, qp = k2_inputs(kind, B, mrq, seed, bd)
    lam = (me_lambda(qp) if qp is not None
           else torch.zeros((), dtype=torch.float32))
    return tuple(torch.as_tensor(a).to(dev) for a in (W, ob, mvi, pmv)) + (
        lam.to(dev),)


def check_k2(dev, lib, bd=8):
    """K2 vs the plain refine at the 1080p shapes (B = 8160, subme 2,
    merange 57) at bit depth ``bd``: exactness on the random, flat (ties),
    extreme and range-edge sets, then on the random set the one-launch
    time, the plain version's time and the bound."""
    import torch
    from x265_tpu_torch.encoder import me_cuda

    B, mrq = 8160, 57
    tag = f"K2 {bd}-bit" if bd != 8 else "K2"
    err = 0.0
    for seed, kind in enumerate(("random", "flat", "extreme", "edge")):
        W, ob, mvi, pmv, lam = k2_case(kind, B, mrq, seed + 2, dev, bd)
        for subme in (2, 1, 0) if kind != "random" else (2,):
            k = me_cuda.launch(lib, W, ob, mvi, pmv, lam, subme, mrq, bd)
            p = me_cuda.refine_plain(W, ob, mvi, pmv, lam, subme, mrq, bd)
            torch.cuda.synchronize()
            e = _max_abs_err(k, p)
            print(f"{tag} {kind} subme {subme}: max_abs_err {e}", flush=True)
            if e != 0.0:
                _report_diff(f"{tag} {kind} subme {subme}", k, p)
            err = max(err, e)
        if kind == "random":
            keep = (W, ob, mvi, pmv, lam, k)
    if err != 0.0:
        raise AssertionError(f"{tag} differs from the plain refine")
    W, ob, mvi, pmv, lam, k = keep
    ms = _events_ms(lambda: me_cuda.launch(lib, W, ob, mvi, pmv, lam, 2,
                                           mrq, bd), 20)
    plain_ms = _events_ms(lambda: me_cuda.refine_plain(W, ob, mvi, pmv, lam,
                                                       2, mrq, bd), 3)
    bound_ms, bound_by = k2_bound(W, ob, mvi, pmv, k, lam, mrq, bd)
    print(f"{tag}: B={B} subme 2 merange {mrq}: {ms:.4f} ms kernel, "
          f"{plain_ms:.3f} ms plain, bound {bound_ms:.5f} ms ({bound_by}), "
          f"max_abs_err {err}", flush=True)
    # two frames' blocks in one launch, each frame with its own lambda
    from x265_tpu_torch.encoder.device_pipeline import me_lambda
    W, ob, mvi, pmv, _lam = k2_case("random", 2 * B, mrq, 6, dev, bd)
    half = W.shape[0] // 2
    lam2 = torch.cat([me_lambda(q).to(dev).expand(half) for q in (32, 35)])
    k = me_cuda.launch(lib, W, ob, mvi, pmv, lam2, 2, mrq, bd)
    p = me_cuda.refine_plain(W, ob, mvi, pmv, lam2, 2, mrq, bd)
    torch.cuda.synchronize()
    err2 = _max_abs_err(k, p)
    if err2 != 0.0:
        _report_diff(f"{tag} two lambdas", k, p)
        raise AssertionError(f"{tag} differs from the plain refine (two "
                             "lambdas)")
    ms2 = _events_ms(lambda: me_cuda.launch(lib, W, ob, mvi, pmv, lam2, 2,
                                            mrq, bd), 20)
    plain_ms2 = _events_ms(lambda: me_cuda.refine_plain(
        W, ob, mvi, pmv, lam2, 2, mrq, bd), 3)
    bound_ms2, bound_by2 = k2_bound(W, ob, mvi, pmv, k, lam2, mrq, bd)
    print(f"{tag}: B={W.shape[0]} (two frames, two lambdas) subme 2 merange "
          f"{mrq}: "
          f"{ms2:.4f} ms kernel, {plain_ms2:.3f} ms plain, bound "
          f"{bound_ms2:.5f} ms ({bound_by2}), max_abs_err {err2}",
          flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, err=max(err, err2),
                F2=dict(ms=ms2, plain_ms=plain_ms2, bound_ms=bound_ms2,
                        bound_by=bound_by2, err=err2, B=W.shape[0]))


def encode_slice(dev, name=""):
    """The 1080p IPPP slice (``name`` "": ``smoke_params``; "ctu16":
    ``smoke_params_ctu16``) through Encoder.encode_frame; returns the
    stream and per-frame wall seconds."""
    import torch
    from x265_tpu_torch import Encoder, Params
    from x265_tpu_torch import smoke_config as sc

    frames = sc.smoke_frames()
    enc = Encoder(Params(**getattr(sc, "smoke_params" + (
        f"_{name}" if name else ""))()), device=dev)
    aus, secs = [enc.headers()], []
    for planes in frames:
        torch.cuda.synchronize()
        t0 = time.time()
        au, _rec = enc.encode_frame(planes)
        torch.cuda.synchronize()
        secs.append(time.time() - t0)
        aus.append(au)
    return aus, secs


def encode_b_slice(dev):
    """The 1080p B slice through push_frame / flush; returns the stream's
    access units (headers first), the encode-order POCs, and the wall
    seconds of each push_frame call and of flush with the POCs each
    returned."""
    import torch
    from x265_tpu_torch import Encoder, Params
    from x265_tpu_torch.smoke_config import smoke_frames_b, smoke_params_b

    enc = Encoder(Params(**smoke_params_b()), device=dev)
    efs, calls = [], []
    for planes in smoke_frames_b() + [None]:
        torch.cuda.synchronize()
        t0 = time.time()
        out = enc.flush() if planes is None else enc.push_frame(planes)
        torch.cuda.synchronize()
        calls.append((time.time() - t0, [ef.poc for ef in out]))
        efs += out
    return ([enc.headers()] + [ef.au for ef in efs], [ef.poc for ef in efs],
            calls)


def bench_launches(kinds, refs=3, levels=62):
    """K1 and K2 launches of an encode with b-pyramid at 1080p from its
    encode-order slice kinds: an anchor (I or P) and the Bs that follow it
    form a mini-GOP.  Every dispatch runs the scan of ``levels`` levels (62
    at CTB 64, 126 at CTB 32; one K1 launch a level); a P dispatch
    searches its ``refs`` reference slots (one K2
    launch each: min(4, ref), 3 at the defaults, 4 for slow), a B dispatch
    its two lists (one each).  n Bs take one dispatch for n = 1; for n >= 2
    the middle B is a reference B dispatched alone, and each side of it one
    dispatch (batched when it holds two Bs)."""
    groups = []
    for k in kinds:
        if k == "B":
            groups[-1][1] += 1
        else:
            groups.append([k, 0])
    k1 = k2 = 0
    for anchor, nb in groups:
        mid = nb // 2
        b_disp = nb if nb < 2 else 1 + (mid > 0) + (nb - 1 - mid > 0)
        k1 += levels * (1 + b_disp)
        k2 += (refs if anchor == "P" else 0) + 2 * b_disp
    return k1, k2


def _lookahead_timers(stats):
    """Wrap the lookahead's three parts with synchronised timers adding to
    ``stats``: the lowres analysis of each pushed frame (the host downscale
    and the lowres program), the b-adapt trellis (its pair-cost and bidir
    programs and the host path search) and cuTree's host propagation.
    Returns a function that unwraps them."""
    import torch
    from x265_tpu_torch.encoder import intra_encoder, lookahead

    saved = []

    def wrap(owner, name, key):
        real = getattr(owner, name)
        saved.append((owner, name, real))

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*a, **k)
            torch.cuda.synchronize()
            stats[key] = stats.get(key, 0.0) + time.perf_counter() - t0
            return out
        setattr(owner, name, timed)

    wrap(lookahead.Lookahead, "_analyze", "lowres analysis")
    wrap(intra_encoder.Encoder, "_slicetype_decide", "b-adapt trellis")
    wrap(lookahead.Lookahead, "_propagate", "cuTree propagate")

    def unwrap():
        for owner, name, real in saved:
            setattr(owner, name, real)
    return unwrap


def encode_bench_slice(dev, lookahead_stats=None, name="bench"):
    """A slice (``name`` "bench", "bench10" or "slow", the lookahead on, or
    "nr") through push_frame / flush with a fresh Encoder; returns the stream's
    access units (headers first), the encode-order POCs and kinds, the wall
    seconds of each call with the POCs it returned, and the encoder.  With
    ``lookahead_stats`` (a dict) the lookahead's parts are timed into it."""
    import torch
    from x265_tpu_torch import Encoder, Params
    from x265_tpu_torch import smoke_config as sc

    params = getattr(sc, f"smoke_params_{name}")()
    frames = getattr(sc, f"smoke_frames_{name}")()
    unwrap = (_lookahead_timers(lookahead_stats)
              if lookahead_stats is not None else None)
    try:
        enc = Encoder(Params(**params), device=dev)
        efs, calls = [], []
        for planes in frames + [None]:
            torch.cuda.synchronize()
            t0 = time.time()
            out = enc.flush() if planes is None else enc.push_frame(planes)
            torch.cuda.synchronize()
            calls.append((time.time() - t0, [ef.poc for ef in out]))
            efs += out
    finally:
        if unwrap is not None:
            unwrap()
    return ([enc.headers()] + [ef.au for ef in efs], [ef.poc for ef in efs],
            [ef.kind for ef in efs], calls, enc)


def check_bench_slice(dev, smi, name="bench"):
    """Phase 6 (``name`` "bench"), 7 ("bench10") or 8 ("slow"): the slice
    against its golden; returns the K1 and K2 launches of the timed encode
    (phase 7: also that every one of them took the kernels' 10-bit path;
    phase 8: every K1 launch the RDOQ path, and P frames searching 4
    references)."""
    from x265_tpu_torch.encoder import ctu_scan_cuda, me_cuda

    main10 = name == "bench10"
    with open(os.path.join(ROOT, "x265_tpu_torch", "data",
                           f"golden_1080p_{name}.json")) as f:
        golden = json.load(f)
    encode_bench_slice(dev, name=name)  # warm: first-call allocations
    la_stats = {}
    ctu_scan_cuda.LAUNCHES = ctu_scan_cuda.LAUNCHES_10BIT = 0
    ctu_scan_cuda.LAUNCHES_RDOQ = ctu_scan_cuda.LAUNCHES_NR = 0
    me_cuda.LAUNCHES = me_cuda.LAUNCHES_10BIT = 0
    aus, pocs, kinds, calls, enc = encode_bench_slice(dev, la_stats, name)
    n1, n2 = ctu_scan_cuda.LAUNCHES, me_cuda.LAUNCHES
    t1, t2 = ctu_scan_cuda.LAUNCHES_10BIT, me_cuda.LAUNCHES_10BIT
    r1, nr1 = ctu_scan_cuda.LAUNCHES_RDOQ, ctu_scan_cuda.LAUNCHES_NR
    stream = b"".join(aus)
    md5 = hashlib.md5(stream).hexdigest()
    wall = sum(c[0] for c in calls)
    la = enc.lookahead
    what = {"bench": "bench (bench.py's Params(qp=32, "
                     "decoded_picture_hash=3), defaults)",
            "bench10": "Main10 bench (internal_bit_depth=10, 10-bit frames)",
            "slow": 'slow (default_params("slow", qp=32, '
                    'decoded_picture_hash=3): RDOQ, psy-RDOQ 1.0, ref=4)'
            }[name]
    print(f"slice 1080p {what} on {smi}: bytes per AU "
          f"{[len(a) for a in aus]}, encode order "
          f"{list(zip(pocs, kinds))}, {len(pocs)} frames in {wall:.3f} s, "
          f"{len(pocs) / wall:.3f} fps", flush=True)
    for i, (sec, out) in enumerate(calls):
        what = "flush" if i == len(calls) - 1 else f"push_frame {i}"
        print(f"  {what}: {sec:.3f} s, returned POCs {out}", flush=True)
    la_total = sum(la_stats.values())
    print(f"  lookahead (synchronised): {la_total:.4f} s = " + ", ".join(
        f"{k} {v:.4f} s" for k, v in la_stats.items())
        + f"; program calls {la.calls}, outputs on {sorted(la.devices)}",
        flush=True)
    w1, w2 = bench_launches(golden["encode_kinds"], enc.num_ref)
    print(f"launches: K1 {n1} (want {w1}; 10-bit {t1}, RDOQ {r1}, NR "
          f"{nr1}), K2 {n2} (want {w2}, {enc.num_ref} references; 10-bit "
          f"{t2}); md5 {md5} (golden {golden['md5']})", flush=True)
    if (md5 != golden["md5"] or len(stream) != golden["total_bytes"]
            or pocs != golden["encode_pocs"]
            or kinds != golden["encode_kinds"]):
        for i, (a, b) in enumerate(zip([len(a) for a in aus],
                                       golden["au_bytes"])):
            if a != b:
                print(f"  first differing AU: {i} ({a} vs {b} bytes)",
                      flush=True)
                break
        raise AssertionError(f"{what} stream differs from x265_tpu's "
                             "golden")
    if n1 != w1 or n2 != w2 or (t1, t2) != ((n1, n2) if main10 else (0, 0)):
        raise AssertionError(f"the {what} slice did not run through K1/K2 "
                             "as expected")
    if r1 != (n1 if name == "slow" else 0) or nr1 != 0 or (
            name == "slow" and enc.num_ref != 4):
        raise AssertionError(f"the {what} slice's K1 launches did not take "
                             "the RDOQ path as expected")
    if (la.calls["lowres"] != len(pocs) or la.devices != {"cuda"}
            or not la.calls["pair"] or not la.calls["bidir"]):
        raise AssertionError("the lookahead's programs did not run on the "
                             "card as expected")
    return n1, n2


def check_nr_slice(dev, smi):
    """Phase 9: the NR slice (the B slice's configuration with
    noise_reduction_intra=noise_reduction_inter=600, ten frames: the second
    mini-GOP uses the offsets learned from the first) against its golden;
    every K1 launch on the NR path.  Returns the K1 and K2 launches."""
    from x265_tpu_torch.encoder import ctu_scan_cuda, me_cuda
    from x265_tpu_torch.smoke_config import smoke_frames_nr

    with open(os.path.join(ROOT, "x265_tpu_torch", "data",
                           "golden_1080p_nr.json")) as f:
        golden = json.load(f)
    encode_bench_slice(dev, name="nr")      # warm: first-call allocations
    ctu_scan_cuda.LAUNCHES = ctu_scan_cuda.LAUNCHES_NR = 0
    ctu_scan_cuda.LAUNCHES_RDOQ = 0
    me_cuda.LAUNCHES = 0
    aus, pocs, kinds, calls, enc = encode_bench_slice(dev, name="nr")
    n1, n2 = ctu_scan_cuda.LAUNCHES, me_cuda.LAUNCHES
    nr1, r1 = ctu_scan_cuda.LAUNCHES_NR, ctu_scan_cuda.LAUNCHES_RDOQ
    stream = b"".join(aus)
    md5 = hashlib.md5(stream).hexdigest()
    wall = sum(c[0] for c in calls)
    learned = sum(int(v.astype(bool).sum()) for v in enc._nr_offsets.values())
    print(f"slice 1080p NR (the B slice's configuration, "
          f"noise_reduction_intra=inter=600) on {smi}: bytes per AU "
          f"{[len(a) for a in aus]}, encode order {list(zip(pocs, kinds))}, "
          f"{len(pocs)} frames in {wall:.3f} s, {len(pocs) / wall:.3f} fps; "
          f"nonzero offsets at the end {learned}", flush=True)
    for i, (sec, out) in enumerate(calls):
        what = "flush" if i == len(calls) - 1 else f"push_frame {i}"
        print(f"  {what}: {sec:.3f} s, returned POCs {out}", flush=True)
    # the same frames without noise reduction: where the offsets reach
    # the stream
    import dataclasses
    from x265_tpu_torch import Encoder
    off = Encoder(dataclasses.replace(enc.params, noise_reduction_intra=0,
                                      noise_reduction_inter=0), device=dev)
    plain = [off.headers()]
    for planes in smoke_frames_nr() + [None]:
        plain += [ef.au for ef in (off.flush() if planes is None
                                   else off.push_frame(planes))]
    first = next((i for i, (a, b) in enumerate(zip(aus, plain)) if a != b),
                 None)
    print(f"  against the same frames without NR: first differing AU "
          f"{first} (POC {None if first is None else pocs[first - 1]})",
          flush=True)
    w1, w2 = bench_launches(golden["encode_kinds"], enc.num_ref)
    print(f"launches: K1 {n1} (want {w1}; NR {nr1}, RDOQ {r1}), K2 {n2} "
          f"(want {w2}); md5 {md5} (golden {golden['md5']})", flush=True)
    if n1 != w1 or n2 != w2 or nr1 != n1 or r1 != 0 or not learned:
        raise AssertionError("the NR slice did not run through K1/K2 as "
                             "expected")
    if (md5 != golden["md5"] or len(stream) != golden["total_bytes"]
            or pocs != golden["encode_pocs"]
            or kinds != golden["encode_kinds"]):
        raise AssertionError("NR stream differs from x265_tpu's golden")
    return n1, n2


def _ptxas_summary(log):
    """One line per kernel instantiation of ptxas's ``-v`` report: its
    template arguments, registers and spill bytes."""
    import re
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_Z\d+(\w+?)I(\w*?)EE",
                      line)
        if m:
            targs = re.findall(r"Li(\d+)E", m.group(2) + "E")
            name = f"{m.group(1)}<{', '.join(targs)}>"
        elif "spill" in line and name:
            spill = "/".join(re.findall(r"(\d+) bytes spill", line))
        elif "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line)
            out.append(f"{name}: {regs.group(1) if regs else '?'} "
                       f"registers, spill {spill} B")
            name = None
    return out


def _zero_counts():
    """Set every launch count of K1 and K2 to 0."""
    from x265_tpu_torch.encoder import ctu_scan_cuda, me_cuda
    for m in (ctu_scan_cuda, me_cuda):
        for k in dir(m):
            if k.startswith("LAUNCHES"):
                setattr(m, k, 0)


def check_preset_slice(dev, smi, name):
    """Phase 10 (``name`` "superfast") or 11 ("ultrafast"): the bench
    slice's ten frames at x265's preset (CTU 32, ``bframes=3`` with a
    fixed GOP, one reference, subme 1 / 0) through push_frame / flush, a
    warm and a timed encode with fresh Encoders; MD5, size, encode-order
    POCs and kinds equal to ``golden_1080p_<name>.json``, K1 and K2
    launched the counts ``bench_launches`` gives for 126 levels and one
    reference, every K1 launch at CTB 32 and none on another special path.
    Returns the K1 and K2 launches and the fps."""
    from x265_tpu_torch.encoder import ctu_scan_cuda, me_cuda

    with open(os.path.join(ROOT, "x265_tpu_torch", "data",
                           f"golden_1080p_{name}.json")) as f:
        golden = json.load(f)
    encode_bench_slice(dev, name=name)      # warm: first-call allocations
    _zero_counts()
    aus, pocs, kinds, calls, enc = encode_bench_slice(dev, name=name)
    k1 = ctu_scan_cuda
    stream = b"".join(aus)
    md5 = hashlib.md5(stream).hexdigest()
    wall = sum(x[0] for x in calls)
    levels = enc._get_ctu_scan().t["n_levels"]
    print(f"slice 1080p {name} (default_params(\"{name}\", qp=32, "
          f"decoded_picture_hash=1): CTU 32, {levels} levels) on {smi}: "
          f"bytes per AU {[len(a) for a in aus]}, encode order "
          f"{list(zip(pocs, kinds))}, {len(pocs)} frames in {wall:.3f} s, "
          f"{len(pocs) / wall:.3f} fps", flush=True)
    for i, (sec, out) in enumerate(calls):
        what = "flush" if i == len(calls) - 1 else f"push_frame {i}"
        print(f"  {what}: {sec:.3f} s, returned POCs {out}", flush=True)
    w1, w2 = bench_launches(golden["encode_kinds"], enc.num_ref, levels)
    n1, n2 = k1.LAUNCHES, me_cuda.LAUNCHES
    print(f"launches: K1 {n1} (want {w1}; CTB 32 {k1.LAUNCHES_CTB32}), "
          f"K2 {n2} (want {w2}, {enc.num_ref} reference); md5 {md5} "
          f"(golden {golden['md5']})", flush=True)
    if (md5 != golden["md5"] or len(stream) != golden["total_bytes"]
            or pocs != golden["encode_pocs"]
            or kinds != golden["encode_kinds"]):
        raise AssertionError(f"{name} stream differs from x265_tpu's golden")
    if (levels != 126 or n1 != w1 or n2 != w2 or k1.LAUNCHES_CTB32 != n1
            or k1.LAUNCHES_CTB16 or k1.LAUNCHES_10BIT or k1.LAUNCHES_RDOQ
            or k1.LAUNCHES_NR):
        raise AssertionError(f"the {name} slice did not run through K1/K2 "
                             "at CTB 32 as expected")
    return n1, n2, len(pocs) / wall


def check_ctu16_slice(dev, smi):
    """Phase 12: the IPPP slice at ``ctu_size=16`` with the MD5 hash SEI
    (``smoke_params_ctu16``) through encode_frame, a warm and a timed
    encode; MD5 and size equal to ``golden_1080p_ctu16.json``, K1 254
    launches a frame, all at CTB 16, K2 one per reference of a P frame.
    Returns the K1 and K2 launches and the fps."""
    from x265_tpu_torch.encoder import ctu_scan_cuda, me_cuda

    with open(os.path.join(ROOT, "x265_tpu_torch", "data",
                           "golden_1080p_ctu16.json")) as f:
        golden = json.load(f)
    encode_slice(dev, "ctu16")              # warm: first-call allocations
    _zero_counts()
    aus, secs = encode_slice(dev, "ctu16")
    k1 = ctu_scan_cuda
    n1, n2 = k1.LAUNCHES, me_cuda.LAUNCHES
    stream = b"".join(aus)
    md5 = hashlib.md5(stream).hexdigest()
    nfr = len(secs)
    fps = nfr / sum(secs)
    print(f"slice 1080p IPPP at CTU 16 (254 levels) on {smi}: bytes per AU "
          f"{[len(a) for a in aus]}, frame seconds "
          f"{[round(x, 3) for x in secs]}, {fps:.3f} fps", flush=True)
    print(f"launches: K1 {n1} (want {254 * nfr}; CTB 16 "
          f"{k1.LAUNCHES_CTB16}), K2 {n2} (want {3 * (nfr - 1)}); md5 "
          f"{md5} (golden {golden['md5']})", flush=True)
    if md5 != golden["md5"] or len(stream) != golden["total_bytes"]:
        raise AssertionError("CTU-16 stream differs from x265_tpu's golden")
    if (n1 != 254 * nfr or n2 != 3 * (nfr - 1) or k1.LAUNCHES_CTB16 != n1
            or k1.LAUNCHES_CTB32 or k1.LAUNCHES_10BIT):
        raise AssertionError("the CTU-16 slice did not run through K1/K2 at "
                             "CTB 16 as expected")
    return n1, n2, fps


def _golden(name):
    with open(os.path.join(ROOT, "x265_tpu_torch", "data",
                           f"golden_1080p_{name}.json")) as f:
        return json.load(f)


def _record_finishes():
    """Record every EncodedFrame that the port's Encoder finishes, in
    encode order, and the encoder; returns the list, a dict holding the
    encoder under "enc", and a function that unwraps."""
    from x265_tpu_torch.encoder import intra_encoder

    real = intra_encoder.Encoder._finish_one
    log, holder = [], {}

    def finish(self, pend):
        ef = real(self, pend)
        if not log or log[-1] is not ef:
            log.append(ef)
        holder["enc"] = self
        return ef

    intra_encoder.Encoder._finish_one = finish
    return log, holder, lambda: setattr(intra_encoder.Encoder,
                                        "_finish_one", real)


def _check_golden(what, stream, efs, golden):
    """The stream's MD5 and size and the encode order against a golden;
    returns the MD5."""
    md5 = hashlib.md5(stream).hexdigest()
    pocs, kinds = [ef.poc for ef in efs], [ef.kind for ef in efs]
    if (md5 != golden["md5"] or len(stream) != golden["total_bytes"]
            or pocs != golden["encode_pocs"]
            or kinds != golden["encode_kinds"]):
        for i, (a, b) in enumerate(zip([len(ef.au) for ef in efs],
                                       golden["au_bytes"])):
            if a != b:
                print(f"  first differing AU: {i} ({a} vs {b} bytes)",
                      flush=True)
                break
        raise AssertionError(f"{what} stream differs from x265_tpu's "
                             f"golden: md5 {md5} (golden {golden['md5']}),"
                             f" order {list(zip(pocs, kinds))}")
    return md5


def _check_launches(what, golden, enc):
    """K1 and K2 launches since the counts were zeroed against the counts
    ``bench_launches`` derives from the golden's encode order; returns
    them."""
    from x265_tpu_torch.encoder import ctu_scan_cuda, me_cuda

    n1, n2 = ctu_scan_cuda.LAUNCHES, me_cuda.LAUNCHES
    w1, w2 = bench_launches(golden["encode_kinds"], enc.num_ref,
                            enc._get_ctu_scan().t["n_levels"])
    print(f"launches: K1 {n1} (want {w1}), K2 {n2} (want {w2}, "
          f"{enc.num_ref} references)", flush=True)
    if n1 != w1 or n2 != w2:
        raise AssertionError(f"the {what} slice did not run through K1/K2 "
                             "as expected")
    return n1, n2


def _prefix_sei_types(au):
    """The payload types of each prefix SEI NAL (type 39) of an access
    unit, in order."""
    out = []
    for nal in au.split(b"\x00\x00\x01")[1:]:
        nal = nal.rstrip(b"\x00")
        if (nal[0] >> 1) & 0x3F != 39:
            continue
        rbsp = nal[2:].replace(b"\x00\x00\x03", b"\x00\x00")
        types, i = [], 0
        while i < len(rbsp) and rbsp[i:] != b"\x80":
            t = size = 0
            while rbsp[i] == 255:
                t, i = t + 255, i + 1
            t, i = t + rbsp[i], i + 1
            while rbsp[i] == 255:
                size, i = size + 255, i + 1
            size, i = size + rbsp[i], i + 1
            types.append(t)
            i += size
        out.append(types)
    return out


def check_crf_cli(smi):
    """Phase 13: the CLI at --crf 28 on a 1920x1080 Y4M of the bench
    slice's frames, in-process on the card.  Returns the K1 and K2
    launches and the fps."""
    import tempfile

    import torch
    from x265_tpu_torch import cli, io
    from x265_tpu_torch import smoke_config as sc

    golden = _golden("crf_cli")
    with tempfile.TemporaryDirectory() as tmp:
        y4m, out, csv = (os.path.join(tmp, f)
                         for f in ("in.y4m", "out.265", "log.csv"))
        frames = sc.smoke_frames_bench()
        io.write_y4m(y4m, frames, sc.WIDTH, sc.HEIGHT)
        log, holder, unwrap = _record_finishes()
        _zero_counts()
        try:
            torch.cuda.synchronize()
            t0 = time.time()
            rc = cli.main(sc.smoke_args_crf_cli(y4m, out, csv))
            torch.cuda.synchronize()
            wall = time.time() - t0
        finally:
            unwrap()
        if rc != 0:
            raise AssertionError(f"the CLI returned {rc}")
        with open(out, "rb") as f:
            stream = f.read()
        with open(csv) as f:
            csv_text = f.read()
    enc = holder["enc"]
    print(f"slice 1080p CLI --crf 28 (medium) on {smi}: {len(stream)} bytes, "
          f"encode order {[(ef.poc, ef.kind, ef.qp) for ef in log]}, "
          f"{len(frames)} frames in {wall:.3f} s (Y4M read, PSNR and CSV "
          f"included), {len(frames) / wall:.3f} fps; device "
          f"{enc.device}", flush=True)
    n1, n2 = _check_launches("CLI CRF", golden, enc)
    md5 = _check_golden("CLI CRF", stream, log, golden)
    if csv_text != golden["csv"]:
        raise AssertionError("the CLI's CSV differs from x265_tpu's:\n"
                             + csv_text)
    print(f"  md5 {md5} (golden {golden['md5']}), CSV equal "
          f"({csv_text.count(chr(10))} lines)", flush=True)
    return n1, n2, len(frames) / wall


def check_abr_vbv_hrd(smi):
    """Phase 14: ABR + VBV + HRD through the procedural API on the card.
    Returns the K1 and K2 launches and the fps."""
    import torch
    from x265_tpu_torch import api
    from x265_tpu_torch import smoke_config as sc

    golden = _golden("abr_vbv_hrd")
    frames = sc.smoke_frames_bench()
    p = api.x265_param_default_preset("medium")
    for name, value in sc.smoke_parse_abr_vbv_hrd():
        api.x265_param_parse(p, name, value)
    p.source_width, p.source_height = sc.WIDTH, sc.HEIGHT
    log, _holder, unwrap = _record_finishes()
    _zero_counts()
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        enc = api.x265_encoder_open(p)
        aus = [api.x265_encoder_headers(enc)]
        for planes in frames + [None] * 64:
            au, _rec = api.x265_encoder_encode(enc, planes)
            if planes is None and not au:
                break
            aus.append(au)
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        unwrap()
    aus = [a for a in aus if a]
    stream = b"".join(aus)
    st = api.x265_encoder_get_stats(enc)
    seis = [_prefix_sei_types(a) for a in aus[1:]]
    print(f"slice 1080p API ABR 1000 kbps, VBV 1000 kbps / 1000 kbit, HRD "
          f"(medium) on {smi}: bytes per AU {[len(a) for a in aus]}, encode "
          f"order {[(ef.poc, ef.kind, ef.qp) for ef in log]}, {len(log)} "
          f"frames in {wall:.3f} s, {len(log) / wall:.3f} fps; prefix SEI "
          f"payload types {seis}; stats {st}", flush=True)
    n1, n2 = _check_launches("ABR + VBV + HRD", golden, enc)
    md5 = _check_golden("ABR + VBV + HRD", stream, log, golden)
    if not enc.hrd or not enc.sps.hrd_present:
        raise AssertionError("HRD is off")
    for ef, types in zip(log, seis):
        flat = [t for nal in types for t in nal]
        if flat.count(1) != 1 or flat.count(0) != (ef.kind == "I"):
            raise AssertionError(f"POC {ef.poc} ({ef.kind}): prefix SEI "
                                 f"payload types {types}")
    if seis != golden["sei_types"]:
        raise AssertionError("the prefix SEIs differ from the golden's")
    if (st.encoded_picture_count != len(frames)
            or st.accumulated_bits != 8 * sum(len(a) for a in aus[1:])):
        raise AssertionError(f"x265_encoder_get_stats: {st}")
    print(f"  md5 {md5} (golden {golden['md5']}; without VBV "
          f"{golden['md5_without_vbv']})", flush=True)
    return n1, n2, len(log) / wall


def check_twopass(smi):
    """Phase 15: 2-pass ABR through encode_sequence on the card.  Returns
    pass 2's K1 and K2 launches and fps."""
    import tempfile

    import torch
    from x265_tpu_torch import Params
    from x265_tpu_torch import smoke_config as sc
    from x265_tpu_torch.encoder import encode_sequence

    golden = _golden("twopass")
    frames = sc.smoke_frames_bench()
    with tempfile.TemporaryDirectory() as tmp:
        stats = os.path.join(tmp, "2pass.log")
        torch.cuda.synchronize()
        t0 = time.time()
        s1, _ = encode_sequence(frames,
                                Params(**sc.smoke_params_twopass(stats, 1)))
        torch.cuda.synchronize()
        wall1 = time.time() - t0
        with open(stats) as f:
            text = f.read()
        log, holder, unwrap = _record_finishes()
        _zero_counts()
        try:
            torch.cuda.synchronize()
            t0 = time.time()
            s2, _ = encode_sequence(
                frames, Params(**sc.smoke_params_twopass(stats, 2)))
            torch.cuda.synchronize()
            wall2 = time.time() - t0
        finally:
            unwrap()
    enc = holder["enc"]
    print(f"slice 1080p 2-pass ABR 1000 kbps (medium) on {smi}: pass 1 "
          f"{len(s1)} bytes in {wall1:.3f} s, {len(frames) / wall1:.3f} fps;"
          f" pass 2 {len(s2)} bytes, encode order "
          f"{[(ef.poc, ef.kind, ef.qp) for ef in log]}, in {wall2:.3f} s, "
          f"{len(frames) / wall2:.3f} fps", flush=True)
    n1, n2 = _check_launches("2-pass", golden, enc)
    md5 = _check_golden("2-pass (pass 2)", s2, log, golden)
    md5_1 = hashlib.md5(s1).hexdigest()
    if md5_1 != golden["md5_pass1"]:
        raise AssertionError(f"pass 1's stream differs from x265_tpu's: "
                             f"{md5_1} (golden {golden['md5_pass1']})")
    if text != golden["stats"]:
        raise AssertionError("the stats file differs from x265_tpu's:\n"
                             + text)
    print(f"  md5 {md5} (golden {golden['md5']}), pass 1 {md5_1}, stats "
          f"file equal ({text.count(chr(10))} lines)", flush=True)
    return n1, n2, len(frames) / wall2


def check_lossless(smi):
    """Phase 16: two lossless frames through encode_sequence on the card:
    no K1 or K2 launch, recons equal to the sources.  Returns the fps."""
    import numpy as np
    import torch
    from x265_tpu_torch import Params
    from x265_tpu_torch import smoke_config as sc
    from x265_tpu_torch.encoder import (ctu_scan_cuda, encode_sequence,
                                        intra_encoder, me_cuda)

    golden = _golden("lossless")
    frames = sc.smoke_frames_lossless()
    log, holder, unwrap = _record_finishes()
    # the host time of the mode decision's gather tables (built once per
    # Encoder), beside the encoder's own entropy-coding time
    tables = [0.0]
    real_tables = intra_encoder.Encoder._mode_gather_tables

    def timed_tables(self, *a, **k):
        t = time.perf_counter()
        out = real_tables(self, *a, **k)
        tables[0] += time.perf_counter() - t
        return out

    intra_encoder.Encoder._mode_gather_tables = timed_tables
    _zero_counts()
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        stream, recons = encode_sequence(
            frames, Params(**sc.smoke_params_lossless()))
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        unwrap()
        intra_encoder.Encoder._mode_gather_tables = real_tables
    n1, n2 = ctu_scan_cuda.LAUNCHES, me_cuda.LAUNCHES
    enc = holder["enc"]
    print(f"slice 1080p lossless (2 frames, all-intra) on {smi}: bytes per "
          f"AU {[len(ef.au) for ef in log]}, {len(frames)} frames in "
          f"{wall:.3f} s, {len(frames) / wall:.3f} fps (gather tables "
          f"{tables[0]:.3f} s, native CABAC {enc._perf['entropy']:.3f} s); "
          f"device {enc.device}, scan built {enc._ctu_scan is not None}; "
          f"launches K1 {n1}, K2 {n2} (want 0, 0)", flush=True)
    md5 = _check_golden("lossless", stream, log, golden)
    if n1 or n2 or enc._ctu_scan is not None:
        raise AssertionError("the lossless slice ran the scan or the search")
    for fr, rec in zip(frames, recons):
        if not all(np.array_equal(a, b) for a, b in zip(fr, rec)):
            raise AssertionError("a lossless recon differs from its source")
    print(f"  md5 {md5} (golden {golden['md5']}), recons equal to the "
          "sources", flush=True)
    return len(frames) / wall


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import x265_tpu_torch  # noqa: F401  (fails outside a checkout)
    from x265_tpu_torch import build
    from x265_tpu_torch.encoder import ctu_scan_cuda, me_cuda

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.time()
    lib = build.load_library()
    srcs = [os.path.basename(x) for x in build._sources()]
    print(f"kernel build: {time.time() - t0:.1f} s (nvcc sm_90a, one "
          f"process per source, in parallel: {', '.join(srcs)}; K1 "
          f"instantiations: 3 CTB sizes x 2 bit depths x 4 modes), K1 "
          f"shared memory {lib.k1_smem_bytes()} B", flush=True)
    for line in _ptxas_summary(build.BUILD_LOG):
        print("ptxas:", line, flush=True)

    k1 = check_k1(dev, lib)
    k1_10 = check_k1(dev, lib, 10)
    k1m = {(mode, bd): check_k1(dev, lib, bd, mode)
           for mode in ("rdoq", "nr") for bd in (8, 10)}
    # K1 at CTB 32 and 16: I and P at F = 1 and 2, P at 10 bits, and (CTB
    # 32) the RDOQ P launch with a planted level of 8192
    kc = {}
    for lg in (5, 4):
        kc[lg] = check_k1(dev, lib, log2_ctb=lg)
        kc[lg, 10] = check_k1(dev, lib, 10, log2_ctb=lg, cfgs=("P",),
                              batched=False)
    kc[5, "rdoq"] = check_k1(dev, lib, mode="rdoq", log2_ctb=5, cfgs=("P",),
                             batched=False)
    k2 = check_k2(dev, lib)
    k2_10 = check_k2(dev, lib, 10)

    with open(os.path.join(ROOT, "x265_tpu_torch", "data",
                           "golden_1080p_ippp.json")) as f:
        golden = json.load(f)
    encode_slice(dev)                       # warm: first-call allocations
    ctu_scan_cuda.LAUNCHES = 0
    me_cuda.LAUNCHES = 0
    aus, secs = encode_slice(dev)
    n1, n2 = ctu_scan_cuda.LAUNCHES, me_cuda.LAUNCHES
    stream = b"".join(aus)
    md5 = hashlib.md5(stream).hexdigest()
    nfr = len(secs)
    fps = nfr / sum(secs)
    print(f"slice 1080p IPPP on {smi}: bytes per AU {[len(a) for a in aus]}"
          f", frame seconds {[round(s, 3) for s in secs]}, {fps:.3f} fps",
          flush=True)
    print(f"launches: K1 {n1} (want {62 * nfr}), K2 {n2} "
          f"(want {3 * (nfr - 1)}); md5 {md5} (golden {golden['md5']})",
          flush=True)
    if n1 != 62 * nfr or n2 != 3 * (nfr - 1):
        raise AssertionError("the slice did not run through K1/K2 as "
                             "expected")
    if md5 != golden["md5"] or len(stream) != golden["total_bytes"]:
        raise AssertionError("stream differs from x265_tpu's golden")

    # phase 5: the B slice
    with open(os.path.join(ROOT, "x265_tpu_torch", "data",
                           "golden_1080p_b.json")) as f:
        golden_b = json.load(f)
    encode_b_slice(dev)                     # warm: first-call allocations
    ctu_scan_cuda.LAUNCHES = 0
    me_cuda.LAUNCHES = 0
    aus_b, pocs, calls = encode_b_slice(dev)
    n1b, n2b = ctu_scan_cuda.LAUNCHES, me_cuda.LAUNCHES
    stream_b = b"".join(aus_b)
    md5_b = hashlib.md5(stream_b).hexdigest()
    wall_b = sum(c[0] for c in calls)
    print(f"slice 1080p B (bframes=4, b-pyramid) on {smi}: bytes per AU "
          f"{[len(a) for a in aus_b]}, encode-order POCs {pocs}, "
          f"{len(pocs) / wall_b:.3f} fps", flush=True)
    for i, (sec, out) in enumerate(calls):
        what = "flush" if i == len(calls) - 1 else f"push_frame {i}"
        print(f"  {what}: {sec:.3f} s, returned POCs {out}", flush=True)
    print(f"launches: K1 {n1b} (want {62 * 5}), K2 {n2b} (want 9); md5 "
          f"{md5_b} (golden {golden_b['md5']})", flush=True)
    if n1b != 62 * 5 or n2b != 9:
        raise AssertionError("the B slice did not run through K1/K2 as "
                             "expected")
    if (md5_b != golden_b["md5"] or len(stream_b) != golden_b["total_bytes"]
            or pocs != golden_b["encode_pocs"]):
        raise AssertionError("B stream differs from x265_tpu's golden")

    # phase 6: the bench slice (bench.py's configuration, the lookahead on)
    n1s, n2s = check_bench_slice(dev, smi)
    # phase 7: the Main10 bench slice
    n1m, n2m = check_bench_slice(dev, smi, "bench10")
    # phase 8: the slow slice (RDOQ with psy-RDOQ, ref=4)
    n1w, n2w = check_bench_slice(dev, smi, "slow")
    # phase 9: the NR slice (the B slice with noise reduction)
    n1n, n2n = check_nr_slice(dev, smi)
    # phases 10-12: CTU 32 (the superfast and ultrafast presets) and 16
    n1f, n2f, _fps = check_preset_slice(dev, smi, "superfast")
    n1u, n2u, _fps = check_preset_slice(dev, smi, "ultrafast")
    n1c, n2c, _fps = check_ctu16_slice(dev, smi)
    # phases 13-16: the CLI at CRF, ABR + VBV + HRD through the API, 2-pass
    # through encode_sequence, lossless
    n1x, n2x, _fps = check_crf_cli(smi)
    n1v, n2v, _fps = check_abr_vbv_hrd(smi)
    n1t, n2t, _fps = check_twopass(smi)
    check_lossless(smi)

    kp, kp10 = k1["P"], k1_10["P"]
    # the RDOQ / NR busiest-level records: {mode}_{I|P}[_F2][_10bit]
    extra = {}
    for (mode, bd), r in k1m.items():
        sfx = "_10bit" if bd == 10 else ""
        for cfg in ("I", "P"):
            for k, v in (("", r[cfg]), ("_F2", r[cfg]["F2"])):
                for key in ("ms", "plain_ms", "bound_ms", "bound_by"):
                    extra[f"{key}_{mode}_{cfg}{k}{sfx}"] = v[key]
    err_m = max(max(r[c]["err"], r[c]["F2"]["err"]) for r in k1m.values()
                for c in ("I", "P"))
    # the CTB-32 / 16 records: {key}_ctb{32|16}_{I|P}[_F2][_10bit|_rdoq]
    for key, r in kc.items():
        lg, sfx = (key, "") if isinstance(key, int) else (
            key[0], "_10bit" if key[1] == 10 else f"_{key[1]}")
        for cfg, v in r.items():
            for k, w in (("", v), ("_F2", v["F2"])):
                if w is None:
                    continue
                for f in ("ms", "plain_ms", "bound_ms", "bound_by"):
                    extra[f"{f}_ctb{1 << lg}_{cfg}{k}{sfx}"] = w[f]
                err_m = max(err_m, w["err"])
            if v["scan_ms"] is not None:
                extra[f"scan_ms_ctb{1 << lg}_{cfg}{sfx}"] = v["scan_ms"]
    print(json.dumps({"kernels": [
        dict(name="K1 ctu_step", route="cuda",
             source="x265_tpu_torch/csrc/k1_ctu_step.cu",
             replaces="x265_tpu/encoder/ctu_scan_pallas.py:72",
             launches=(n1 + n1b + n1s + n1m + n1w + n1n + n1f + n1u + n1c
                       + n1x + n1v + n1t),
             max_abs_err=max(
                 k1["I"]["err"], kp["err"], kp["F2"]["err"],
                 k1["I"]["F2"]["err"], k1_10["I"]["err"], kp10["err"],
                 kp10["F2"]["err"], k1_10["I"]["F2"]["err"], err_m),
             ms=kp["ms"], plain_ms=kp["plain_ms"], bound_ms=kp["bound_ms"],
             bound_by=kp["bound_by"], library_ms=None,
             launches_ippp=n1, launches_b=n1b, launches_bench=n1s,
             ms_I=k1["I"]["ms"], scan_ms_P=kp["scan_ms"],
             scan_ms_I=k1["I"]["scan_ms"], ms_F2_P=kp["F2"]["ms"],
             plain_ms_F2_P=kp["F2"]["plain_ms"],
             bound_ms_F2_P=kp["F2"]["bound_ms"], ms_F2_I=k1["I"]["F2"]["ms"],
             launches_bench10=n1m, ms_10bit=kp10["ms"],
             plain_ms_10bit=kp10["plain_ms"], bound_ms_10bit=kp10["bound_ms"],
             ms_I_10bit=k1_10["I"]["ms"], ms_F2_P_10bit=kp10["F2"]["ms"],
             ms_F2_I_10bit=k1_10["I"]["F2"]["ms"],
             scan_ms_P_10bit=kp10["scan_ms"], launches_slow=n1w,
             launches_nr=n1n, launches_superfast=n1f,
             launches_ultrafast=n1u, launches_ctu16=n1c,
             launches_ctb32=n1f + n1u, launches_ctb16=n1c,
             launches_crf_cli=n1x, launches_abr_vbv_hrd=n1v,
             launches_twopass=n1t, launches_lossless=0, **extra),
        dict(name="K2 subpel_refine", route="cuda",
             source="x265_tpu_torch/csrc/k2_subpel_refine.cu",
             replaces="x265_tpu/encoder/me_pallas.py:71",
             launches=(n2 + n2b + n2s + n2m + n2w + n2n + n2f + n2u + n2c
                       + n2x + n2v + n2t),
             launches_slow=n2w, launches_nr=n2n, launches_superfast=n2f,
             launches_ultrafast=n2u, launches_ctu16=n2c,
             launches_crf_cli=n2x, launches_abr_vbv_hrd=n2v,
             launches_twopass=n2t, launches_lossless=0,
             max_abs_err=max(k2["err"], k2_10["err"]), ms=k2["ms"],
             plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None,
             launches_ippp=n2, launches_b=n2b, launches_bench=n2s,
             ms_F2=k2["F2"]["ms"],
             plain_ms_F2=k2["F2"]["plain_ms"],
             bound_ms_F2=k2["F2"]["bound_ms"], launches_bench10=n2m,
             ms_10bit=k2_10["ms"], plain_ms_10bit=k2_10["plain_ms"],
             bound_ms_10bit=k2_10["bound_ms"],
             bound_by_10bit=k2_10["bound_by"], ms_F2_10bit=k2_10["F2"]["ms"],
             plain_ms_F2_10bit=k2_10["F2"]["plain_ms"],
             bound_ms_F2_10bit=k2_10["F2"]["bound_ms"])]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
