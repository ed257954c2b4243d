"""Command-line encoder — the x265 CLI equivalent, on the port: a copy of
``x265_tpu/cli.py`` whose encoder runs on ``--device`` (``cuda``, the
default, or ``cpu``).

Mirrors x265.cpp/x265cli.h's surface: Y4M/YUV input, Annex-B output,
preset/tune system, per-frame logging and an encode summary.
Usage:  python -m x265_tpu_torch.cli [options] -o out.265 in.y4m
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from . import trace
from .common.params import default_params, param_parse
from .encoder import Encoder
from .io.y4m import Y4MReader, Y4MWriter, YUVReader, YUVWriter


def _psnr(a, b, maxval=255.0):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 99.99 if mse <= 1e-12 else 10 * np.log10(maxval * maxval / mse)


def build_argparser():
    ap = argparse.ArgumentParser(
        prog="x265_tpu_torch",
        description="HEVC encoder on PyTorch / CUDA (x265-class CLI)")
    ap.add_argument("input", help="input file (.y4m or raw .yuv)")
    ap.add_argument("-o", "--output", required=True, help="output .265 file")
    ap.add_argument("--preset", default="medium")
    ap.add_argument("--tune", default=None)
    ap.add_argument("--input-res", default=None, help="WxH (raw YUV input)")
    ap.add_argument("--fps", default=None)
    ap.add_argument("--input-depth", type=int, default=8)
    ap.add_argument("-f", "--frames", type=int, default=0,
                    help="max frames to encode")
    ap.add_argument("--seek", type=int, default=0)
    ap.add_argument("--recon", default=None, help="write recon YUV/Y4M")
    ap.add_argument("--csv", default=None, help="per-frame CSV log")
    ap.add_argument("--no-progress", action="store_true")
    ap.add_argument("--dither", action="store_true",
                    help="error-diffusion when input depth > internal "
                         "depth (x265-extras.cpp:284)")
    ap.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace of the encode "
                         "(x265 PPA/VTune analogue) into this directory")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the encoder's device work runs")
    # remaining options go through param_parse (x265 spellings)
    return ap


def main(argv=None):
    ap = build_argparser()
    args, extra = ap.parse_known_args(argv)

    p = default_params(args.preset, args.tune)
    # unknown args: --name=value / --name value / --no-name
    i = 0
    while i < len(extra):
        tok = extra[i]
        if not tok.startswith("--"):
            ap.error(f"unexpected argument {tok!r}")
        name = tok[2:]
        val = None
        if "=" in name:
            name, val = name.split("=", 1)
        elif i + 1 < len(extra) and not extra[i + 1].startswith("--"):
            val = extra[i + 1]
            i += 1
        try:
            param_parse(p, name, val)
        except ValueError as e:
            ap.error(str(e))
        i += 1

    # input
    if args.input.endswith(".y4m"):
        rd = Y4MReader(args.input)
        p.source_width, p.source_height = rd.width, rd.height
        p.fps_num, p.fps_denom = rd.fps_num, rd.fps_denom
        p.internal_bit_depth = rd.bit_depth
    else:
        if args.input_res:
            w, h = args.input_res.lower().split("x")
            p.source_width, p.source_height = int(w), int(h)
        if not (p.source_width and p.source_height):
            ap.error("raw YUV input requires --input-res WxH")
        rd = YUVReader(args.input, p.source_width, p.source_height,
                       bit_depth=args.input_depth)
        p.internal_bit_depth = args.input_depth
    if args.fps:
        param_parse(p, "fps", args.fps)

    enc = Encoder(p, device=args.device)
    out = open(args.output, "wb")
    out.write(enc.headers())

    recon_w = None
    if args.recon:
        if args.recon.endswith(".y4m"):
            recon_w = Y4MWriter(args.recon, p.source_width, p.source_height,
                                p.fps_num, p.fps_denom,
                                bit_depth=p.internal_bit_depth)
        else:
            recon_w = YUVWriter(args.recon, p.internal_bit_depth)
    csv = open(args.csv, "w") if args.csv else None
    if csv:
        cols = ("frame,type,qp,bits,psnr_y,psnr_u,psnr_v,pct_intra,"
                "pct_merge,pct_skip,pct_cu64,pct_cu32,pct_cu16")
        if p.ssim:
            cols += ",ssim"
        csv.write(cols + "\n")

    maxval = float((1 << p.internal_bit_depth) - 1)
    n = 0
    total_bits = 0
    psnr_acc = np.zeros(3)
    ssim_acc = 0.0
    t0 = time.time()
    srcs = {}          # display_idx -> source frame (until PSNR'd)
    pending = {}       # display_idx -> EncodedFrame (until recon written)
    next_disp = 0      # next display index to write/log

    def drain(efs):
        """AUs go out in encode order; recon/CSV in display order."""
        nonlocal n, total_bits, next_disp, ssim_acc
        for ef in efs:
            out.write(ef.au)
            total_bits += len(ef.au) * 8
            n += 1
            pending[ef.display_idx] = ef
        while next_disp in pending:
            ef = pending.pop(next_disp)
            src = srcs.pop(next_disp)
            ps = [_psnr(r, f, maxval) for r, f in zip(ef.recon, src)] \
                if p.psnr else [0, 0, 0]
            psnr_acc[:] += ps
            sv = 0.0
            if p.ssim:
                from .ops.ssim import ssim_plane_np
                sv = ssim_plane_np(np.asarray(src[0]),
                                   np.asarray(ef.recon[0]),
                                   p.internal_bit_depth)
                ssim_acc += sv
            if recon_w:
                recon_w.write(ef.recon)
            if csv:
                st = ef.stats or {}
                row = (f"{next_disp},{ef.kind},{ef.qp},"
                       f"{len(ef.au) * 8},"
                       f"{ps[0]:.4f},{ps[1]:.4f},{ps[2]:.4f},"
                       f"{st.get('pct_intra', 0)},{st.get('pct_merge', 0)},"
                       f"{st.get('pct_skip', 0)},{st.get('pct_cu64', 0)},"
                       f"{st.get('pct_cu32', 0)},{st.get('pct_cu16', 0)}")
                if p.ssim:
                    row += f",{sv:.6f}"
                csv.write(row + "\n")
            next_disp += 1

    prof = None
    if args.profile_dir:
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if args.device == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                args.profile_dir))
        prof.__enter__()
        # the encoder's spans appear in the trace as user annotations
        trace.start()
    n_in = 0
    for idx, frame in enumerate(rd):
        if idx < args.seek:
            continue
        if args.frames and n_in >= args.frames:
            break
        if args.dither and args.input_depth > p.internal_bit_depth:
            from .native import dither_image
            frame = tuple(dither_image(
                [np.asarray(pl) for pl in frame], args.input_depth,
                p.internal_bit_depth))
        srcs[n_in] = frame
        n_in += 1
        drain(enc.push_frame(frame))
        if not args.no_progress and n and sys.stderr.isatty():
            el = time.time() - t0
            sys.stderr.write(f"\r[{n} frames, {n / el:.2f} fps, "
                             f"{total_bits * p.fps_num / (p.fps_denom * n * 1000):.2f} kb/s]")
            sys.stderr.flush()
    drain(enc.flush())
    if prof is not None:
        trace.stop()
        prof.__exit__(None, None, None)

    el = time.time() - t0
    if n:
        kbps = total_bits * p.fps_num / (p.fps_denom * n * 1000)
        msg = (f"\nencoded {n} frames in {el:.2f}s ({n / el:.2f} fps), "
               f"{kbps:.2f} kb/s")
        if p.psnr:
            pa = psnr_acc / n
            msg += (f", Global PSNR Y:{pa[0]:.3f} U:{pa[1]:.3f} "
                    f"V:{pa[2]:.3f}")
        if p.ssim:
            from .ops.ssim import ssim_db
            sa = ssim_acc / n
            msg += f", SSIM Mean Y: {sa:.7f} ({ssim_db(sa):.3f} dB)"
        print(msg, file=sys.stderr)
        print(enc.summary(), file=sys.stderr)
    out.close()
    if recon_w:
        recon_w.close()
    if csv:
        csv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
