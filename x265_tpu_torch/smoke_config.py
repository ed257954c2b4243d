"""The slices that ``chip_smoke.py`` encodes and ``tools/make_golden.py``
digests, all 1080p at ``Params()`` defaults with QP 32 and the checksum
hash SEI (``decoded_picture_hash=3``), of ``synthetic_frame`` panning
content (8-bit; ``synthetic_frame10`` at Main10):

* IPPP: ``bframes=0``, four frames (I P P P) through the zero-latency
  ``Encoder.encode_frame``;
* B: ``bframes=4`` with b-pyramid and the lookahead off
  (``rc_lookahead=0``), six frames through ``push_frame`` / ``flush``:
  encode order I0 P5 B3 (the reference B) B1 B2 (one batched dispatch)
  B4;
* bench: ``bench.py``'s own configuration and frames, ``Params(qp=32,
  decoded_picture_hash=3)`` at the defaults (``bframes=4``, b-pyramid,
  b-adapt 2, ``rc_lookahead=20``, cuTree, merange 57), ten frames through
  ``push_frame`` / ``flush``: the lookahead chooses the mini-GOPs;
* bench10: the bench slice at Main10 (``internal_bit_depth=10``), ten
  frames of ``synthetic_frame10`` panning 3 px a frame;
* slow: the bench slice's ten frames at ``default_params("slow", qp=32,
  decoded_picture_hash=3)``: RDOQ (``rdoq_level=2``) with psy-RDOQ 1.0,
  ``ref=4``, b-adapt 2 and ``rc_lookahead=25`` (the whole slice in one
  lookahead window);
* nr: the B slice's configuration with DCT-domain noise reduction,
  ``noise_reduction_intra=noise_reduction_inter=600``, on ten frames: the
  first mini-GOP is dispatched before any frame is fetched, so its offsets
  are still zero, and the second (P9 B7 B6 B8) uses the ones learned from
  the first.  With six frames the stream would equal the B slice's;
* superfast / ultrafast: the bench slice's ten frames at
  ``default_params("superfast" | "ultrafast", qp=32,
  decoded_picture_hash=1)``: x265's presets for live and real-time
  encoding, both at ``ctu_size=32`` (1080p: 60 x 34 CTBs, 126 wavefront
  levels), ``bframes=3`` with a fixed GOP (``b_adapt=0``), one reference,
  ``subme`` 1 / 0, no AQ or cuTree; ultrafast also without SAO and sign
  hiding, ``min_cu_size=16`` (read nowhere in either package);
* ctu16: the IPPP slice's configuration at ``ctu_size=16`` (120 x 68
  CTBs, 254 levels; no 32x32 candidate) with the MD5 hash SEI, four
  frames through ``encode_frame``.

The CTU-32 and CTU-16 slices carry the MD5 hash SEI
(``decoded_picture_hash=1``), the others the checksum.

The slices of the user-facing surface, on the bench slice's ten frames
(two for lossless), with the MD5 hash SEI, at the medium preset
(``Params()`` defaults: b-adapt 2, cuTree, AQ 2, 3 references):

* crf_cli: the CLI (``cli.main``) on a 1920x1080 Y4M of the frames at
  ``--crf 28`` with a CSV log (``smoke_args_crf_cli``);
* abr_vbv_hrd: the procedural API at ``bitrate=1000``,
  ``vbv-maxrate=1000``, ``vbv-bufsize=1000`` and ``hrd``
  (``smoke_parse_abr_vbv_hrd``): the VBV binds (the stream differs from
  the same ABR without it), every IRAP AU carries a buffering-period SEI
  and every AU a picture-timing SEI;
* twopass: 2-pass ABR at 1000 kbps through ``encode_sequence``: pass 1
  writes the stats file, pass 2 reads it (``smoke_params_twopass``);
* lossless: ``lossless=True`` through ``encode_sequence``, all-intra, two
  frames (``smoke_params_lossless``): no scan and no search."""

from __future__ import annotations

import dataclasses

import numpy as np

from .common.params import default_params

WIDTH, HEIGHT, FRAMES = 1920, 1080, 4
FRAMES_B = 6
FRAMES_BENCH = 10


def smoke_params() -> dict:
    return dict(source_width=WIDTH, source_height=HEIGHT, bframes=0, qp=32,
                decoded_picture_hash=3)


def smoke_params_b() -> dict:
    return dict(source_width=WIDTH, source_height=HEIGHT, bframes=4,
                b_pyramid=True, rc_lookahead=0, qp=32,
                decoded_picture_hash=3)


def smoke_params_bench() -> dict:
    return dict(source_width=WIDTH, source_height=HEIGHT, qp=32,
                decoded_picture_hash=3)


def smoke_params_bench10() -> dict:
    return dict(smoke_params_bench(), internal_bit_depth=10)


def smoke_params_slow() -> dict:
    """``default_params("slow", ...)``'s fields that differ from
    ``Params()``, with the bench slice's size, QP and hash."""
    return _preset_fields("slow", **smoke_params_bench())


def smoke_params_nr() -> dict:
    return dict(smoke_params_b(), noise_reduction_intra=600,
                noise_reduction_inter=600)


def _preset_fields(preset: str, **kw) -> dict:
    """``default_params(preset, **kw)``'s fields that differ from
    ``Params()``."""
    p = dataclasses.asdict(default_params(preset, **kw))
    base = dataclasses.asdict(default_params())
    return {k: v for k, v in p.items() if v != base[k]}


def smoke_params_superfast() -> dict:
    return _preset_fields("superfast", source_width=WIDTH,
                          source_height=HEIGHT, qp=32,
                          decoded_picture_hash=1)


def smoke_params_ultrafast() -> dict:
    return _preset_fields("ultrafast", source_width=WIDTH,
                          source_height=HEIGHT, qp=32,
                          decoded_picture_hash=1)


def smoke_params_ctu16() -> dict:
    return dict(smoke_params(), ctu_size=16, decoded_picture_hash=1)


def smoke_args_crf_cli(y4m: str, out: str, csv: str) -> list:
    """The CLI's arguments of the crf_cli slice (the input, the stream and
    the CSV log paths; the preset is medium)."""
    return [y4m, "-o", out, "--crf", "28", "--hash", "md5", "--csv", csv,
            "--no-progress"]


def smoke_parse_abr_vbv_hrd() -> list:
    """The abr_vbv_hrd slice's ``x265_param_parse`` calls after
    ``x265_param_default_preset("medium")`` (and the source size)."""
    return [("bitrate", "1000"), ("vbv-maxrate", "1000"),
            ("vbv-bufsize", "1000"), ("hrd", None), ("hash", "md5")]


def smoke_params_twopass(stats_file: str, stats_pass: int) -> dict:
    return dict(source_width=WIDTH, source_height=HEIGHT, rc_mode=2,
                bitrate=1000, decoded_picture_hash=1, stats_file=stats_file,
                stats_pass=stats_pass)


def smoke_params_lossless() -> dict:
    return dict(source_width=WIDTH, source_height=HEIGHT, lossless=True,
                decoded_picture_hash=1)


def smoke_frames_lossless() -> list:
    """The lossless slice's two frames (the bench slice's first two)."""
    return smoke_frames(2)


def synthetic_frame(w, h, seed=0):
    """Natural-ish content: smooth structures + texture + a little noise
    (a copy of ``bench.synthetic_frame``, which made the golden digest)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (120 + 60 * np.sin(xx / 41.0) * np.cos(yy / 29.0)
         + 40 * np.sin((xx + yy) / 97.0)
         + rng.randint(-6, 6, (h, w))).clip(0, 255).astype(np.uint8)
    u = (128 + 40 * np.sin(xx[::2, ::2] / 53.0)).clip(0, 255).astype(np.uint8)
    v = (128 + 40 * np.cos(yy[::2, ::2] / 67.0)).clip(0, 255).astype(np.uint8)
    return y, u, v


def smoke_frames(n: int = FRAMES) -> list:
    """(Y, Cb, Cr) uint8 planes: the synthetic frame panned 3 px per
    frame."""
    base = synthetic_frame(WIDTH, HEIGHT, 0)
    return [(np.roll(base[0], 3 * t, axis=1), base[1], base[2])
            for t in range(n)]


def smoke_frames_b() -> list:
    """The B slice's six display-order frames (``smoke_frames``'s pan)."""
    return smoke_frames(FRAMES_B)


def smoke_frames_bench() -> list:
    """The bench slice's ten display-order frames (``bench.py``'s)."""
    return smoke_frames(FRAMES_BENCH)


def smoke_frames_slow() -> list:
    """The slow slice's ten display-order frames (the bench slice's)."""
    return smoke_frames(FRAMES_BENCH)


def smoke_frames_nr() -> list:
    """The NR slice's ten display-order frames (the bench slice's)."""
    return smoke_frames(FRAMES_BENCH)


def smoke_frames_superfast() -> list:
    """The superfast slice's ten display-order frames (the bench
    slice's)."""
    return smoke_frames(FRAMES_BENCH)


def smoke_frames_ultrafast() -> list:
    """The ultrafast slice's ten display-order frames (the bench
    slice's)."""
    return smoke_frames(FRAMES_BENCH)


def plant_level_8192(x: dict, cx: int, cy: int, cw: int, bd: int,
                     ctb: int = 64) -> None:
    """Make the inter TU32 trial of CTU (cx, cy)'s first quad code a DC
    level of 8192 (the rate table's odd entry) on scan inputs ``x``
    (numpy arrays or tensors, ``chip_smoke.k1_inputs``' keys) at CTB size
    ``ctb`` (64 or 32): its four 16x16 blocks inter with a flat prediction
    and a flat residual r (the 32x32 DC coefficient 128 r at 8 bits, 32 r
    at 10), r = 160 at 8 bits and 640 at 10, at the CTU's QP 0 (12 with
    Main10's offset), where levels are (coef * 26214 + 2^15) >> 16: DC
    20480 -> 8192."""
    pw = x["oy"].shape[-1]
    gw16, gw32 = pw // 16, pw // 32
    base, r = (40, 160) if bd == 8 else (100, 640)
    x["oy"][ctb * cy:ctb * cy + 32, ctb * cx:ctb * cx + 32] = base + r
    n16, n32 = ctb // 16, ctb // 32
    for dy in (0, 1):
        for dx in (0, 1):
            b = (n16 * cy + dy) * gw16 + n16 * cx + dx
            x["ipred_y"][b] = base
            x["is_inter"][b] = True
    x["m32_in"][n32 * cy * gw32 + n32 * cx] = True
    x["qp"][cy * cw + cx] = 6 * (bd - 8)


def synthetic_frame10(w, h, seed=0):
    """10-bit content computed at 10 bits: ``synthetic_frame``'s formula
    scaled by 4 before rounding, noise of +-24, and in each plane a band
    of columns clipped at 0 and one clipped at 1023 (so that every clamp
    is reached; no sample is forced to a multiple of 4)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (np.rint(4 * (120 + 60 * np.sin(xx / 41.0) * np.cos(yy / 29.0)
                      + 40 * np.sin((xx + yy) / 97.0)))
         + rng.randint(-24, 25, (h, w)))
    u = np.rint(4 * (128 + 40 * np.sin(xx[::2, ::2] / 53.0))) + rng.randint(
        -24, 25, (h // 2, w // 2))
    v = np.rint(4 * (128 + 40 * np.cos(yy[::2, ::2] / 67.0))) + rng.randint(
        -24, 25, (h // 2, w // 2))
    out = []
    for p in (y, u, v):
        pw = p.shape[1]
        p[:, pw // 4:pw // 4 + pw // 40 + 1] -= 1024
        p[:, pw // 2:pw // 2 + pw // 40 + 1] += 1024
        out.append(p.clip(0, 1023).astype(np.uint16))
    return tuple(out)


def smoke_frames_bench10(w: int = WIDTH, h: int = HEIGHT,
                         n: int = FRAMES_BENCH) -> list:
    """The Main10 bench slice's display-order frames: ``synthetic_frame10``
    panned 3 px per frame (uint16 planes)."""
    base = synthetic_frame10(w, h, 0)
    return [(np.roll(base[0], 3 * t, axis=1), base[1], base[2])
            for t in range(n)]
