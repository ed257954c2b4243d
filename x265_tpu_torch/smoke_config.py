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
  frames of ``synthetic_frame10`` panning 3 px a frame."""

from __future__ import annotations

import numpy as np

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
