"""The slice that ``chip_smoke.py`` encodes and ``tools/make_golden.py``
digests: 1080p 8-bit at ``Params()`` defaults with ``bframes=0``, four
frames (I P P P) of ``bench.synthetic_frame`` panning content, through the
zero-latency ``Encoder.encode_frame``."""

from __future__ import annotations

import os
import sys

import numpy as np

WIDTH, HEIGHT, FRAMES = 1920, 1080, 4


def smoke_params() -> dict:
    return dict(source_width=WIDTH, source_height=HEIGHT, bframes=0, qp=32,
                decoded_picture_hash=3)


def smoke_frames(n: int = FRAMES) -> list:
    """(Y, Cb, Cr) uint8 planes: the bench's synthetic frame panned 3 px
    per frame, as ``bench.py`` makes them."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from bench import synthetic_frame

    base = synthetic_frame(WIDTH, HEIGHT, 0)
    return [(np.roll(base[0], 3 * t, axis=1), base[1], base[2])
            for t in range(n)]
