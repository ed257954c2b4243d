"""Picture partitioning geometry: z-scan order, block availability, and CU
quadtree traversal tables.

Spec: ITU-T H.265 §6.4 (availability processes), §6.5.2 (z-scan order).
Reference embodiments: the z-order <-> raster tables and neighbor walkers of
x265_1.9/source/common/cudata.cpp:559-731 and libde265's MinTbAddrZS usage.

Design: everything is precomputed as per-picture numpy index tables at 4x4
(minimum TB) granularity; availability tests reduce to integer compares so
they vectorize cleanly for the batched encoder paths.
"""

from __future__ import annotations

import functools

import numpy as np


def interleave_bits(x: int, y: int) -> int:
    """Morton/z-order interleave of two small non-negative ints (y high)."""
    z = 0
    for i in range(16):
        z |= ((x >> i) & 1) << (2 * i)
        z |= ((y >> i) & 1) << (2 * i + 1)
    return z


@functools.lru_cache(maxsize=None)
def zscan_table(log2_ctb: int) -> np.ndarray:
    """[ctb_4x4, ctb_4x4] -> z index within a CTB at 4x4 granularity."""
    n = 1 << (log2_ctb - 2)
    t = np.zeros((n, n), dtype=np.int64)
    for y in range(n):
        for x in range(n):
            t[y, x] = interleave_bits(x, y)
    return t


class PictureGeometry:
    """Per-picture partitioning info (coded sizes are multiples of min CU).

    ``zscan[y4, x4]`` gives the global decode-order index of the 4x4 block at
    (x4*4, y4*4): CTBs in raster order, z-order within each CTB.  A sample at
    (x, y) is intra-available from (xc, yc) iff it's inside the picture and
    ``zscan`` of its block is strictly less than that of the current block
    (§6.4.1, single slice / no tiles).
    """

    def __init__(self, width: int, height: int, log2_ctb: int = 6,
                 log2_min_cb: int = 3):
        self.width = width
        self.height = height
        self.log2_ctb = log2_ctb
        self.log2_min_cb = log2_min_cb
        self.ctb_size = 1 << log2_ctb
        self.ctbs_w = (width + self.ctb_size - 1) >> log2_ctb
        self.ctbs_h = (height + self.ctb_size - 1) >> log2_ctb
        self.n_ctbs = self.ctbs_w * self.ctbs_h
        # padded (coded) size in 4x4 units
        self.w4 = self.ctbs_w << (log2_ctb - 2)
        self.h4 = self.ctbs_h << (log2_ctb - 2)

        n4 = 1 << (log2_ctb - 2)          # 4x4 blocks per CTB side
        per_ctb = n4 * n4
        zt = zscan_table(log2_ctb)
        y4 = np.arange(self.h4)
        x4 = np.arange(self.w4)
        ctb_rs = (y4[:, None] >> (log2_ctb - 2)) * self.ctbs_w + \
                 (x4[None, :] >> (log2_ctb - 2))
        self.zscan = ctb_rs * per_ctb + zt[np.ix_(y4 % n4, x4 % n4)]

    def ctu_origin(self, ctu_addr: int) -> tuple[int, int]:
        """Raster CTU address -> (x0, y0) in luma samples."""
        return ((ctu_addr % self.ctbs_w) << self.log2_ctb,
                (ctu_addr // self.ctbs_w) << self.log2_ctb)

    def available(self, xc: int, yc: int, xn: int, yn: int) -> bool:
        """§6.4.1 z-scan availability of neighbor (xn, yn) from (xc, yc)."""
        if xn < 0 or yn < 0 or xn >= self.width or yn >= self.height:
            return False
        return (self.zscan[yn >> 2, xn >> 2]
                < self.zscan[yc >> 2, xc >> 2])

    def avail_rows(self, xc: int, yc: int, xs: np.ndarray,
                   ys: np.ndarray) -> np.ndarray:
        """Vectorized availability of sample coords (xs, ys) from (xc, yc)."""
        inside = ((xs >= 0) & (ys >= 0)
                  & (xs < self.width) & (ys < self.height))
        zcur = self.zscan[yc >> 2, xc >> 2]
        zs = self.zscan[np.clip(ys, 0, self.height - 1) >> 2,
                        np.clip(xs, 0, self.width - 1) >> 2]
        return inside & (zs < zcur)


def intra_neighbor_coords(x0: int, y0: int, n: int):
    """Sample coordinates of the canonical 4N+1 reference vector for an NxN
    block at (x0, y0) (layout documented in ops.intra): below-left bottom-up,
    left bottom-up, corner, top, above-right."""
    xs = np.empty(4 * n + 1, dtype=np.int64)
    ys = np.empty(4 * n + 1, dtype=np.int64)
    i = np.arange(n)
    # below-left: p[-1][2N-1] .. p[-1][N]
    xs[0:n] = x0 - 1
    ys[0:n] = y0 + 2 * n - 1 - i
    # left: p[-1][N-1] .. p[-1][0]
    xs[n:2 * n] = x0 - 1
    ys[n:2 * n] = y0 + n - 1 - i
    # corner
    xs[2 * n] = x0 - 1
    ys[2 * n] = y0 - 1
    # top + above-right: p[0..2N-1][-1]
    xs[2 * n + 1:] = x0 + np.arange(2 * n)
    ys[2 * n + 1:] = y0 - 1
    return xs, ys
