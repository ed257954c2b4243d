"""Bjøntegaard-delta rate/PSNR calculator — numpy copy of
``x265_tpu.tools.bdrate``.

Given two rate-distortion curves [(bitrate_kbps, psnr_db), ...] it reports
the average bitrate delta at equal quality (BD-rate, %) and the average
PSNR delta at equal rate (BD-PSNR, dB) using cubic-polynomial
interpolation over log-rate (the role of libde265's
tools/bjoentegaard.cc).
"""

from __future__ import annotations

import numpy as np


def _bd_integral(rd_a, rd_b, rate_domain: bool):
    ra = np.log10([r for r, _ in rd_a])
    pa = np.array([p for _, p in rd_a])
    rb = np.log10([r for r, _ in rd_b])
    pb = np.array([p for _, p in rd_b])
    deg = min(3, len(ra) - 1, len(rb) - 1)
    if rate_domain:
        # fit log-rate as a function of PSNR
        ca = np.polyfit(pa, ra, deg)
        cb = np.polyfit(pb, rb, deg)
        lo = max(pa.min(), pb.min())
        hi = min(pa.max(), pb.max())
    else:
        ca = np.polyfit(ra, pa, deg)
        cb = np.polyfit(rb, pb, deg)
        lo = max(ra.min(), rb.min())
        hi = min(ra.max(), rb.max())
    if hi <= lo:
        raise ValueError("RD curves do not overlap")
    ia = np.polyval(np.polyint(ca), [lo, hi])
    ib = np.polyval(np.polyint(cb), [lo, hi])
    return ((ib[1] - ib[0]) - (ia[1] - ia[0])) / (hi - lo)


def bd_rate(anchor, test) -> float:
    """Average bitrate delta (%) of ``test`` vs ``anchor`` at equal PSNR.
    Negative = test needs fewer bits."""
    return (10.0 ** _bd_integral(anchor, test, rate_domain=True) - 1) * 100.0


def bd_psnr(anchor, test) -> float:
    """Average PSNR delta (dB) of ``test`` vs ``anchor`` at equal rate."""
    return _bd_integral(anchor, test, rate_domain=False)
