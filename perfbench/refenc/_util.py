"""The exact float32 fused multiply-add of the encoder's RD costs."""

from __future__ import annotations

import torch


def fma32(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded ONCE, as a fused multiply-add.

    The float32 product is exact in float64; the float64 sum rounds once
    more, which matters only when it lands exactly on a float32 rounding
    midpoint: then the sum's exact error (TwoSum) moves it one float64 ulp
    to the side the exact value lies on, and the final rounding to float32
    is the fma's."""
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32)
    c = torch.as_tensor(c, dtype=torch.float32).double()
    p = a.double() * b.double()
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    low = s.view(torch.int64) & ((1 << 29) - 1)
    tie = (low == (1 << 28)) & (err != 0)
    s = torch.where(tie, torch.nextafter(s, torch.where(
        err > 0, float("inf"), float("-inf")).to(s.dtype)), s)
    return s.float()


_TABLE_CACHE: dict = {}


def dev_table(key, make, device) -> torch.Tensor:
    """A constant table built by ``make()`` (numpy), cached per device."""
    k = (key, str(device))
    t = _TABLE_CACHE.get(k)
    if t is None:
        t = _TABLE_CACHE[k] = torch.as_tensor(make()).to(device)
    return t
