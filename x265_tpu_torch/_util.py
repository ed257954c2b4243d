"""Small shared helpers: exact float32 fused multiply-add, table caches,
the current-device context of the kernels' launches and the device dtype
of picture samples."""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

_TABLE_CACHE: dict = {}
_TABLE_LOCK = threading.Lock()


def dev_table(key, make, device) -> torch.Tensor:
    """A constant table built by ``make()`` (numpy), cached per device
    (filled under a lock: threads driving several devices share it)."""
    k = (key, str(device))
    t = _TABLE_CACHE.get(k)
    if t is None:
        with _TABLE_LOCK:
            t = _TABLE_CACHE.get(k)
            if t is None:
                t = _TABLE_CACHE[k] = torch.as_tensor(make()).to(device)
    return t


def on_device(dev):
    """The context that makes ``dev`` the calling thread's current CUDA
    device (nothing for a CPU device): a kernel launched through ctypes
    goes to the current device, whichever device its tensors are on."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def fma32(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded ONCE, as a fused multiply-add.

    The reference runs under XLA:CPU, whose LLVM backend contracts a
    float multiply feeding an add into one FMA instruction, so its cost
    expressions ``c + lam * bits`` round once; the CUDA kernels use
    ``__fmaf_rn`` for the same expressions.  Here the float32 product is
    exact in float64; the float64 sum rounds once more, which matters only
    when it lands exactly on a float32 rounding midpoint: then the sum's
    exact error (TwoSum) moves it one float64 ulp to the side the exact
    value lies on, and the final rounding to float32 is the fma's."""
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


def sample_dtype(bit_depth: int) -> torch.dtype:
    """The device dtype of a picture's samples: uint8 at 8 bits, int16
    above (0..1023 fit).  The host's planes are uint16 there, as the
    reference's; torch's CUDA build does not index or compute on uint16
    tensors, so the device holds the same values as int16."""
    return torch.uint8 if bit_depth == 8 else torch.int16


def to_device(a, device) -> torch.Tensor:
    """A numpy array on ``device``; uint16 samples as int16 (the same
    values: samples stay below 2^15)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    return torch.as_tensor(a, device=device)


def to_host_samples(t: torch.Tensor) -> np.ndarray:
    """Device samples as a host plane: int16 back to uint16."""
    a = t.cpu().numpy()
    return a.view(np.uint16) if a.dtype == np.int16 else a


def f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)
