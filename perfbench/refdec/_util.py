"""The constant tables of the loop filters, cached per device."""

from __future__ import annotations

import threading

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

