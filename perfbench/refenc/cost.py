"""Distortion costs, SATD (4x4 Hadamard) and the psy-rd energy cost (8x8
Hadamard), in plain torch: a frozen copy of the encoder port's version,
for the reference steps.  Integer-exact: the Hadamard butterflies run on
int32 differences."""

from __future__ import annotations

import torch


def _had4(x: torch.Tensor, dim: int) -> torch.Tensor:
    """4-point Hadamard (ops/cost.H4 row order) along ``dim`` (size 4)."""
    x0, x1, x2, x3 = x.unbind(dim)
    s01, d01 = x0 + x1, x0 - x1
    s23, d23 = x2 + x3, x2 - x3
    return torch.stack([s01 + s23, d01 + d23, s01 - s23, d01 - d23], dim)


def _had8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """8-point Hadamard [[H4, H4], [H4, -H4]] along ``dim`` (size 8)."""
    a, b = x.split(4, dim)
    ha, hb = _had4(a, dim), _had4(b, dim)
    return torch.cat([ha + hb, ha - hb], dim)


def _tiles(x: torch.Tensor, t: int) -> torch.Tensor:
    """[..., H, W] -> [..., H/t, W/t, t, t]."""
    *lead, h, w = x.shape
    return x.reshape(*lead, h // t, t, w // t, t).transpose(-3, -2)


def satd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over 4x4 blocks of (sum |H d H^T| + 1) >> 1 (x265 convention);
    a, b [..., H, W] with H, W multiples of 4 -> [...] int32."""
    d = _tiles(a.to(torch.int32) - b.to(torch.int32), 4)
    had = _had4(_had4(d, -1), -2)
    per_blk = (had.abs().sum(dim=(-2, -1), dtype=torch.int32) + 1) >> 1
    return per_blk.sum(dim=(-2, -1), dtype=torch.int32)


def _psy_energy8(x: torch.Tensor) -> torch.Tensor:
    """[..., H, W] -> [..., H/8, W/8] AC Hadamard energy per 8x8 tile:
    sa8d(tile, 0) - (sad(tile, 0) >> 2)."""
    t = _tiles(x.to(torch.int32), 8)
    had = _had8(_had8(t, -1), -2)
    sa8d = (had.abs().sum(dim=(-2, -1), dtype=torch.int32) + 2) >> 2
    return sa8d - (t.sum(dim=(-2, -1), dtype=torch.int32) >> 2)


def psy_cost(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over 8x8 tiles of |AC_energy(a) - AC_energy(b)| -> [...] f32."""
    d = (_psy_energy8(a) - _psy_energy8(b)).abs()
    return d.sum(dim=(-2, -1), dtype=torch.int32).to(torch.float32)
