"""Quantization / dequantization (H.265 §8.6.3), sign-data hiding and
RDOQ in plain torch (flat scaling lists, int32 math, RDOQ's float costs
in the encoder's float order): a frozen copy of the encoder port's
version, for the reference CTU step."""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ._util import dev_table, fma32

INV_QUANT_SCALES = np.array([40, 45, 51, 57, 64, 72], dtype=np.int32)
QUANT_SCALES = np.array([26214, 23302, 20560, 18396, 16384, 14564],
                        dtype=np.int32)
QUANT_SHIFT = 14


def _diag4_rank() -> np.ndarray:
    """rank[y, x] = position of (x, y) in the 4x4 up-right diagonal scan."""
    rank = np.zeros((4, 4), np.int32)
    i = 0
    for s in range(7):
        for x in range(s + 1):
            y = s - x
            if x < 4 and y < 4:
                rank[y, x] = i
                i += 1
    return rank


DIAG4_RANK = _diag4_rank()


def _per_block(v, qp):
    return v[:, None, None] if qp.ndim else v


def quant_masked(coef: torch.Tensor, qp, intra_mask: torch.Tensor,
                 bit_depth: int = 8) -> torch.Tensor:
    """[B, N, N] int32 coefficients -> levels; qp scalar or [B];
    intra_mask [B] bool selects the rounding offset (171 intra, 85 inter)."""
    n = coef.shape[-1]
    log2n = n.bit_length() - 1
    dev = coef.device
    qp = torch.as_tensor(qp, dtype=torch.int32, device=dev)
    qbits = QUANT_SHIFT + qp // 6 + (15 - bit_depth - log2n)
    scale = dev_table("qs", lambda: QUANT_SCALES, dev)[qp % 6]
    scale, qbits = _per_block(scale, qp), _per_block(qbits, qp)
    offset_num = torch.where(intra_mask, 171, 85).to(torch.int32)[:, None,
                                                                  None]
    absc = coef.abs()
    hi = absc * (scale >> 7)
    lo = absc * (scale & 127)
    offset = offset_num << (qbits - 9)
    level = ((hi + ((lo + offset) >> 7)) >> (qbits - 7)).clamp(0, 32767)
    return torch.sign(coef) * level


def dequant(level: torch.Tensor, qp, bit_depth: int = 8) -> torch.Tensor:
    """Normative dequant, batched.  [B, N, N] levels, qp scalar or [B]."""
    n = level.shape[-1]
    log2n = n.bit_length() - 1
    dev = level.device
    qp = torch.as_tensor(qp, dtype=torch.int32, device=dev)
    bd_shift = bit_depth + log2n - 5
    scale16 = dev_table("iqs", lambda: INV_QUANT_SCALES, dev)[qp % 6] * 16
    scale16, per = _per_block(scale16, qp), _per_block(qp // 6, qp)
    scale_eff = scale16 << per
    # pre-clamp as the reference does (int32-safe, identical after clip)
    lmax = (32767 << bd_shift) // scale_eff + 1
    lvl = torch.maximum(torch.minimum(level, lmax), -lmax)
    d = (lvl * scale_eff + (1 << (bd_shift - 1))) >> bd_shift
    return d.clamp(-32768, 32767)


def sign_hide_diag(levels: torch.Tensor) -> torch.Tensor:
    """Sign-hiding parity fix for diagonal-scan TBs: levels [B, n, n]."""
    b, n, _ = levels.shape
    s = n // 4
    rank = dev_table("rank4", lambda: DIAG4_RANK, levels.device)
    sb = levels.reshape(b, s, 4, s, 4).permute(0, 1, 3, 2, 4)
    nz = sb != 0
    ranks = torch.where(nz, rank, 99)
    first = ranks.amin(dim=(-2, -1))
    last = torch.where(nz, rank, -1).amax(dim=(-2, -1))
    hide = (last - first) > 3
    first_mask = (rank == first[..., None, None]) & nz
    val = torch.where(first_mask, sb, 0).sum(dim=(-2, -1))
    odd = (sb.abs().sum(dim=(-2, -1)) & 1) == 1
    mismatch = hide & (odd != (val < 0))
    bump = torch.where(val > 0, 1, -1)
    sb = torch.where(first_mask & mismatch[..., None, None],
                     sb + bump[..., None, None], sb)
    return sb.permute(0, 1, 3, 2, 4).reshape(b, n, n).to(levels.dtype)


# ---------------------------------------------------------------------------
# RDOQ: the reference's batched re-design of x265's rdoQuant (candidate
# levels {0, L-1, L} by J = D + lambda2 * R, the last-position pass over
# the scan order, then group zeroing).  Its float decisions are held equal
# to XLA:CPU's: lambda2, lambda_sad and the rate term come from tables of
# XLA's own values (tools/make_rdoq_tables.py), the prefix sums run in
# XLA's order (``_xla_cumsum``), the 4x4 group sums in (y, x) order, the
# argmins take the first minimum, and ``dist + lambda2 * rate`` and
# ``cost + lambda2 * last_bits`` round once, as XLA:CPU contracts them
# (not the psy bonus; the error ``|c| - level * step`` is exact either
# way).  ``tools/check_rdoq_floats.py`` shows which way each step rounds.
# ---------------------------------------------------------------------------

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
#: QPs the lambda table covers (0..51 plus Main10's 12 of QpBdOffset)
RDOQ_MAX_QP = 63
RDOQ_MAX_LEVEL = 32767


def rdoq_lambda_table() -> np.ndarray:
    """[64, 2] float32: lambda2 and lambda_sad of each QP, XLA's values."""
    return np.load(os.path.join(_DATA, "rdoq_lambda_f32.npy"))


def rdoq_rate_table() -> np.ndarray:
    """[32768] float32: the rate term of each level, XLA's values."""
    return np.load(os.path.join(_DATA, "rdoq_rate_f32.npy"))


@functools.lru_cache(maxsize=8)
def _scan_tables(n: int):
    """(rank [n, n], last_bits [n*n]) for the up-right diagonal scan with
    4x4 coefficient-group structure (§6.5.3): rank 0 = DC, increasing
    toward high frequency; last_bits[p] estimates the
    last_sig_coeff_x/y_prefix+suffix cost of scan position p."""
    def diag_rank(m):
        rank = np.zeros((m, m), np.int32)
        i = 0
        for s in range(2 * m - 1):
            for x in range(s + 1):
                y = s - x
                if x < m and y < m:
                    rank[y, x] = i
                    i += 1
        return rank

    if n == 4:
        rank = diag_rank(4)
    else:
        g = n // 4
        grp = diag_rank(g)
        rank = (np.kron(grp, np.ones((4, 4), np.int32)) * 16
                + np.tile(diag_rank(4), (g, g)))
    ys, xs = np.divmod(np.argsort(rank.ravel(), kind="stable"), n)
    lb = (2.0 * np.floor(np.log2(xs + 1.0)) + 1.0
          + 2.0 * np.floor(np.log2(ys + 1.0)) + 1.0).astype(np.float32)
    return rank, lb


def _seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Prefix sums along the last axis, added left to right."""
    acc = x[..., 0]
    out = [acc]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
        out.append(acc)
    return torch.stack(out, -1)


def _xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """float32 prefix sums of x [B, m] in the order XLA:CPU computes
    ``jnp.cumsum`` (its reduce-window rewrite, blocked by 16): sequential
    sums inside each run of 16, the same blocked scan over the runs'
    totals, then each run's sums plus the total before it."""
    b, m = x.shape
    if m <= 16:
        return _seq_cumsum(x)
    assert m % 16 == 0
    inner = _seq_cumsum(x.reshape(b, m // 16, 16))
    carry = _xla_cumsum(inner[:, :, 15])
    return torch.cat([inner[:, :1], carry[:, :-1, None] + inner[:, 1:]],
                     1).reshape(b, m)


def _group_sums(x: torch.Tensor) -> torch.Tensor:
    """Sums of the 4x4 groups of x [B, n, n] in (y, x) order: [B, g, g]."""
    b, n, _ = x.shape
    g = n // 4
    xg = x.reshape(b, g, 4, g, 4)
    acc = xg[:, :, 0, :, 0]
    for k in range(1, 16):
        acc = acc + xg[:, :, k // 4, :, k % 4]
    return acc


def _first_argmin(x: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum along the last axis (x has no NaN)."""
    m = x.shape[-1]
    idx = torch.arange(m, device=x.device)
    hit = x == x.amin(-1, keepdim=True)
    return torch.where(hit, idx, m).amin(-1)


def _rdoq_core(coef: torch.Tensor, qp, bit_depth: int,
               psy_scale: float = 0.0) -> torch.Tensor:
    """RDO levels of [B, n, n] int32 coefficients at qp (scalar or [B]);
    with ``psy_scale`` > 0 the psy-RDOQ bonus on the AC positions."""
    n = coef.shape[-1]
    b = coef.shape[0]
    log2n = n.bit_length() - 1
    dev = coef.device
    qp = torch.as_tensor(qp, dtype=torch.int32, device=dev)
    assert int(qp.min()) >= 0 and int(qp.max()) <= RDOQ_MAX_QP, \
        "RDOQ's lambda table covers QPs 0..63"
    ts = 15 - bit_depth - log2n
    qbits = QUANT_SHIFT + qp // 6 + ts
    scale = dev_table("qs", lambda: QUANT_SCALES, dev)[qp % 6]
    scale_eff = ((dev_table("iqs", lambda: INV_QUANT_SCALES, dev)[qp % 6]
                  * 16) << (qp // 6))
    bd_shift = bit_depth + log2n - 5
    lam_tab = dev_table("rdoq_lam", rdoq_lambda_table, dev)[qp.long()]
    lam2, lam_sad = lam_tab[..., 0], lam_tab[..., 1]
    lam2b = lam2.reshape(-1, 1).expand(b, 1)       # [B, 1] scan axes
    scale, qbits, scale_eff, lam2, lam_sad = (
        _per_block(v, qp) for v in (scale, qbits, scale_eff, lam2, lam_sad))
    absc = coef.abs()
    hi = absc * (scale >> 7)
    lo = absc * (scale & 127)
    offset = torch.ones_like(qbits) << (qbits - 1)
    lmax = ((hi + ((lo + offset) >> 7)) >> (qbits - 7)).clamp(0, 32767)
    cands = torch.stack([torch.zeros_like(lmax),
                         (lmax - 1).clamp(min=0), lmax])     # [3, B, n, n]
    rate_tab = dev_table("rdoq_rate", rdoq_rate_table, dev)
    assert int(cands.max()) <= RDOQ_MAX_LEVEL
    step = scale_eff.to(torch.float32) * np.float32(2.0 ** -bd_shift)
    dqf = cands.to(torch.float32) * step
    err = absc.to(torch.float32) - dqf
    dist = err * err * np.float32(2.0 ** (-2 * ts))          # pixel domain
    j = fma32(lam2, rate_tab[cands.long()], dist)
    if psy_scale > 0.0:
        ac = torch.ones((n, n), dtype=torch.float32, device=dev)
        ac[0, 0] = 0.0
        bonus = (np.float32(psy_scale) * lam_sad) * (
            dqf * np.float32(2.0 ** (-ts)))
        j = j - bonus * ac                           # not contracted
    best = torch.where(j[1] < j[0], 1, 0)
    jmin = torch.minimum(j[0], j[1])
    best = torch.where(j[2] < jmin, 2, best)
    jbest = torch.minimum(jmin, j[2])
    level = torch.gather(cands, 0, best[None])[0]

    # last-position pass over the scan order
    rank_tab, lb_tab = _scan_tables(n)
    perm = torch.as_tensor(np.argsort(rank_tab.ravel(), kind="stable"),
                           device=dev)
    n2 = n * n
    js = jbest.reshape(b, n2)[:, perm]
    d0s = dist[0].reshape(b, n2)[:, perm]
    lvs = level.reshape(b, n2)[:, perm]
    cum_j = _xla_cumsum(js)
    cum_d0 = _xla_cumsum(d0s)
    tot_d0 = cum_d0[:, -1:]
    cost_p = fma32(lam2b, torch.as_tensor(lb_tab, device=dev),
                   cum_j + (tot_d0 - cum_d0))
    cost_p = torch.where(lvs != 0, cost_p, float("inf"))
    cost_all0 = tot_d0[:, 0] - lam2b[:, 0] * 2.0
    p_best = _first_argmin(cost_p)
    min_cost = cost_p.amin(1)
    keep_any = min_cost <= cost_all0
    rank_j = torch.as_tensor(rank_tab, device=dev)
    keep = (rank_j[None] <= p_best[:, None, None]) & keep_any[:, None, None]
    level = torch.where(keep, level, 0)

    # group zeroing, never the group of the last position
    g = n // 4
    sum_j = _group_sums(jbest)
    sum_d0 = _group_sums(dist[0])
    lvl_g = level.reshape(b, g, 4, g, 4)
    nzg = (lvl_g != 0).any(4).any(2)
    zero_grp = nzg & (sum_d0 < sum_j + lam2.reshape(-1, 1, 1) * 2.0)
    sy, sx = np.divmod(np.argsort(rank_tab.ravel(), kind="stable"), n)
    lgy = torch.as_tensor(sy // 4, device=dev)[p_best]
    lgx = torch.as_tensor(sx // 4, device=dev)[p_best]
    ar = torch.arange(g, device=dev)
    is_last = ((ar[None, :, None] == lgy[:, None, None])
               & (ar[None, None, :] == lgx[:, None, None]))
    zero_grp = zero_grp & ~is_last
    level = torch.where(zero_grp[:, :, None, :, None], 0,
                        lvl_g).reshape(b, n, n)
    return torch.sign(coef) * level


# ---------------------------------------------------------------------------
# numpy reference: the decoder's host recon
# ---------------------------------------------------------------------------
