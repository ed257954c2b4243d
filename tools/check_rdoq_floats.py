"""Which float steps of x265_tpu's RDOQ (``x265_tpu/ops/quantize.py``
``_rdoq_core``) XLA:CPU rounds how: the intermediate values of a jitted
copy of its expressions against the port's twins, contracted (one
rounding, ``_util.fma32``) and not.

For 300 random blocks per case (n = 8, 16, 32; bit depths 8 and 10;
psy-RDOQ 0 and 1; a QP per block) it prints how many values differ:
the error ``|c| - level * step``, the candidate cost ``dist + lambda2 *
rate``, the psy bonus ``j - psy * lambda_sad * amplitude``, the prefix
sums (the port's blocked order and a sequential ``torch.cumsum``), the
last-position cost ``cost + lambda2 * last_bits`` and the (y, x)-order
group sums.  The port uses whichever variant prints 0.

    JAX_PLATFORMS=cpu python tools/check_rdoq_floats.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _reference_intermediates(jnp, coef, qp, bit_depth, psy_scale):
    """x265_tpu's ``_rdoq_core`` up to the group sums (its expressions,
    verbatim), returning the intermediates."""
    from x265_tpu.ops.quantize import (INV_QUANT_SCALES, QUANT_SCALES,
                                       QUANT_SHIFT, _scan_tables)
    n = coef.shape[-1]
    log2n = n.bit_length() - 1
    ts = 15 - bit_depth - log2n
    qbits = QUANT_SHIFT + qp // 6 + ts
    scale = jnp.asarray(QUANT_SCALES, jnp.int32)[qp % 6]
    scale_eff = ((jnp.asarray(INV_QUANT_SCALES, jnp.int32)[qp % 6] * 16)
                 << (qp // 6))
    bd_shift = bit_depth + log2n - 5
    lam2 = 0.85 * 0.7 * jnp.exp2((qp.astype(jnp.float32) - 12.0) / 3.0)
    lam2b = lam2[:, None]
    scale, qbits, scale_eff, lam2 = (v[:, None, None] for v in
                                     (scale, qbits, scale_eff, lam2))
    absc = jnp.abs(coef)
    hi = absc * (scale >> 7)
    lo = absc * (scale & 127)
    offset = jnp.int32(1) << (qbits - 1)
    lmax = jnp.clip((hi + ((lo + offset) >> 7)) >> (qbits - 7), 0, 32767)
    cands = jnp.stack([jnp.zeros_like(lmax), jnp.maximum(lmax - 1, 0), lmax])
    dqf = cands.astype(jnp.float32) * (scale_eff.astype(jnp.float32)
                                       / float(2 ** bd_shift))
    err = absc.astype(jnp.float32) - dqf
    dist = err * err * float(2.0 ** (-2 * ts))
    lf = cands.astype(jnp.float32)
    rate = jnp.where(cands > 0, 3.0 + 2.0 * jnp.floor(
        jnp.log2(jnp.maximum(lf, 1.0))), 0.0)
    j0 = dist + lam2 * rate
    j = j0
    if psy_scale > 0.0:
        lam_sad = jnp.sqrt(lam2 / (0.85 * 0.7))
        ac = jnp.ones((n, n), bool).at[0, 0].set(False)
        j = j - (psy_scale * lam_sad) * (dqf * float(2.0 ** (-ts))) * ac[
            None, None]
    jbest = jnp.min(j, axis=0)
    b = coef.shape[0]
    rank_tab, lb_tab = _scan_tables(n)
    perm = jnp.asarray(np.argsort(rank_tab.ravel(), kind="stable"))
    js = jbest.reshape(b, n * n)[:, perm]
    d0s = dist[0].reshape(b, n * n)[:, perm]
    cum_j = jnp.cumsum(js, axis=1)
    cum_d0 = jnp.cumsum(d0s, axis=1)
    cost_p = (cum_j + (cum_d0[:, -1:] - cum_d0)
              + lam2b * jnp.asarray(lb_tab))
    g = n // 4
    return dict(cands=cands, dqf=dqf, err=err, dist=dist, rate=rate, j0=j0,
                j=j, js=js, cum_j=cum_j, cum_d0=cum_d0, cost_p=cost_p,
                sum_j=jbest.reshape(b, g, 4, g, 4).sum(axis=(2, 4)),
                lam2=lam2, lam2b=lam2b)


def main():
    import jax
    import jax.numpy as jnp
    import torch

    from x265_tpu.ops.transforms import forward_transform
    from x265_tpu_torch._util import fma32
    from x265_tpu_torch.ops import quantize as q

    rng = np.random.RandomState(1)
    print("n bd psy: err plain/fma, j plain/fma, psy plain/fma, "
          "cumsum blocked/sequential, cost plain/fma, group sums")
    for n in (8, 16, 32):
        for bd in (8, 10):
            for psy in (0.0, 1.0):
                hi = (1 << bd) - 1
                x = np.clip(rng.normal(0, 30 << (bd - 8), (300, n, n)), -hi,
                            hi).astype(np.int32)
                coef = np.asarray(forward_transform(jnp.asarray(x), bd,
                                                    dst=False))
                qp = rng.randint(0, 52 + 6 * (bd - 8), 300).astype(np.int32)
                r = {k: torch.as_tensor(np.array(v)) for k, v in jax.jit(
                    lambda c, p: _reference_intermediates(
                        jnp, c, p, bd, psy))(jnp.asarray(coef),
                                             jnp.asarray(qp)).items()}
                ts = 15 - bd - (n.bit_length() - 1)
                absc = torch.as_tensor(np.abs(coef)).float()
                step = r["dqf"][2] / r["cands"][2].float().clamp(min=1)
                row = []

                def diff(a, b):
                    return int((a != b).sum())

                row.append(diff(absc - r["dqf"], r["err"]))
                row.append(diff(fma32(-r["cands"].float(), step, absc),
                                r["err"]))
                lam2 = r["lam2"]
                row.append(diff(r["dist"] + lam2 * r["rate"], r["j0"]))
                row.append(diff(fma32(lam2, r["rate"], r["dist"]), r["j0"]))
                if psy:
                    lsad = torch.as_tensor(q.rdoq_lambda_table()[qp][:, 1])[
                        :, None, None]
                    ac = torch.ones((n, n))
                    ac[0, 0] = 0.0
                    amp = r["dqf"] * np.float32(2.0 ** -ts)
                    row.append(diff(r["j0"] - (np.float32(psy) * lsad) * amp
                                    * ac, r["j"]))
                    row.append(diff(fma32(-(np.float32(psy) * lsad),
                                          amp * ac, r["j0"]), r["j"]))
                else:
                    row += ["-", "-"]
                row.append(diff(q._xla_cumsum(r["js"]), r["cum_j"]))
                row.append(diff(torch.cumsum(r["js"], 1), r["cum_j"]))
                lb = torch.as_tensor(q._scan_tables(n)[1])
                tail = r["cum_j"] + (r["cum_d0"][:, -1:] - r["cum_d0"])
                row.append(diff(tail + r["lam2b"] * lb, r["cost_p"]))
                row.append(diff(fma32(r["lam2b"], lb, tail), r["cost_p"]))
                row.append(diff(q._group_sums(r["j"].amin(0)), r["sum_j"]))
                print(n, bd, psy, row, flush=True)


if __name__ == "__main__":
    main()
