"""Regenerate the float tables of x265_tpu_torch's RDOQ
(``ops/quantize.py`` ``_rdoq_core``), evaluated by XLA on the CPU with the
expressions of x265_tpu's ``_rdoq_core`` (x265_tpu/ops/quantize.py):

* ``data/rdoq_lambda_f32.npy`` [64, 2]: for every QP the scan can pass
  (0..63: 0..51 plus Main10's 12 of QpBdOffset), lambda2 =
  0.85 * 0.7 * 2^((qp - 12) / 3) and psy-RDOQ's lambda_sad =
  sqrt(lambda2 / (0.85 * 0.7));
* ``data/rdoq_rate_f32.npy`` [32768]: the rate term of a level l,
  3 + 2 * floor(log2(l)) for l > 0 and 0 for l = 0.

The port looks these values up instead of computing them: torch's float32
exp2 differs from XLA's at 42 of the 64 QPs, and XLA's log2(8192) rounds
below 13 (so the rate of level 8192 is 27, not 29), and RDOQ's level
choices compare these costs.

    JAX_PLATFORMS=cpu python tools/make_rdoq_tables.py
"""

import os

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    rate_scale = 0.7    # x265_tpu/ops/quantize.py _RDOQ_RATE_SCALE

    def lambdas(qp):
        # verbatim from x265_tpu/ops/quantize.py (_rdoq_core)
        lam2 = (0.85 * rate_scale
                * jnp.exp2((qp.astype(jnp.float32) - 12.0) / 3.0))
        lam_sad = jnp.sqrt(lam2 / (0.85 * rate_scale))
        return jnp.stack([lam2, lam_sad], 1)

    def rate(cands):
        lf = cands.astype(jnp.float32)
        return jnp.where(cands > 0,
                         3.0 + 2.0 * jnp.floor(
                             jnp.log2(jnp.maximum(lf, 1.0))), 0.0)

    data = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "x265_tpu_torch", "data")
    lam = np.asarray(jax.jit(lambdas)(jnp.arange(64, dtype=jnp.int32)),
                     np.float32)
    rt = np.asarray(jax.jit(rate)(jnp.arange(32768, dtype=jnp.int32)),
                    np.float32)
    np.save(os.path.join(data, "rdoq_lambda_f32.npy"), lam)
    np.save(os.path.join(data, "rdoq_rate_f32.npy"), rt)
    print(lam[:4], rt[8190:8194])


if __name__ == "__main__":
    main()
