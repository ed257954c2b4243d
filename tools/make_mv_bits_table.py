"""Regenerate x265_tpu_torch/data/mv_bits_f32.npy: the mvd bits model of
x265_tpu's motion search (device_pipeline.py ``mv_bits``), evaluated by
XLA on the CPU for |d| = 0..1023 qpel.

The port looks these values up instead of calling log2: torch's and
XLA's float32 log2 differ by one ulp on about a quarter of the inputs,
and the motion-search argmins compare these costs.

    JAX_PLATFORMS=cpu python tools/make_mv_bits_table.py
"""

import os

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    def mv_bits(dq):
        # verbatim from x265_tpu/encoder/device_pipeline.py (me.mv_bits)
        a = jnp.abs(dq).astype(jnp.float32)
        return jnp.where(a == 0, 0.718, 2.0 * jnp.log2(a + 1.0) + 1.718)

    tab = np.asarray(jax.jit(mv_bits)(jnp.arange(1024, dtype=jnp.int32)),
                     np.float32)
    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "x265_tpu_torch", "data",
        "mv_bits_f32.npy")
    np.save(out, tab)
    print(out, tab[:4])


if __name__ == "__main__":
    main()
