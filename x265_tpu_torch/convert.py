"""Carry the reference's state across to the port.

* ``port_tables()``: the constant tables the port computes with (numpy),
  under the names ``tables_to_torch`` takes.  The same names built from
  ``x265_tpu``'s own arrays must give equal tensors (the CPU tests hold
  them so).
* ``tables_to_torch(np_tables, device)``: numpy tables -> tensors.
* ``planes_to_torch(planes, device)``: numpy planes (for example
  ``x265_tpu``'s ME-extended recon planes of a DPB entry) -> the port's
  DPB entry, so a P pipeline can start from the reference's references.
"""

from __future__ import annotations

import numpy as np
import torch

from ._util import to_device

TABLE_NAMES = ("dct4", "dct8", "dct16", "dct32", "dst4", "quant_scales",
               "inv_quant_scales", "diag4_rank", "luma_filters",
               "chroma_filters", "intra_angles", "intra_inv_angles",
               "mv_bits")


def port_tables() -> dict:
    """The port's constant tables as numpy arrays."""
    from .encoder.me_cuda import mv_bits_table
    from .ops import interp, intra, quantize, transforms

    inv = sorted(intra.INV_ANGLES.items())
    out = {f"dct{n}": transforms.dct_matrix(n) for n in (4, 8, 16, 32)}
    out.update(dst4=transforms.DST4,
               quant_scales=quantize.QUANT_SCALES,
               inv_quant_scales=quantize.INV_QUANT_SCALES,
               diag4_rank=quantize.DIAG4_RANK,
               luma_filters=interp.LUMA_FILTERS,
               chroma_filters=interp.CHROMA_FILTERS,
               intra_angles=intra.ANGLES,
               intra_inv_angles=np.array(inv, np.int32),
               mv_bits=mv_bits_table())
    return out


def tables_to_torch(np_tables: dict, device) -> dict:
    """{name: array} -> {name: contiguous tensor on ``device``}."""
    missing = set(TABLE_NAMES) - set(np_tables)
    if missing:
        raise KeyError(f"tables missing: {sorted(missing)}")
    return {k: torch.as_tensor(np.ascontiguousarray(np_tables[k])).to(
        device) for k in TABLE_NAMES}


def planes_to_torch(planes, device) -> tuple:
    """(Y, Cb, Cr) numpy planes -> a tuple of tensors on ``device`` with
    the same shape and dtype, uint16 samples as int16 (a DPB entry of the
    port)."""
    return tuple(to_device(np.asarray(p), device) for p in planes)
