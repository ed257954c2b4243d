"""Per-lane intra helpers of the CTU wavefront — torch twins of
``x265_tpu.encoder.wavefront._substitute`` and ``_predict_lanes``."""

from __future__ import annotations

from ..ops.intra import predict_modes, substitute_references


def _substitute(samples, avail, bit_depth):
    """§8.4.4.2.2 substitution for [lanes, R] reference vectors."""
    return substitute_references(samples, avail, bit_depth)


def _predict_lanes(refs, modes, n, is_luma, bit_depth):
    """One intra mode per lane: refs [Lx, 4n+1] substituted, modes [Lx]
    -> pred [Lx, n, n] int32 (luma filters and edge post-filters as the
    spec and ``_predict_lanes`` apply them)."""
    return predict_modes(refs, modes, n, is_luma, bit_depth)
