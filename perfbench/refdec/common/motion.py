"""Motion vector prediction: the merge candidate list and the AMVP
derivation over two reference lists, with TMVP (ITU-T H.265 §8.5.3.1.7,
§8.5.3.2.2-9) — ``x265_tpu/common/motion.py``, copied line for line.

Scope: 2Nx2N PUs; TMVP when ``ps.temporal_mvp`` is set and the collocated
picture's motion field is attached as ``ps.col``.  Reference pictures are
identified by POC through the slice-level lists carried on ``PicSyntax``
(``ref_pocs_l0`` / ``ref_pocs_l1`` / ``cur_poc``); all references are
short-term.  The port's encoder derives the same candidates in its native
C serializer; the decoder calls this module.
"""

from __future__ import annotations

from dataclasses import dataclass


MODE_INTRA = 1  # must match cabac.ctu


@dataclass(frozen=True)
class MotionCand:
    """Full motion of a merge candidate: prediction direction (1 = L0,
    2 = L1, 3 = bi) + per-list MV and reference index."""
    dir: int
    mv0: tuple = (0, 0)
    ref0: int = 0
    mv1: tuple = (0, 0)
    ref1: int = 0

    def key(self):
        """Comparison key per §8.5.3.2.3 pruning (entire motion data)."""
        k = [self.dir]
        k += list(self.mv0) + [self.ref0] if self.dir & 1 else [0, 0, -1]
        k += list(self.mv1) + [self.ref1] if self.dir & 2 else [0, 0, -1]
        return tuple(k)


def _neighbor_motion(ps, xc, yc, xn, yn):
    """Full motion at a neighbor position, or None (z-scan availability +
    inter-coded requirement)."""
    g = ps.geom
    if xn < 0 or yn < 0 or not g.available(xc, yc, xn, yn):
        return None
    y4, x4 = yn >> 2, xn >> 2
    if ps.pred_mode[y4, x4] == MODE_INTRA:
        return None
    d = int(ps.inter_dir[y4, x4])
    if d == 0:
        d = 1          # legacy P-only state: mv0 valid, dir implicit L0
    return MotionCand(
        d,
        (int(ps.mv0[y4, x4, 0]), int(ps.mv0[y4, x4, 1])),
        int(ps.ref_idx0[y4, x4]),
        (int(ps.mv1[y4, x4, 0]), int(ps.mv1[y4, x4, 1])),
        int(ps.ref_idx1[y4, x4]))


def _col_motion_at(ps, xc, yc):
    """Collocated motion sample at luma (xc, yc) (16x16 granularity,
    §8.5.3.2.9 inputs).  Returns None when outside the picture / intra /
    no collocated data."""
    col = getattr(ps, "col", None)
    if col is None:
        return None
    if xc >= ps.geom.width or yc >= ps.geom.height:
        return None
    y4, x4 = (yc & ~15) >> 2, (xc & ~15) >> 2
    if col["pred_mode"][y4, x4] == MODE_INTRA:
        return None
    d = int(col["inter_dir"][y4, x4])
    if d == 0:
        d = 1
    return (d,
            (int(col["mv0"][y4, x4, 0]), int(col["mv0"][y4, x4, 1])),
            int(col["poc0"][y4, x4]),
            (int(col["mv1"][y4, x4, 0]), int(col["mv1"][y4, x4, 1])),
            int(col["poc1"][y4, x4]))


def _col_mv_for_list(ps, colm, lx: int, ref_idx: int):
    """§8.5.3.2.9 collocated MV for target list ``lx``/``ref_idx``:
    pick the col block's list, then POC-scale.  colm from _col_motion_at.
    All references here are short-term."""
    d, mv0, poc0, mv1, poc1 = colm
    col_poc = ps.col["poc"]
    if d == 2:                       # col uses only L1
        mv_col, ref_poc_col = mv1, poc1
    elif d == 1:                     # only L0
        mv_col, ref_poc_col = mv0, poc0
    else:                            # bi: depends on backward refs
        all_before = all(p <= ps.cur_poc for p in ps.ref_pocs_l0) and \
            all(p <= ps.cur_poc for p in ps.ref_pocs_l1)
        n = lx if all_before else 0  # collocated_from_l0 == 1
        mv_col, ref_poc_col = (mv0, poc0) if n == 0 else (mv1, poc1)
    target_poc = (ps.ref_pocs_l0, ps.ref_pocs_l1)[lx][ref_idx]
    col_dist = col_poc - ref_poc_col
    cur_dist = ps.cur_poc - target_poc
    if col_dist == cur_dist:
        return mv_col
    return _scale_mv(mv_col, cur_dist, col_dist)


def temporal_mv(ps, x0: int, y0: int, w: int, h: int, lx: int,
                ref_idx: int):
    """§8.5.3.1.7 temporal luma MV prediction: bottom-right position
    (same CTB row only), falling back to the PU center."""
    if not getattr(ps, "temporal_mvp", False) or \
            getattr(ps, "col", None) is None:
        return None
    log2ctb = ps.geom.log2_ctb
    ybr, xbr = y0 + h, x0 + w
    colm = None
    if (y0 >> log2ctb) == (ybr >> log2ctb):
        colm = _col_motion_at(ps, xbr, ybr)
    if colm is None:
        colm = _col_motion_at(ps, x0 + (w >> 1), y0 + (h >> 1))
    if colm is None:
        return None
    return _col_mv_for_list(ps, colm, lx, ref_idx)


def _temporal_merge_cand(ps, x0, y0, w, h):
    """Temporal merge candidate (refIdx 0 per used list) or None."""
    is_b = len(ps.ref_pocs_l1) > 0
    mv0 = temporal_mv(ps, x0, y0, w, h, 0, 0)
    mv1 = temporal_mv(ps, x0, y0, w, h, 1, 0) if is_b else None
    if mv0 is None and mv1 is None:
        return None
    d = (1 if mv0 is not None else 0) | (2 if mv1 is not None else 0)
    return MotionCand(d, mv0 or (0, 0), 0, mv1 or (0, 0), 0)


def merge_candidates(ps, x0: int, y0: int, w: int, h: int,
                     max_cand: int = 5) -> list[MotionCand]:
    """Merge list for a 2Nx2N PU: spatial A1 B1 B0 A0 (B2) + temporal
    (TMVP) + combined bi (B slices) + zero fill.  §8.5.3.2.3-5."""
    a1 = _neighbor_motion(ps, x0, y0, x0 - 1, y0 + h - 1)
    b1 = _neighbor_motion(ps, x0, y0, x0 + w - 1, y0 - 1)
    b0 = _neighbor_motion(ps, x0, y0, x0 + w, y0 - 1)
    a0 = _neighbor_motion(ps, x0, y0, x0 - 1, y0 + h)
    cands = []
    if a1 is not None:
        cands.append(a1)
    if b1 is not None and (a1 is None or b1.key() != a1.key()):
        cands.append(b1)
    if b0 is not None and (b1 is None or b0.key() != b1.key()):
        cands.append(b0)
    if a0 is not None and (a1 is None or a0.key() != a1.key()):
        cands.append(a0)
    if len(cands) < 4:
        b2 = _neighbor_motion(ps, x0, y0, x0 - 1, y0 - 1)
        if b2 is not None and (a1 is None or b2.key() != a1.key()) \
                and (b1 is None or b2.key() != b1.key()):
            cands.append(b2)
    cands = cands[:max_cand]
    if len(cands) < max_cand:
        t = _temporal_merge_cand(ps, x0, y0, w, h)
        if t is not None:
            cands.append(t)      # §8.5.3.2.1: temporal is never pruned

    is_b = len(ps.ref_pocs_l1) > 0
    if is_b and 1 < len(cands) < max_cand:
        # §8.5.3.2.4 combined bi-predictive candidates
        L0IDX = (0, 1, 0, 2, 1, 2, 0, 3, 1, 3, 2, 3)
        L1IDX = (1, 0, 2, 0, 2, 1, 3, 0, 3, 1, 3, 2)
        n_orig = len(cands)
        for comb in range(n_orig * (n_orig - 1)):
            c0, c1 = cands[L0IDX[comb]], cands[L1IDX[comb]]
            if not (c0.dir & 1 and c1.dir & 2):
                continue
            ref_poc0 = ps.ref_pocs_l0[c0.ref0]
            ref_poc1 = ps.ref_pocs_l1[c1.ref1]
            if ref_poc0 == ref_poc1 and c0.mv0 == c1.mv1:
                continue
            cands.append(MotionCand(3, c0.mv0, c0.ref0, c1.mv1, c1.ref1))
            if len(cands) == max_cand:
                break

    # §8.5.3.2.5 zero candidates
    num_refs = (min(len(ps.ref_pocs_l0), len(ps.ref_pocs_l1)) if is_b
                else len(ps.ref_pocs_l0))
    zero_idx = 0
    while len(cands) < max_cand:
        r = zero_idx if zero_idx < num_refs else 0
        cands.append(MotionCand(3 if is_b else 1, (0, 0), r, (0, 0), r))
        zero_idx += 1
    return cands


def _scale_mv(mv, tb: int, td: int):
    """Spatial/temporal MV scaling (§8.5.3.2.8 math)."""
    if td == tb:
        return mv
    tb = max(-128, min(127, tb))
    td = max(-128, min(127, td))
    tx = (16384 + (abs(td) >> 1)) // td if td > 0 else \
        -((16384 + (abs(td) >> 1)) // -td)
    dsf = max(-4096, min(4095, (tb * tx + 32) >> 6))
    out = []
    for c in mv:
        v = dsf * c
        out.append(max(-32768, min(32767,
                                   (abs(v) + 127 >> 8) * (1 if v >= 0 else -1))))
    return (out[0], out[1])


def _amvp_from(ps, cand: MotionCand, lx: int, ref_idx: int, scaled: bool):
    """Try to take list-lx AMVP from a neighbor's motion (§8.5.3.2.7):
    first the same list, then the other, requiring an identical reference
    picture unless ``scaled``."""
    target_poc = (ps.ref_pocs_l0, ps.ref_pocs_l1)[lx][ref_idx]
    for ly in (lx, 1 - lx):
        if not cand.dir & (1 << ly):
            continue
        mv = cand.mv0 if ly == 0 else cand.mv1
        ref = cand.ref0 if ly == 0 else cand.ref1
        pocs = (ps.ref_pocs_l0, ps.ref_pocs_l1)[ly]
        nb_poc = pocs[ref] if ref < len(pocs) else pocs[0]
        if nb_poc == target_poc:
            return mv
        if scaled:
            return _scale_mv(mv, ps.cur_poc - target_poc,
                             ps.cur_poc - nb_poc)
    return None


def amvp_candidates(ps, x0: int, y0: int, w: int, h: int,
                    lx: int = 0, ref_idx: int = 0) -> list[tuple[int, int]]:
    """AMVP predictor pair [mvp0, mvp1] for list ``lx`` (§8.5.3.2.6-7,
    TMVP off)."""
    a0 = _neighbor_motion(ps, x0, y0, x0 - 1, y0 + h)
    a1 = _neighbor_motion(ps, x0, y0, x0 - 1, y0 + h - 1)
    is_scaled = a0 is not None or a1 is not None

    mv_a = None
    for c in (a0, a1):
        if c is not None and mv_a is None:
            mv_a = _amvp_from(ps, c, lx, ref_idx, scaled=False)
    if mv_a is None:
        for c in (a0, a1):
            if c is not None and mv_a is None:
                mv_a = _amvp_from(ps, c, lx, ref_idx, scaled=True)

    bs = (_neighbor_motion(ps, x0, y0, x0 + w, y0 - 1),
          _neighbor_motion(ps, x0, y0, x0 + w - 1, y0 - 1),
          _neighbor_motion(ps, x0, y0, x0 - 1, y0 - 1))
    mv_b = None
    for c in bs:
        if c is not None and mv_b is None:
            mv_b = _amvp_from(ps, c, lx, ref_idx, scaled=False)
    if not is_scaled:
        # §8.5.3.2.7: with no A neighbors, the unscaled B moves to the A
        # slot and the B slot re-derives with scaling
        if mv_a is None and mv_b is not None:
            mv_a, mv_b = mv_b, None
        if mv_b is None:
            for c in bs:
                if c is not None and mv_b is None:
                    mv_b = _amvp_from(ps, c, lx, ref_idx, scaled=True)

    cands = []
    if mv_a is not None:
        cands.append(mv_a)
    if mv_b is not None and mv_b != mv_a:
        cands.append(mv_b)
    if len(cands) < 2:
        # §8.5.3.2.6: the temporal candidate is not pruned against the
        # spatial ones
        t = temporal_mv(ps, x0, y0, w, h, lx, ref_idx)
        if t is not None:
            cands.append(t)
    while len(cands) < 2:
        cands.append((0, 0))
    return cands[:2]

