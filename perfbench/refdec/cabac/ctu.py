"""Per-picture syntax state of the CABAC layer and the CTU syntax's decode
direction — the ``PicSyntax`` arrays, the prediction-mode constants, the
chroma QP and chroma mode mappings and, as ``CtuDecoder``, the decode
methods of the reference's ``CtuCoder``, copied from
``x265_tpu/cabac/ctu.py`` (ITU-T H.265 §7.3.8, §8.4.2-3, §8.6.1,
§9.3.4.2).

The port entropy-codes a slice with the native C serializer
(``x265_tpu_torch.native``), which reads these arrays; the reference's
Python CTU encoder is not carried.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..common.geometry import PictureGeometry
from .engine import CabacDecoder
from .syntax import SCAN_DIAG, decode_residual, scan_for_intra
from .tables import CTX_OFFSET

MODE_INTRA, MODE_INTER, MODE_SKIP = 1, 0, 2
PLANAR, DC, HOR, VER = 0, 1, 10, 26

# §8.6.1 Table 8-10: chroma QP mapping for 4:2:0
_CHROMA_QP_MAP = np.array(
    [29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37], dtype=np.int32)


def chroma_qp(qp_y: int, qp_offset: int = 0, chroma_format: int = 1) -> int:
    qpi = max(-12, min(57, qp_y + qp_offset))
    if chroma_format != 1:
        return min(qpi, 51)
    if qpi < 30:
        return max(0, qpi)
    if qpi > 43:
        return qpi - 6
    return int(_CHROMA_QP_MAP[qpi - 30])


@dataclass
class PicSyntax:
    """Per-picture syntax state at 4x4 granularity + coefficient planes.

    All block coordinates are in luma samples; index arrays use (y4, x4) =
    (y >> 2, x >> 2).  Arrays cover the *coded* (CTB-padded) picture size.
    """
    geom: PictureGeometry
    max_tr_depth_intra: int = 0
    sign_hiding: bool = False
    depth: np.ndarray = field(default=None)        # CU depth
    part: np.ndarray = field(default=None)         # 0 = 2Nx2N, 1 = NxN
    pred_mode: np.ndarray = field(default=None)    # MODE_INTRA / MODE_INTER
    luma_mode: np.ndarray = field(default=None)    # 0..34 per 4x4
    chroma_mode: np.ndarray = field(default=None)  # derived chroma mode
    tu_depth: np.ndarray = field(default=None)     # transform depth rel. CU
    coeff_y: np.ndarray = field(default=None)      # [H, W] int32
    coeff_cb: np.ndarray = field(default=None)     # [H/2, W/2]
    coeff_cr: np.ndarray = field(default=None)

    # SAO per-CTB params (§8.7.3): plane idx 0=Y, 1=Cb, 2=Cr; type/class
    # are shared between Cb and Cr per the syntax
    sao_type: np.ndarray = field(default=None)     # [n_ctb, 2] 0/1/2 (Y, C)
    sao_eo_class: np.ndarray = field(default=None)  # [n_ctb, 2]
    sao_band_pos: np.ndarray = field(default=None)  # [n_ctb, 3]
    sao_offsets: np.ndarray = field(default=None)   # [n_ctb, 3, 4] signed

    # inter fields (P/B slices): per-4x4 motion + decision state
    mv0: np.ndarray = field(default=None)          # [h4, w4, 2] int16 qpel
    mv1: np.ndarray = field(default=None)          # [h4, w4, 2] (L1)
    inter_dir: np.ndarray = field(default=None)    # 1=L0, 2=L1, 3=bi
    ref_idx0: np.ndarray = field(default=None)
    ref_idx1: np.ndarray = field(default=None)
    skip: np.ndarray = field(default=None)         # cu_skip_flag
    merge_flag: np.ndarray = field(default=None)
    merge_idx: np.ndarray = field(default=None)
    mvp_flag: np.ndarray = field(default=None)     # mvp_l0_flag
    mvp_flag1: np.ndarray = field(default=None)    # mvp_l1_flag
    mvd: np.ndarray = field(default=None)          # [h4, w4, 2] int16 (L0)
    mvd1: np.ndarray = field(default=None)         # [h4, w4, 2] (L1)
    max_tr_depth_inter: int = 0
    max_merge_cand: int = 5
    # slice-level reference info (NORMATIVE inputs to the MV derivations):
    # POCs of the active reference pictures per list + current POC
    cur_poc: int = 0
    ref_pocs_l0: tuple = ()
    ref_pocs_l1: tuple = ()
    # TMVP (§8.5.3.2.9): slice_temporal_mvp_enabled + the collocated
    # picture's motion field (dict: pred_mode/inter_dir/mv0/mv1 [4x4
    # grids], poc0/poc1 [4x4 ref-POC maps], poc) — L0[0], from-l0 = 1
    temporal_mvp: bool = False
    col: object = None
    # per-CTB QP (cu_qp_delta, QG == CTB i.e. diff_cu_qp_delta_depth 0):
    # the ACTUAL QpY of each CTB — equal to the predicted QP (previous CTB
    # in raster order / slice QP) when the CTB codes no coefficients.
    # None -> cu_qp_delta disabled (uniform slice QP).  §8.6.1.
    qp_ctb: np.ndarray = field(default=None)
    slice_qp: int = 26
    cu_qp_delta_enabled: bool = False
    tq_bypass: np.ndarray = field(default=None)    # cu_transquant_bypass

    def __post_init__(self):
        g = self.geom
        h4, w4 = g.h4, g.w4
        for name in ("depth", "part", "pred_mode", "luma_mode",
                     "chroma_mode", "tu_depth", "skip", "merge_flag",
                     "merge_idx", "mvp_flag", "mvp_flag1", "inter_dir",
                     "ref_idx0", "ref_idx1", "tq_bypass"):
            if getattr(self, name) is None:
                setattr(self, name, np.zeros((h4, w4), dtype=np.uint8))
        for name in ("mv0", "mv1", "mvd", "mvd1"):
            if getattr(self, name) is None:
                setattr(self, name, np.zeros((h4, w4, 2), dtype=np.int16))
        if not self.ref_pocs_l0:
            self.ref_pocs_l0 = (max(0, self.cur_poc - 1),)
        nctb = g.n_ctbs
        if self.sao_type is None:
            self.sao_type = np.zeros((nctb, 2), dtype=np.int8)
        if self.sao_eo_class is None:
            self.sao_eo_class = np.zeros((nctb, 2), dtype=np.int8)
        if self.sao_band_pos is None:
            self.sao_band_pos = np.zeros((nctb, 3), dtype=np.int8)
        if self.sao_offsets is None:
            self.sao_offsets = np.zeros((nctb, 3, 4), dtype=np.int8)
        if self.qp_ctb is None:
            self.qp_ctb = np.full((nctb,), self.slice_qp, dtype=np.int32)
        h, w = h4 * 4, w4 * 4
        if self.coeff_y is None:
            self.coeff_y = np.zeros((h, w), dtype=np.int32)
        if self.coeff_cb is None:
            self.coeff_cb = np.zeros((h // 2, w // 2), dtype=np.int32)
        if self.coeff_cr is None:
            self.coeff_cr = np.zeros((h // 2, w // 2), dtype=np.int32)

    # -- helpers -------------------------------------------------------------

    def set_region(self, arr: np.ndarray, x0: int, y0: int, size: int, v: int):
        arr[y0 >> 2:(y0 + size) >> 2, x0 >> 2:(x0 + size) >> 2] = v

    def luma_mpm(self, x0: int, y0: int) -> list[int]:
        """§8.4.2 three most-probable luma modes for the PB at (x0, y0)."""
        g = self.geom
        cand = []
        for dx, dy, is_above in ((-1, 0, False), (0, -1, True)):
            xn, yn = x0 + dx, y0 + dy
            mode = DC
            if g.available(x0, y0, xn, yn) and \
               self.pred_mode[yn >> 2, xn >> 2] == MODE_INTRA:
                # above neighbor outside the current CTB row is treated as DC
                if not (is_above and
                        (yn >> g.log2_ctb) != (y0 >> g.log2_ctb)):
                    mode = int(self.luma_mode[yn >> 2, xn >> 2])
            cand.append(mode)
        a, b = cand
        if a == b:
            if a < 2:
                return [PLANAR, DC, VER]
            return [a, 2 + ((a + 29) % 32), 2 + ((a - 2 + 1) % 32)]
        mpm = [a, b]
        if PLANAR not in mpm:
            mpm.append(PLANAR)
        elif DC not in mpm:
            mpm.append(DC)
        else:
            mpm.append(VER)
        return mpm


# chroma mode candidate list (§8.4.3): intra_chroma_pred_mode 0..3 select
# from this list with substitution to 34 when equal to the luma mode
_CHROMA_MODE_LIST = [PLANAR, VER, HOR, DC]


def chroma_mode_from_index(idx: int, luma_mode: int) -> int:
    if idx == 4:
        return luma_mode
    m = _CHROMA_MODE_LIST[idx]
    return 34 if m == luma_mode else m


SLICE_B, SLICE_P, SLICE_I = 0, 1, 2


class CtuDecoder:
    """Decodes CTUs into a PicSyntax structure (the decode methods of the
    reference's ``CtuCoder``)."""

    def __init__(self, ps: PicSyntax, log2_min_cb: int = 3,
                 log2_min_tb: int = 2, log2_max_tb: int = 5,
                 slice_type: int = SLICE_I, sao_luma: bool = False,
                 sao_chroma: bool = False, bit_depth: int = 8,
                 num_ref_l0: int = 1, num_ref_l1: int = 1,
                 mvd_l1_zero: bool = False,
                 transquant_bypass: bool = False):
        self.transquant_bypass = transquant_bypass
        self.ps = ps
        self.g = ps.geom
        self.log2_min_cb = log2_min_cb
        self.log2_min_tb = log2_min_tb
        self.log2_max_tb = log2_max_tb
        self.slice_type = slice_type
        self.sao_luma = sao_luma
        self.sao_chroma = sao_chroma
        self.bit_depth = bit_depth
        self.num_ref_l0 = num_ref_l0
        self.num_ref_l1 = num_ref_l1
        self.mvd_l1_zero = mvd_l1_zero
        # cu_qp_delta state (§8.6.1, QG == CTB): qPY_PREV chain + the
        # one-delta-per-QG latch (IsCuQpDeltaCoded)
        self._qp_pred = ps.slice_qp
        self._qp_delta_pending = False
        self._cur_ctu = 0

    def _split_cu_ctx(self, x0: int, y0: int, depth: int) -> int:
        g, ps = self.g, self.ps
        ctx = 0
        if g.available(x0, y0, x0 - 1, y0) and \
           ps.depth[y0 >> 2, (x0 - 1) >> 2] > depth:
            ctx += 1
        if g.available(x0, y0, x0, y0 - 1) and \
           ps.depth[(y0 - 1) >> 2, x0 >> 2] > depth:
            ctx += 1
        return CTX_OFFSET["SPLIT_CU"] + ctx

    def _dec_sao(self, dec: CabacDecoder, ctu_addr: int) -> None:
        g, ps = self.g, self.ps
        rx, ry = ctu_addr % g.ctbs_w, ctu_addr // g.ctbs_w
        merge_left = merge_up = 0
        if rx > 0:
            merge_left = dec.decode_bin(CTX_OFFSET["SAO_MERGE"])
        if not merge_left and ry > 0:
            merge_up = dec.decode_bin(CTX_OFFSET["SAO_MERGE"])
        if merge_left or merge_up:
            src = ctu_addr - 1 if merge_left else ctu_addr - g.ctbs_w
            ps.sao_type[ctu_addr] = ps.sao_type[src]
            ps.sao_eo_class[ctu_addr] = ps.sao_eo_class[src]
            ps.sao_band_pos[ctu_addr] = ps.sao_band_pos[src]
            ps.sao_offsets[ctu_addr] = ps.sao_offsets[src]
            return
        cmax = (1 << (min(self.bit_depth, 10) - 5)) - 1
        for c_idx in range(3):
            if c_idx == 0 and not self.sao_luma:
                continue
            if c_idx > 0 and not self.sao_chroma:
                continue
            plane_sel = 0 if c_idx == 0 else 1
            if c_idx < 2:
                if dec.decode_bin(CTX_OFFSET["SAO_TYPE_IDX"]):
                    t = 2 if dec.decode_bypass() else 1
                else:
                    t = 0
                ps.sao_type[ctu_addr, plane_sel] = t
            else:
                t = int(ps.sao_type[ctu_addr, 1])
            if t == 0:
                continue
            absv = []
            for i in range(4):
                v = 0
                while v < cmax and dec.decode_bypass():
                    v += 1
                absv.append(v)
            if t == 1:
                for i in range(4):
                    if absv[i] and dec.decode_bypass():
                        absv[i] = -absv[i]
                ps.sao_band_pos[ctu_addr, c_idx] = dec.decode_bypass_bins(5)
                ps.sao_offsets[ctu_addr, c_idx] = absv
            else:
                if c_idx < 2:
                    ps.sao_eo_class[ctu_addr, plane_sel] = \
                        dec.decode_bypass_bins(2)
                ps.sao_offsets[ctu_addr, c_idx] = [absv[0], absv[1],
                                                   -absv[2], -absv[3]]

    def _dec_cu_qp_delta(self, dec: CabacDecoder) -> int:
        base = CTX_OFFSET["CU_QP_DELTA"]
        if not dec.decode_bin(base):
            return 0
        a = 1
        while a < 5 and dec.decode_bin(base + 1):
            a += 1
        if a == 5:
            a += dec.decode_eg_k(0)
        return -a if dec.decode_bypass() else a

    def _skip_ctx(self, x0: int, y0: int) -> int:
        g, ps = self.g, self.ps
        ctx = 0
        if g.available(x0, y0, x0 - 1, y0) and ps.skip[y0 >> 2, (x0 - 1) >> 2]:
            ctx += 1
        if g.available(x0, y0, x0, y0 - 1) and ps.skip[(y0 - 1) >> 2, x0 >> 2]:
            ctx += 1
        return CTX_OFFSET["CU_SKIP"] + ctx

    def _dec_merge_idx(self, dec: CabacDecoder) -> int:
        cmax = self.ps.max_merge_cand - 1
        if cmax == 0:
            return 0
        if not dec.decode_bin(CTX_OFFSET["MERGE_IDX"]):
            return 0
        idx = 1
        while idx < cmax and dec.decode_bypass():
            idx += 1
        return idx

    def _dec_inter_pred_idc(self, dec: CabacDecoder, depth: int) -> int:
        base = CTX_OFFSET["INTER_PRED_IDC"]
        if dec.decode_bin(base + depth):
            return 3
        return 2 if dec.decode_bin(base + 4) else 1

    def _dec_ref_idx(self, dec: CabacDecoder, num: int) -> int:
        if num <= 1:
            return 0
        cmax = num - 1
        if not dec.decode_bin(CTX_OFFSET["REF_IDX"]):
            return 0
        if cmax == 1 or not dec.decode_bin(CTX_OFFSET["REF_IDX"] + 1):
            return 1
        idx = 2
        while idx < cmax and dec.decode_bypass():
            idx += 1
        return idx

    def _dec_mvd(self, dec: CabacDecoder) -> tuple[int, int]:
        base = CTX_OFFSET["MVD_GREATER"]
        gx0 = dec.decode_bin(base)
        gy0 = dec.decode_bin(base)
        gx1 = dec.decode_bin(base + 1) if gx0 else 0
        gy1 = dec.decode_bin(base + 1) if gy0 else 0
        out = []
        for g0, g1 in ((gx0, gx1), (gy0, gy1)):
            if not g0:
                out.append(0)
                continue
            a = 1
            if g1:
                a = 2 + dec.decode_eg_k(1)
            out.append(-a if dec.decode_bypass() else a)
        return out[0], out[1]

    def decode_ctu(self, dec: CabacDecoder, ctu_addr: int) -> None:
        x0, y0 = self.g.ctu_origin(ctu_addr)
        if self.sao_luma or self.sao_chroma:
            self._dec_sao(dec, ctu_addr)
        self._cur_ctu = ctu_addr
        self._qp_delta_pending = self.ps.cu_qp_delta_enabled
        if self.ps.cu_qp_delta_enabled:
            self.ps.qp_ctb[ctu_addr] = self._qp_pred   # until a delta lands
        self._dec_quadtree(dec, x0, y0, self.g.log2_ctb, 0)
        if self.ps.cu_qp_delta_enabled:
            self._qp_pred = int(self.ps.qp_ctb[ctu_addr])

    def _dec_quadtree(self, dec: CabacDecoder, x0: int, y0: int,
                      log2_size: int, depth: int) -> None:
        g, ps = self.g, self.ps
        size = 1 << log2_size
        fits = x0 + size <= g.width and y0 + size <= g.height
        if fits and log2_size > self.log2_min_cb:
            split = dec.decode_bin(self._split_cu_ctx(x0, y0, depth))
        else:
            split = 1 if log2_size > self.log2_min_cb else 0
        if split:
            ps.set_region(ps.depth, x0, y0, size, depth + 1)  # provisional
            half = size >> 1
            for i in range(4):
                x1 = x0 + (i & 1) * half
                y1 = y0 + (i >> 1) * half
                if x1 < g.width and y1 < g.height:
                    self._dec_quadtree(dec, x1, y1, log2_size - 1, depth + 1)
        else:
            ps.set_region(ps.depth, x0, y0, size, depth)
            self._dec_cu(dec, x0, y0, log2_size)

    def _apply_motion(self, x0: int, y0: int, size: int, cand) -> None:
        """Write a MotionCand's full motion into the 4x4 region."""
        ps = self.ps
        sl = (slice(y0 >> 2, (y0 + size) >> 2),
              slice(x0 >> 2, (x0 + size) >> 2))
        ps.inter_dir[sl] = cand.dir
        ps.mv0[sl] = cand.mv0 if cand.dir & 1 else (0, 0)
        ps.ref_idx0[sl] = cand.ref0 if cand.dir & 1 else 0
        ps.mv1[sl] = cand.mv1 if cand.dir & 2 else (0, 0)
        ps.ref_idx1[sl] = cand.ref1 if cand.dir & 2 else 0

    def _dec_cu(self, dec: CabacDecoder, x0: int, y0: int,
                log2_size: int) -> None:
        ps = self.ps
        size = 1 << log2_size
        if self.transquant_bypass:
            bp = dec.decode_bin(CTX_OFFSET["CU_TRANSQUANT_BYPASS"])
            ps.set_region(ps.tq_bypass, x0, y0, size, bp)
        if self.slice_type != SLICE_I:
            from ..common.motion import (MotionCand, amvp_candidates,
                                         merge_candidates)
            skip = dec.decode_bin(self._skip_ctx(x0, y0))
            if skip:
                idx = self._dec_merge_idx(dec)
                cand = merge_candidates(ps, x0, y0, size, size,
                                        ps.max_merge_cand)[idx]
                ps.set_region(ps.skip, x0, y0, size, 1)
                ps.set_region(ps.pred_mode, x0, y0, size, MODE_INTER)
                ps.set_region(ps.merge_idx, x0, y0, size, idx)
                self._apply_motion(x0, y0, size, cand)
                return
            is_intra = dec.decode_bin(CTX_OFFSET["PRED_MODE"])
            if not is_intra:
                part_bin = dec.decode_bin(CTX_OFFSET["PART_MODE"])
                assert part_bin == 1, "only 2Nx2N inter PUs supported"
                merge = dec.decode_bin(CTX_OFFSET["MERGE_FLAG"])
                if merge:
                    idx = self._dec_merge_idx(dec)
                    cand = merge_candidates(ps, x0, y0, size, size,
                                            ps.max_merge_cand)[idx]
                    ps.set_region(ps.merge_flag, x0, y0, size, 1)
                    ps.set_region(ps.merge_idx, x0, y0, size, idx)
                else:
                    d = 1
                    if self.slice_type == SLICE_B:
                        d = self._dec_inter_pred_idc(
                            dec, self.g.log2_ctb - log2_size)
                    mv0 = mv1 = (0, 0)
                    ref0 = ref1 = 0
                    if d & 1:
                        ref0 = self._dec_ref_idx(dec, self.num_ref_l0)
                        mvd = self._dec_mvd(dec)
                        mvp = dec.decode_bin(CTX_OFFSET["MVP_FLAG"])
                        pred = amvp_candidates(ps, x0, y0, size, size,
                                               0, ref0)[mvp]
                        mv0 = (pred[0] + mvd[0], pred[1] + mvd[1])
                        ps.set_region(ps.mvp_flag, x0, y0, size, mvp)
                        ps.mvd[y0 >> 2:(y0 + size) >> 2,
                               x0 >> 2:(x0 + size) >> 2] = mvd
                    if d & 2:
                        ref1 = self._dec_ref_idx(dec, self.num_ref_l1)
                        mvd1 = (0, 0)
                        if not (self.mvd_l1_zero and d == 3):
                            mvd1 = self._dec_mvd(dec)
                        mvp1 = dec.decode_bin(CTX_OFFSET["MVP_FLAG"])
                        pred = amvp_candidates(ps, x0, y0, size, size,
                                               1, ref1)[mvp1]
                        mv1 = (pred[0] + mvd1[0], pred[1] + mvd1[1])
                        ps.set_region(ps.mvp_flag1, x0, y0, size, mvp1)
                        ps.mvd1[y0 >> 2:(y0 + size) >> 2,
                                x0 >> 2:(x0 + size) >> 2] = mvd1
                    cand = MotionCand(d, mv0, ref0, mv1, ref1)
                ps.set_region(ps.pred_mode, x0, y0, size, MODE_INTER)
                self._apply_motion(x0, y0, size, cand)
                ps.set_region(ps.tu_depth, x0, y0, size, 0)
                root_cbf = 1 if merge else dec.decode_bin(
                    CTX_OFFSET["RQT_ROOT_CBF"])
                if root_cbf:
                    self._dec_transform_tree(dec, x0, y0, x0, y0, log2_size,
                                             0, 0, intra_split=False,
                                             parent_cbf_cb=1,
                                             parent_cbf_cr=1, is_intra=False)
                return
        self._dec_intra_cu(dec, x0, y0, log2_size)

    def _dec_intra_cu(self, dec: CabacDecoder, x0: int, y0: int,
                      log2_size: int) -> None:
        ps = self.ps
        size = 1 << log2_size
        nxn = False
        if log2_size == self.log2_min_cb:
            nxn = dec.decode_bin(CTX_OFFSET["PART_MODE"]) == 0
        ps.set_region(ps.part, x0, y0, size, int(nxn))
        ps.set_region(ps.pred_mode, x0, y0, size, MODE_INTRA)
        pb = size >> 1 if nxn else size
        pus = [(x0, y0)]
        if nxn:
            pus = [(x0, y0), (x0 + pb, y0), (x0, y0 + pb), (x0 + pb, y0 + pb)]
        prev_flags = [dec.decode_bin(CTX_OFFSET["PREV_INTRA_LUMA"])
                      for _ in pus]
        for (px, py), in_mpm in zip(pus, prev_flags):
            mpm = ps.luma_mpm(px, py)
            if in_mpm:
                idx = dec.decode_bypass()
                if idx:
                    idx += dec.decode_bypass()
                mode = mpm[idx]
            else:
                rem = dec.decode_bypass_bins(5)
                for m in sorted(mpm):
                    if rem >= m:
                        rem += 1
                mode = rem
            ps.set_region(ps.luma_mode, px, py, pb, mode)

        luma0 = int(ps.luma_mode[y0 >> 2, x0 >> 2])
        if dec.decode_bin(CTX_OFFSET["INTRA_CHROMA"]):
            cidx = dec.decode_bypass_bins(2)
        else:
            cidx = 4
        ps.set_region(ps.chroma_mode, x0, y0, size,
                      chroma_mode_from_index(cidx, luma0))

        self._dec_transform_tree(dec, x0, y0, x0, y0, log2_size, 0, 0,
                                 intra_split=nxn, parent_cbf_cb=1,
                                 parent_cbf_cr=1)

    def _dec_transform_tree(self, dec: CabacDecoder, x0, y0, xbase, ybase,
                            log2_size, depth, blk_idx, *, intra_split,
                            parent_cbf_cb, parent_cbf_cr,
                            is_intra=True) -> None:
        ps = self.ps
        size = 1 << log2_size
        max_depth = (ps.max_tr_depth_intra if is_intra
                     else ps.max_tr_depth_inter) + (1 if intra_split else 0)
        if (log2_size <= self.log2_max_tb and log2_size > self.log2_min_tb
                and depth < max_depth
                and not (intra_split and depth == 0)):
            split = dec.decode_bin(
                CTX_OFFSET["SPLIT_TRANSFORM"] + 5 - log2_size)
        else:
            split = 1 if (log2_size > self.log2_max_tb
                          or (intra_split and depth == 0)) else 0

        cbf_cb, cbf_cr = parent_cbf_cb, parent_cbf_cr
        if log2_size > 2:
            if parent_cbf_cb:
                cbf_cb = dec.decode_bin(CTX_OFFSET["CBF_CHROMA"] + depth)
            if parent_cbf_cr:
                cbf_cr = dec.decode_bin(CTX_OFFSET["CBF_CHROMA"] + depth)

        if split:
            half = size >> 1
            for i in range(4):
                x1 = x0 + (i & 1) * half
                y1 = y0 + (i >> 1) * half
                self._dec_transform_tree(
                    dec, x1, y1, x0, y0, log2_size - 1, depth + 1, i,
                    intra_split=intra_split, parent_cbf_cb=cbf_cb,
                    parent_cbf_cr=cbf_cr, is_intra=is_intra)
            return

        ps.set_region(ps.tu_depth, x0, y0, size, depth)
        if is_intra or depth != 0 or cbf_cb or cbf_cr:
            cbf_luma = dec.decode_bin(
                CTX_OFFSET["CBF_LUMA"] + (1 if depth == 0 else 0))
        else:
            cbf_luma = 1    # inter root TU: inferred
        self._dec_transform_unit(dec, x0, y0, xbase, ybase, log2_size,
                                 blk_idx, cbf_luma, cbf_cb, cbf_cr,
                                 is_intra=is_intra)

    def _dec_transform_unit(self, dec, x0, y0, xbase, ybase, log2_size,
                            blk_idx, cbf_luma, cbf_cb, cbf_cr, *,
                            is_intra=True) -> None:
        ps = self.ps
        if not (cbf_luma or cbf_cb or cbf_cr):
            return
        if self._qp_delta_pending:
            delta = self._dec_cu_qp_delta(dec)
            # §8.6.1 QpY wrap (QpBdOffsetY handled by the recon layer)
            ps.qp_ctb[self._cur_ctu] = (self._qp_pred + delta + 52) % 52
            self._qp_delta_pending = False
        size = 1 << log2_size
        if cbf_luma:
            mode = int(ps.luma_mode[y0 >> 2, x0 >> 2])
            scan = (scan_for_intra(log2_size, 0, mode) if is_intra
                    else SCAN_DIAG)
            block = decode_residual(dec, log2_size, 0, scan,
                                    sign_hiding=ps.sign_hiding)
            ps.coeff_y[y0:y0 + size, x0:x0 + size] = block
        if log2_size > 2:
            cx, cy, clog2 = x0 >> 1, y0 >> 1, log2_size - 1
        elif blk_idx == 3:
            cx, cy, clog2 = xbase >> 1, ybase >> 1, 2
        else:
            return
        # for blk_idx==3 TUs, chroma cbf was decoded at the parent node and
        # passed down; only the last (blk 3) child codes the residual.
        cmode = int(ps.chroma_mode[cy * 2 >> 2, cx * 2 >> 2])
        cscan = (scan_for_intra(clog2, 1, cmode) if is_intra else SCAN_DIAG)
        csz = 1 << clog2
        if cbf_cb:
            ps.coeff_cb[cy:cy + csz, cx:cx + csz] = decode_residual(
                dec, clog2, 1, cscan, sign_hiding=ps.sign_hiding)
        if cbf_cr:
            ps.coeff_cr[cy:cy + csz, cx:cx + csz] = decode_residual(
                dec, clog2, 2, cscan, sign_hiding=ps.sign_hiding)
