"""Per-picture syntax state of the CABAC layer — the ``PicSyntax`` arrays,
the prediction-mode constants and the chroma QP mapping, copied from
``x265_tpu/cabac/ctu.py`` (ITU-T H.265 §7.3.8, §8.6.1).

The port entropy-codes a slice with the native C serializer
(``x265_tpu_torch.native``), which reads these arrays; the reference's
Python ``CtuCoder`` is not carried.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..common.geometry import PictureGeometry

MODE_INTRA, MODE_INTER, MODE_SKIP = 1, 0, 2

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
