"""HEVC parameter sets and slice headers (ITU-T H.265 §7.3.2): the writers
and the parsers of ``x265_tpu/common/headers.py``, copied line for line.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .bitstream import BitReader

# slice types (H.265 Table 7-7)
SLICE_B, SLICE_P, SLICE_I = 0, 1, 2


# ---------------------------------------------------------------------------
# Profile / tier / level
# ---------------------------------------------------------------------------

@dataclass
class ProfileTierLevel:
    profile_idc: int = 1            # 1=Main, 2=Main10
    tier_flag: int = 0
    level_idc: int = 120            # level 4.0 (x30)
    progressive_source: int = 1
    interlaced_source: int = 0
    non_packed_constraint: int = 0
    frame_only_constraint: int = 1


def parse_ptl(br: BitReader, max_sub_layers: int = 1) -> ProfileTierLevel:
    ptl = ProfileTierLevel()
    br.read(2)
    ptl.tier_flag = br.read_flag()
    ptl.profile_idc = br.read(5)
    br.read(32)                         # compat flags
    ptl.progressive_source = br.read_flag()
    ptl.interlaced_source = br.read_flag()
    ptl.non_packed_constraint = br.read_flag()
    ptl.frame_only_constraint = br.read_flag()
    br.read(32); br.read(12)
    ptl.level_idc = br.read(8)
    profile_present = []
    level_present = []
    for _ in range(max_sub_layers - 1):
        profile_present.append(br.read_flag())
        level_present.append(br.read_flag())
    if max_sub_layers > 1:
        for _ in range(max_sub_layers - 1, 8):
            br.read(2)
    for i in range(max_sub_layers - 1):
        if profile_present[i]:
            br.read(32); br.read(32); br.read(24)  # sub-layer profile syntax
        if level_present[i]:
            br.read(8)
    return ptl


# ---------------------------------------------------------------------------
# VPS
# ---------------------------------------------------------------------------

@dataclass
class VPS:
    vps_id: int = 0
    max_sub_layers: int = 1
    temporal_id_nesting: int = 1
    ptl: ProfileTierLevel = field(default_factory=ProfileTierLevel)
    max_dec_pic_buffering: int = 4   # minus1 coded
    num_reorder_pics: int = 0
    max_latency_increase: int = 0    # plus1 coded


def parse_vps(data: bytes) -> VPS:
    br = BitReader(data)
    vps = VPS()
    vps.vps_id = br.read(4)
    br.read(2); br.read(6)
    vps.max_sub_layers = br.read(3) + 1
    vps.temporal_id_nesting = br.read_flag()
    br.read(16)
    vps.ptl = parse_ptl(br, vps.max_sub_layers)
    ordering_present = br.read_flag()
    n = vps.max_sub_layers if ordering_present else 1
    for _ in range(n):
        vps.max_dec_pic_buffering = br.read_ue() + 1
        vps.num_reorder_pics = br.read_ue()
        vps.max_latency_increase = br.read_ue()
    br.read(6)
    num_layer_sets_minus1 = br.read_ue()
    # (layer-set maps not used; we emit none)
    return vps


# ---------------------------------------------------------------------------
# Short-term reference picture sets
# ---------------------------------------------------------------------------

@dataclass
class ShortTermRPS:
    """Negative/positive delta-POC sets (H.265 §7.3.7, explicit form only)."""
    delta_pocs_s0: list = field(default_factory=list)   # negative, in decreasing POC order
    used_s0: list = field(default_factory=list)
    delta_pocs_s1: list = field(default_factory=list)   # positive, increasing
    used_s1: list = field(default_factory=list)

    @property
    def num_negative(self):
        return len(self.delta_pocs_s0)

    @property
    def num_positive(self):
        return len(self.delta_pocs_s1)


def parse_strps(br: BitReader, idx: int, num_sets: int,
                prev_sets: list) -> ShortTermRPS:
    rps = ShortTermRPS()
    pred = br.read_flag() if idx > 0 else 0
    if pred:
        raise NotImplementedError("inter RPS prediction not emitted by this encoder")
    nneg = br.read_ue()
    npos = br.read_ue()
    prev = 0
    for _ in range(nneg):
        d = prev - (br.read_ue() + 1)
        prev = d
        rps.delta_pocs_s0.append(d)
        rps.used_s0.append(br.read_flag())
    prev = 0
    for _ in range(npos):
        d = prev + br.read_ue() + 1
        prev = d
        rps.delta_pocs_s1.append(d)
        rps.used_s1.append(br.read_flag())
    return rps


# ---------------------------------------------------------------------------
# SPS
# ---------------------------------------------------------------------------

@dataclass
class SPS:
    sps_id: int = 0
    vps_id: int = 0
    max_sub_layers: int = 1
    temporal_id_nesting: int = 1
    ptl: ProfileTierLevel = field(default_factory=ProfileTierLevel)
    chroma_format_idc: int = 1      # 4:2:0
    pic_width: int = 0              # luma samples (coded, multiple of minCU)
    pic_height: int = 0
    conf_win: tuple = (0, 0, 0, 0)  # left, right, top, bottom (in chroma units)
    bit_depth_luma: int = 8
    bit_depth_chroma: int = 8
    log2_max_poc_lsb: int = 8
    max_dec_pic_buffering: int = 4
    num_reorder_pics: int = 0
    max_latency_increase: int = 0
    log2_min_cb_size: int = 3
    log2_ctb_size: int = 6
    log2_min_tb_size: int = 2
    log2_max_tb_size: int = 5
    max_transform_hierarchy_depth_inter: int = 0
    max_transform_hierarchy_depth_intra: int = 0
    scaling_list_enabled: int = 0
    amp_enabled: int = 0
    sao_enabled: int = 0
    pcm_enabled: int = 0
    short_term_rps: list = field(default_factory=list)  # list[ShortTermRPS]
    long_term_ref_pics_present: int = 0
    temporal_mvp_enabled: int = 0
    strong_intra_smoothing: int = 1
    vui_present: int = 0
    vui_timing_present: int = 0
    fps_num: int = 25
    fps_denom: int = 1
    # VUI signaling (Annex E; x265 --sar/--range/--colorprim/--transfer/
    # --colormatrix/--chromaloc/--videoformat)
    sar_width: int = 0
    sar_height: int = 0
    video_format: int = 5
    video_full_range: bool = False
    colour_description_present: bool = False
    colour_primaries: int = 2
    transfer_characteristics: int = 2
    matrix_coeffs: int = 2
    chroma_loc_top: int = 0
    chroma_loc_bottom: int = 0
    # HRD (Annex E.2.2; populated by the encoder's initHRD analogue,
    # x265 ratecontrol.cpp:618)
    hrd_present: bool = False
    hrd_bit_rate_scale: int = 0
    hrd_bit_rate_value: int = 0
    hrd_cpb_size_scale: int = 0
    hrd_cpb_size_value: int = 0
    hrd_cbr: bool = False
    hrd_initial_cpb_len: int = 24
    hrd_cpb_removal_len: int = 24
    hrd_dpb_output_len: int = 24

    # derived
    @property
    def ctb_size(self):
        return 1 << self.log2_ctb_size

    @property
    def pic_width_in_ctbs(self):
        return (self.pic_width + self.ctb_size - 1) >> self.log2_ctb_size

    @property
    def pic_height_in_ctbs(self):
        return (self.pic_height + self.ctb_size - 1) >> self.log2_ctb_size


def _parse_hrd(br: BitReader, sps: SPS, max_sub_layers: int):
    """General hrd_parameters parse (Annex E.2.2, commonInfPresent=1) —
    handles arbitrary conforming streams (sub-pic params, VCL HRD,
    multiple CPBs), storing the primary NAL CPB into sps.hrd_*.
    Mirrors libde265 sps/vui parsing (libde265/libde265/vui.cc)."""
    nal_present = br.read_flag()
    vcl_present = br.read_flag()
    sub_pic = 0
    if nal_present or vcl_present:
        sub_pic = br.read_flag()
        if sub_pic:
            br.read(8)                  # tick_divisor_minus2
            br.read(5)                  # du_cpb_removal_delay_increment_length
            br.read_flag()              # sub_pic_cpb_params_in_pic_timing
            br.read(5)                  # dpb_output_delay_du_length
        sps.hrd_bit_rate_scale = br.read(4)
        sps.hrd_cpb_size_scale = br.read(4)
        if sub_pic:
            br.read(4)                  # cpb_size_du_scale
        sps.hrd_initial_cpb_len = br.read(5) + 1
        sps.hrd_cpb_removal_len = br.read(5) + 1
        sps.hrd_dpb_output_len = br.read(5) + 1
    for _ in range(max_sub_layers):
        fixed_general = br.read_flag()
        fixed_cvs = 1 if fixed_general else br.read_flag()
        low_delay = 0
        if fixed_cvs:
            br.read_ue()                # elemental_duration_in_tc_minus1
        else:
            low_delay = br.read_flag()
        cpb_cnt = 1 if low_delay else br.read_ue() + 1
        for li, present in enumerate((nal_present, vcl_present)):
            if not present:
                continue
            for j in range(cpb_cnt):
                brv = br.read_ue() + 1  # bit_rate_value_minus1
                cpv = br.read_ue() + 1  # cpb_size_value_minus1
                if j == 0 and li == 0:
                    sps.hrd_bit_rate_value = brv
                    sps.hrd_cpb_size_value = cpv
                if sub_pic:
                    br.read_ue()        # cpb_size_du_value_minus1
                    br.read_ue()        # bit_rate_du_value_minus1
                sps.hrd_cbr = bool(br.read_flag())
    sps.hrd_present = True


def _parse_vui(br: BitReader, sps: SPS):
    """Annex E.2.1 parse (mirror of _write_vui's emitted subset plus the
    standard fields any conforming stream may carry)."""
    if br.read_flag():                  # aspect_ratio_info_present
        idc = br.read(8)
        SARS = [(0, 0), (1, 1), (12, 11), (10, 11), (16, 11), (40, 33),
                (24, 11), (20, 11), (32, 11), (80, 33), (18, 11),
                (15, 11), (64, 33), (160, 99), (4, 3), (3, 2), (2, 1)]
        if idc == 255:
            sps.sar_width = br.read(16)
            sps.sar_height = br.read(16)
        elif idc < len(SARS):
            sps.sar_width, sps.sar_height = SARS[idc]
    if br.read_flag():                  # overscan_info_present
        br.read_flag()
    if br.read_flag():                  # video_signal_type_present
        sps.video_format = br.read(3)
        sps.video_full_range = bool(br.read_flag())
        sps.colour_description_present = bool(br.read_flag())
        if sps.colour_description_present:
            sps.colour_primaries = br.read(8)
            sps.transfer_characteristics = br.read(8)
            sps.matrix_coeffs = br.read(8)
    if br.read_flag():                  # chroma_loc_info_present
        sps.chroma_loc_top = br.read_ue()
        sps.chroma_loc_bottom = br.read_ue()
    br.read_flag()                      # neutral_chroma_indication
    br.read_flag()                      # field_seq_flag
    br.read_flag()                      # frame_field_info_present
    if br.read_flag():                  # default_display_window
        for _ in range(4):
            br.read_ue()
    sps.vui_timing_present = br.read_flag()
    if sps.vui_timing_present:
        sps.fps_denom = br.read(32)
        sps.fps_num = br.read(32)
        if br.read_flag():              # poc_proportional_to_timing
            br.read_ue()
        if br.read_flag():              # hrd_parameters_present
            _parse_hrd(br, sps, sps.max_sub_layers)
    if br.read_flag():                  # bitstream_restriction
        for _ in range(3):
            br.read_flag()
        for _ in range(5):
            br.read_ue()


def parse_sps(data: bytes) -> SPS:
    br = BitReader(data)
    sps = SPS()
    sps.vps_id = br.read(4)
    sps.max_sub_layers = br.read(3) + 1
    sps.temporal_id_nesting = br.read_flag()
    sps.ptl = parse_ptl(br, sps.max_sub_layers)
    sps.sps_id = br.read_ue()
    sps.chroma_format_idc = br.read_ue()
    if sps.chroma_format_idc == 3:
        br.read_flag()
    sps.pic_width = br.read_ue()
    sps.pic_height = br.read_ue()
    if br.read_flag():
        sps.conf_win = tuple(br.read_ue() for _ in range(4))
    sps.bit_depth_luma = br.read_ue() + 8
    sps.bit_depth_chroma = br.read_ue() + 8
    sps.log2_max_poc_lsb = br.read_ue() + 4
    ordering_present = br.read_flag()
    n = sps.max_sub_layers if ordering_present else 1
    for _ in range(n):
        sps.max_dec_pic_buffering = br.read_ue() + 1
        sps.num_reorder_pics = br.read_ue()
        sps.max_latency_increase = br.read_ue()
    sps.log2_min_cb_size = br.read_ue() + 3
    sps.log2_ctb_size = sps.log2_min_cb_size + br.read_ue()
    sps.log2_min_tb_size = br.read_ue() + 2
    sps.log2_max_tb_size = sps.log2_min_tb_size + br.read_ue()
    sps.max_transform_hierarchy_depth_inter = br.read_ue()
    sps.max_transform_hierarchy_depth_intra = br.read_ue()
    sps.scaling_list_enabled = br.read_flag()
    if sps.scaling_list_enabled:
        if br.read_flag():
            raise NotImplementedError("explicit scaling list data")
    sps.amp_enabled = br.read_flag()
    sps.sao_enabled = br.read_flag()
    sps.pcm_enabled = br.read_flag()
    assert not sps.pcm_enabled, "PCM not supported"
    num_rps = br.read_ue()
    for i in range(num_rps):
        sps.short_term_rps.append(parse_strps(br, i, num_rps, sps.short_term_rps))
    sps.long_term_ref_pics_present = br.read_flag()
    assert not sps.long_term_ref_pics_present
    sps.temporal_mvp_enabled = br.read_flag()
    sps.strong_intra_smoothing = br.read_flag()
    sps.vui_present = br.read_flag()
    if sps.vui_present:
        _parse_vui(br, sps)
    return sps


# ---------------------------------------------------------------------------
# PPS
# ---------------------------------------------------------------------------

@dataclass
class PPS:
    pps_id: int = 0
    sps_id: int = 0
    dependent_slice_segments: int = 0
    output_flag_present: int = 0
    num_extra_slice_header_bits: int = 0
    sign_data_hiding: int = 0
    cabac_init_present: int = 0
    num_ref_idx_l0_default: int = 1
    num_ref_idx_l1_default: int = 1
    init_qp: int = 26
    constrained_intra_pred: int = 0
    transform_skip_enabled: int = 0
    cu_qp_delta_enabled: int = 0
    diff_cu_qp_delta_depth: int = 0
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    slice_chroma_qp_offsets_present: int = 0
    weighted_pred: int = 0
    weighted_bipred: int = 0
    transquant_bypass_enabled: int = 0
    tiles_enabled: int = 0
    entropy_coding_sync_enabled: int = 0
    loop_filter_across_slices: int = 1
    deblocking_filter_control_present: int = 0
    deblocking_filter_override_enabled: int = 0
    deblocking_filter_disabled: int = 0
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    scaling_list_data_present: int = 0
    lists_modification_present: int = 0
    log2_parallel_merge_level: int = 2
    slice_segment_header_extension_present: int = 0


def parse_pps(data: bytes) -> PPS:
    br = BitReader(data)
    pps = PPS()
    pps.pps_id = br.read_ue()
    pps.sps_id = br.read_ue()
    pps.dependent_slice_segments = br.read_flag()
    pps.output_flag_present = br.read_flag()
    pps.num_extra_slice_header_bits = br.read(3)
    pps.sign_data_hiding = br.read_flag()
    pps.cabac_init_present = br.read_flag()
    pps.num_ref_idx_l0_default = br.read_ue() + 1
    pps.num_ref_idx_l1_default = br.read_ue() + 1
    pps.init_qp = br.read_se() + 26
    pps.constrained_intra_pred = br.read_flag()
    pps.transform_skip_enabled = br.read_flag()
    pps.cu_qp_delta_enabled = br.read_flag()
    if pps.cu_qp_delta_enabled:
        pps.diff_cu_qp_delta_depth = br.read_ue()
    pps.cb_qp_offset = br.read_se()
    pps.cr_qp_offset = br.read_se()
    pps.slice_chroma_qp_offsets_present = br.read_flag()
    pps.weighted_pred = br.read_flag()
    pps.weighted_bipred = br.read_flag()
    pps.transquant_bypass_enabled = br.read_flag()
    pps.tiles_enabled = br.read_flag()
    pps.entropy_coding_sync_enabled = br.read_flag()
    assert not pps.tiles_enabled, "tiles not emitted by this encoder"
    pps.loop_filter_across_slices = br.read_flag()
    pps.deblocking_filter_control_present = br.read_flag()
    if pps.deblocking_filter_control_present:
        pps.deblocking_filter_override_enabled = br.read_flag()
        pps.deblocking_filter_disabled = br.read_flag()
        if not pps.deblocking_filter_disabled:
            pps.beta_offset_div2 = br.read_se()
            pps.tc_offset_div2 = br.read_se()
    pps.scaling_list_data_present = br.read_flag()
    assert not pps.scaling_list_data_present
    pps.lists_modification_present = br.read_flag()
    pps.log2_parallel_merge_level = br.read_ue() + 2
    pps.slice_segment_header_extension_present = br.read_flag()
    return pps


# ---------------------------------------------------------------------------
# Slice segment header
# ---------------------------------------------------------------------------

@dataclass
class SliceHeader:
    first_slice_in_pic: int = 1
    no_output_of_prior_pics: int = 0
    pps_id: int = 0
    slice_type: int = SLICE_I
    pic_order_cnt_lsb: int = 0
    rps: ShortTermRPS | None = None     # None for IDR
    rps_sps_idx: int | None = None      # use SPS RPS by index if set
    sao_luma: int = 0
    sao_chroma: int = 0
    num_ref_idx_l0: int = 1
    num_ref_idx_l1: int = 1
    num_ref_idx_active_override: int = 0
    temporal_mvp_enabled: int = 0
    collocated_from_l0: int = 1
    collocated_ref_idx: int = 0
    mvd_l1_zero: int = 0
    cabac_init_flag: int = 0
    max_num_merge_cand: int = 5
    slice_qp: int = 26
    slice_qp_delta_base: int = 26       # = pps.init_qp when writing
    deblocking_filter_override: int = 0
    deblocking_filter_disabled: int = 0
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    loop_filter_across_slices: int = 1
    entry_points: list = field(default_factory=list)  # WPP substream byte sizes
    slice_segment_address: int = 0
    dependent_slice: int = 0
    # pred_weight_table (§7.3.6.3), entries per l0/l1 ref:
    # (luma_flag, w, o, chroma_flag, wcb, ocb, wcr, ocr)
    luma_log2_weight_denom: int = 0
    chroma_log2_weight_denom: int = 0
    weights_l0: list = field(default_factory=list)
    weights_l1: list = field(default_factory=list)


DEFAULT_WEIGHT = (0, 64, 0, 0, 64, 0, 64, 0)  # flags off -> unity weights


def parse_pred_weight_table(br: BitReader, sh: SliceHeader) -> None:
    d = br.read_ue()
    dc = d + br.read_se()
    sh.luma_log2_weight_denom = d
    sh.chroma_log2_weight_denom = dc
    for which in ("l0", "l1") if sh.slice_type == SLICE_B else ("l0",):
        n = sh.num_ref_idx_l0 if which == "l0" else sh.num_ref_idx_l1
        lflags = [br.read_flag() for _ in range(n)]
        cflags = [br.read_flag() for _ in range(n)]
        out = []
        for i in range(n):
            w, o, wcb, ocb, wcr, ocr = 1 << d, 0, 1 << dc, 0, 1 << dc, 0
            if lflags[i]:
                w = (1 << d) + br.read_se()
                o = br.read_se()
            if cflags[i]:
                wcb = (1 << dc) + br.read_se()
                ocb = max(-128, min(127,
                                    br.read_se()
                                    + (128 - ((128 * wcb) >> dc))))
                wcr = (1 << dc) + br.read_se()
                ocr = max(-128, min(127,
                                    br.read_se()
                                    + (128 - ((128 * wcr) >> dc))))
            out.append((lflags[i], w, o, cflags[i], wcb, ocb, wcr, ocr))
        setattr(sh, f"weights_{which}", out)


def parse_slice_header(br: BitReader, sps: SPS, pps: PPS,
                       nal_type: int) -> SliceHeader:
    from .bitstream import NAL_BLA_W_LP, NAL_IDR_W_RADL, NAL_IDR_N_LP
    sh = SliceHeader()
    is_irap = NAL_BLA_W_LP <= nal_type <= 23
    is_idr = nal_type in (NAL_IDR_W_RADL, NAL_IDR_N_LP)
    sh.first_slice_in_pic = br.read_flag()
    if is_irap:
        sh.no_output_of_prior_pics = br.read_flag()
    sh.pps_id = br.read_ue()
    if not sh.first_slice_in_pic:
        if pps.dependent_slice_segments:
            sh.dependent_slice = br.read_flag()
        n_ctbs = sps.pic_width_in_ctbs * sps.pic_height_in_ctbs
        sh.slice_segment_address = br.read(max(1, (n_ctbs - 1).bit_length()))
    if not sh.dependent_slice:
        for _ in range(pps.num_extra_slice_header_bits):
            br.read_flag()
        sh.slice_type = br.read_ue()
        if pps.output_flag_present:
            br.read_flag()
        if not is_idr:
            sh.pic_order_cnt_lsb = br.read(sps.log2_max_poc_lsb)
            from_sps = br.read_flag()
            if from_sps:
                nbits = max(1, (len(sps.short_term_rps) - 1).bit_length()) \
                    if len(sps.short_term_rps) > 1 else 0
                sh.rps_sps_idx = br.read(nbits) if nbits else 0
                sh.rps = sps.short_term_rps[sh.rps_sps_idx]
            else:
                sh.rps = parse_strps(br, len(sps.short_term_rps),
                                     len(sps.short_term_rps) + 1,
                                     sps.short_term_rps)
            if sps.temporal_mvp_enabled:
                sh.temporal_mvp_enabled = br.read_flag()
        if sps.sao_enabled:
            sh.sao_luma = br.read_flag()
            sh.sao_chroma = br.read_flag()
        if sh.slice_type != SLICE_I:
            sh.num_ref_idx_l0 = pps.num_ref_idx_l0_default
            sh.num_ref_idx_l1 = pps.num_ref_idx_l1_default
            if br.read_flag():
                sh.num_ref_idx_l0 = br.read_ue() + 1
                if sh.slice_type == SLICE_B:
                    sh.num_ref_idx_l1 = br.read_ue() + 1
            if pps.lists_modification_present:
                raise NotImplementedError
            if sh.slice_type == SLICE_B:
                sh.mvd_l1_zero = br.read_flag()
            if pps.cabac_init_present:
                sh.cabac_init_flag = br.read_flag()
            if sh.temporal_mvp_enabled:
                if sh.slice_type == SLICE_B:
                    sh.collocated_from_l0 = br.read_flag()
                refs = sh.num_ref_idx_l0 if sh.collocated_from_l0 else sh.num_ref_idx_l1
                if refs > 1:
                    sh.collocated_ref_idx = br.read_ue()
            if (pps.weighted_pred and sh.slice_type == SLICE_P) or \
               (pps.weighted_bipred and sh.slice_type == SLICE_B):
                parse_pred_weight_table(br, sh)
            sh.max_num_merge_cand = 5 - br.read_ue()
        sh.slice_qp = pps.init_qp + br.read_se()
        if pps.slice_chroma_qp_offsets_present:
            br.read_se(); br.read_se()
        if pps.deblocking_filter_control_present:
            sh.deblocking_filter_disabled = pps.deblocking_filter_disabled
            if pps.deblocking_filter_override_enabled:
                sh.deblocking_filter_override = br.read_flag()
            if sh.deblocking_filter_override:
                sh.deblocking_filter_disabled = br.read_flag()
                if not sh.deblocking_filter_disabled:
                    sh.beta_offset_div2 = br.read_se()
                    sh.tc_offset_div2 = br.read_se()
            else:
                sh.beta_offset_div2 = pps.beta_offset_div2
                sh.tc_offset_div2 = pps.tc_offset_div2
        else:
            sh.deblocking_filter_disabled = 0
        if pps.loop_filter_across_slices and \
           (sh.sao_luma or sh.sao_chroma or not sh.deblocking_filter_disabled):
            sh.loop_filter_across_slices = br.read_flag()
    if pps.tiles_enabled or pps.entropy_coding_sync_enabled:
        n = br.read_ue()
        if n:
            nbits = br.read_ue() + 1
            sh.entry_points = [br.read(nbits) + 1 for _ in range(n)]
    if pps.slice_segment_header_extension_present:
        ext_len = br.read_ue()
        for _ in range(ext_len):
            br.read(8)
    # byte_alignment() (§7.3.2.12): alignment_bit_equal_to_one is ALWAYS
    # present (a full extra byte when already aligned), then zero bits.
    bit = br.read(1)
    assert bit == 1, "missing slice-header alignment bit"
    br.byte_align()
    return sh
