"""The frame encoder (I, P and B slices) on a torch device — the host
logic of ``x265_tpu.encoder.intra_encoder.Encoder``, copied line for line
where the stream depends on it, with the device seams on torch.

Per frame: the device pipeline (``device_pipeline.py``) returns one dict of
small outputs, fetched with ONE packed copy (``fetch_packed``); the host
then scatters the syntax, derives merge/AMVP/skip (native C), entropy-codes
with the native CABAC serializer, and appends the hash SEI.  The
independent non-reference Bs of a mini-GOP go through one batched dispatch
and one fetch.

Scope: ``encode_frame`` with ``bframes == 0`` (zero latency, no
lookahead); ``push_frame`` / ``flush`` with B frames, b-pyramid and the
lookahead (``encoder/lookahead.py``: lowres analysis, cuTree offsets, the
b-adapt trellis, the lookahead scenecut), so ``Params()`` defaults run;
``encode_sequence``; Main (8-bit) and Main10 (``internal_bit_depth=10``:
uint16 source and recon planes, the hash SEIs over 16-bit samples), 64x64,
32x32 and 16x16 CTBs (``ctu_size``; the superfast and ultrafast presets run
at 32), on the card by default (``device="cuda"``; the tests pass
``device="cpu"``); RDOQ with psy-RDOQ (the slow presets) and DCT-domain
noise reduction (``noise_reduction_intra`` / ``_inter``); rate control
(CQP, CRF, ABR, VBV, 2-pass, zones, qpfile: ``ratecontrol.py``) with the
HRD's ``hrd_parameters`` and buffering-period / picture-timing SEIs; and
lossless (transquant bypass, all-intra: the open-loop mode decision and the
residuals in plain torch, no scan).  Other bit depths raise
``NotImplementedError``.
"""
from __future__ import annotations

import sys as _sys
import time as _time
from dataclasses import dataclass

import numpy as np
import torch

from .._util import to_device, to_host_samples
from ..cabac.ctu import MODE_INTER, MODE_INTRA, PicSyntax, chroma_qp
from ..common.bitstream import (NAL_AUD, NAL_IDR_W_RADL, NAL_PPS,
                                NAL_PREFIX_SEI, NAL_SPS, NAL_SUFFIX_SEI,
                                NAL_TRAIL_N, NAL_TRAIL_R, NAL_VPS, BitWriter,
                                wrap_nal)
from ..common.geometry import PictureGeometry, intra_neighbor_coords
from ..common.headers import (PPS, SPS, VPS, SLICE_B, SLICE_I, SLICE_P,
                              ProfileTierLevel, ShortTermRPS, SliceHeader,
                              write_pps, write_slice_header, write_sps,
                              write_vps)
from ..common.level import determine_level, enforce_level
from ..common.params import HASH_CHECKSUM, Params, unsupported_param_warnings
from ..common.sei import (SEI_BUFFERING_PERIOD, SEI_CONTENT_LIGHT_LEVEL,
                          SEI_DECODED_PICTURE_HASH, SEI_MASTERING_DISPLAY,
                          SEI_PIC_TIMING, SEI_USER_DATA_UNREGISTERED,
                          buffering_period_payload,
                          content_light_level_payload,
                          mastering_display_payload, pic_timing_payload,
                          picture_hash_payload, write_sei_rbsp)
from ..native import derive_inter_syntax_native, encode_slice_data_native
from ..ops.cost import satd
from ..ops.deblock import _chroma_qp_arr
from ..ops.intra import predict_all_modes, substitute_references
from .wavefront import _predict_lanes, _substitute

# name and version written into the info SEI: the reference's, so that the
# headers (and the whole stream) are byte-identical to x265_tpu's
_INFO_SEI_NAME = "x265_tpu 0.1.0"


@dataclass
class EncodedFrame:
    """One encoded picture."""
    poc: int
    display_idx: int
    au: bytes
    recon: tuple          # conformance-cropped recon planes (numpy)
    coded: tuple          # coded-size recon planes (device tensors;
                          # numpy for a lossless picture)
    kind: str
    qp: int
    stats: dict = None    # x265_frame_stats analogue (CU distribution)


def _frame_cu_stats(ps) -> dict:
    """Per-frame CU distribution (x265_frame_stats.cuStats analogue)."""
    pm = ps.pred_mode[::4, ::4]
    n = pm.size
    inter = pm != 1
    mf = ps.merge_flag[::4, ::4] != 0
    sk = ps.skip[::4, ::4] != 0
    d = ps.depth[::4, ::4].astype(np.int32)

    def pct_depth(k):
        # guard negative depths (small CTUs): comparing a uint8 view
        # against an out-of-range scalar crashes this numpy build
        if k < 0:
            return 0.0
        return round(100.0 * float((d == k).sum()) / n, 2)

    return {
        "pct_intra": round(100.0 * float((~inter).sum()) / n, 2),
        "pct_inter": round(100.0 * float(inter.sum()) / n, 2),
        "pct_merge": round(100.0 * float((inter & mf).sum()) / n, 2),
        "pct_skip": round(100.0 * float((inter & sk).sum()) / n, 2),
        # per-CU-size area shares (16-unit granularity)
        "pct_cu64": pct_depth(ps.geom.log2_ctb - 6),
        "pct_cu32": pct_depth(ps.geom.log2_ctb - 5),
        "pct_cu16": pct_depth(ps.geom.log2_ctb - 4),
    }


@dataclass
class _Pending:
    """A dispatched frame awaiting its host finish."""
    poc: int
    kind: str
    qp: int
    ps: object
    display_idx: int
    planes: tuple = None
    orig: tuple = None
    out_dev: object = None      # (small dict, tails dict) on the device
    ext: object = None          # ME-extended recon planes (DPB entry)
    l0_poc: object = None
    l1_poc: object = None
    rec: tuple = None           # recon planes of a lossless picture
    cu_size: int = 16
    allow_scenecut: bool = False
    batch_idx: object = None    # index into a batched dispatch
    qp_arrays: object = None    # stashed device QP inputs (deferred)
    filter_qps: object = None
    wp: tuple = (64, 0, False)


class _BatchFetch:
    """The small outputs of a batched dispatch (B frames of a mini-GOP, or
    a GOP-parallel round), fetched to the host once (one packed copy) for
    all its frames."""

    def __init__(self, small):
        self.small = small
        self._np = None

    def fetch(self):
        if self._np is None:
            self._np = fetch_packed(self.small)
        return self._np


def fetch_packed(small: dict) -> dict:
    """Copy a dict of device tensors to host numpy arrays in ONE transfer:
    every leaf is viewed as bytes and concatenated on the device."""
    names = sorted(small)
    metas, parts = [], []
    for n in names:
        v = small[n]
        host_dt = (np.dtype(bool) if v.dtype == torch.bool
                   else torch.empty((), dtype=v.dtype).numpy().dtype)
        x = v.reshape(-1)
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        b = x.contiguous().view(torch.uint8)
        metas.append((n, host_dt, tuple(v.shape), b.numel()))
        parts.append(b)
    buf = torch.cat(parts).cpu().numpy()
    out, off = {}, 0
    for n, host_dt, shape, nb in metas:
        store = np.uint8 if host_dt == bool else host_dt
        a = np.frombuffer(buf[off:off + nb].tobytes(), dtype=store).reshape(
            shape)
        out[n] = a.astype(bool) if host_dt == bool else a
        off += nb
    return out


def pad_plane(p: np.ndarray, h: int, w: int) -> np.ndarray:
    """Edge-replicate pad a plane to (h, w)."""
    out = np.empty((h, w), dtype=p.dtype)
    ph, pw = p.shape
    out[:ph, :pw] = p
    if pw < w:
        out[:ph, pw:] = out[:ph, pw - 1:pw]
    if ph < h:
        out[ph:, :] = out[ph - 1:ph, :]
    return out


def check_supported(params: Params) -> None:
    """Raise NotImplementedError for configurations the port lacks."""
    if params.internal_bit_depth not in (8, 10):
        raise NotImplementedError("x265_tpu_torch does not support: "
                                  "bit depth other than 8 and 10")


class Encoder:
    """HEVC encoder (I/P/B slices) whose device work runs on ``device``
    (the card unless the caller asks for the CPU)."""

    def __init__(self, params: Params, device="cuda"):
        check_supported(params)
        self.device = torch.device(device)
        self.params = params
        w, h = params.source_width, params.source_height
        assert w > 0 and h > 0
        if params.log_level >= 1:
            for msg in unsupported_param_warnings(params):
                print(msg, file=_sys.stderr)
        if params.lossless:
            # transquant bypass: lossy-only tools off; in-loop filters
            # would break exactness
            params.sign_hide = False
            params.sao = False
            params.deblock = False
            params.aq_mode = 0
        align = 16
        cw = (w + align - 1) & ~(align - 1)
        ch = (h + align - 1) & ~(align - 1)
        log2_ctb = params.ctu_size.bit_length() - 1
        self.geom = PictureGeometry(cw, ch, log2_ctb, 3)
        self.bit_depth = params.internal_bit_depth

        level_idc, tier = determine_level(
            cw, ch, params.fps_num, params.fps_denom,
            bitrate_kbps=max(params.bitrate, params.vbv_max_bitrate),
            requested_idc=params.level_idc, high_tier=params.high_tier)
        for msg in enforce_level(params, level_idc, tier):
            if params.log_level >= 1:
                print(msg, file=_sys.stderr)
        ptl = ProfileTierLevel(profile_idc=2 if self.bit_depth > 8 else 1,
                               level_idc=level_idc, tier_flag=tier)
        self.sps = SPS(
            ptl=ptl,
            pic_width=cw, pic_height=ch,
            bit_depth_luma=self.bit_depth, bit_depth_chroma=self.bit_depth,
            log2_ctb_size=log2_ctb,
            log2_min_cb_size=3,
            max_transform_hierarchy_depth_intra=max(
                0, params.tu_intra_depth - 1),
            max_transform_hierarchy_depth_inter=2,
            conf_win=(0, (cw - w) // 2, 0, (ch - h) // 2),
            strong_intra_smoothing=int(params.strong_intra_smoothing),
            vui_timing_present=1, vui_present=1,
            fps_num=params.fps_num, fps_denom=params.fps_denom,
            sar_width=params.sar_width, sar_height=params.sar_height,
            video_format=params.video_format,
            video_full_range=bool(params.video_full_range),
            colour_description_present=(params.colorprim != 2
                                        or params.transfer != 2
                                        or params.colormatrix != 2),
            colour_primaries=params.colorprim,
            transfer_characteristics=params.transfer,
            matrix_coeffs=params.colormatrix,
            chroma_loc_top=params.chromaloc,
            chroma_loc_bottom=params.chromaloc,
            max_dec_pic_buffering=max(1, min(4, params.ref)) + 1,
            num_reorder_pics=0,
            temporal_mvp_enabled=int(bool(params.temporal_mvp)),
            sao_enabled=int(params.sao))
        shd = int(params.sign_hide)
        if params.deblock:
            self.pps = PPS(init_qp=26, sign_data_hiding=shd,
                           deblocking_filter_control_present=int(
                               params.deblock_tc_offset
                               or params.deblock_beta_offset),
                           tc_offset_div2=params.deblock_tc_offset,
                           beta_offset_div2=params.deblock_beta_offset)
        else:
            self.pps = PPS(init_qp=26, sign_data_hiding=shd,
                           deblocking_filter_control_present=1,
                           deblocking_filter_disabled=1)
        self.pps.weighted_pred = int(params.weightp)
        self.pps.transquant_bypass_enabled = int(params.lossless)
        self.vps = VPS(ptl=ptl)
        self.aq = bool(params.aq_mode and params.aq_strength > 0)
        self.pps.cu_qp_delta_enabled = int(self.aq)
        self.qp = params.qp
        self.poc = 0
        self.frames_encoded = 0
        self.last_slice_type_str = "I"
        self._ctu_scan = None
        self._mode_tables = {}
        self._i_pipeline = None
        self._p_pipeline = None
        self._b_pipeline = None
        self._b_ref_pipeline = None
        self._b_batch_pipelines = {}    # F -> batched-B pipeline
        # lossless is all-intra
        self.force_all_intra = bool(params.lossless)
        mr = max(1, min(64, params.me_range))
        self.me_fine = min(8, mr)
        self.me_coarse = max(0, (mr - self.me_fine) // 4)
        self.me_range = 4 * self.me_coarse + self.me_fine
        # DCT-domain noise reduction (x265 --nr-intra/--nr-inter;
        # quant.cpp:205 denoiseDct + frameencoder.cpp:1331 update):
        # host-side running sums drive per-position offsets fed to the
        # device scan each frame
        self._nr_enabled = bool(params.noise_reduction_intra
                                or params.noise_reduction_inter)
        self._nr_sizes = {"y16": (256, 16), "c8": (64, 8),
                          "y32": (1024, 32), "c16": (256, 16)}
        self._nr_state = {}
        self._nr_offsets = {}
        if self._nr_enabled:
            for cat, (nn, _) in self._nr_sizes.items():
                for sfx in ("_i", "_p"):
                    self._nr_state[cat + sfx] = [
                        np.zeros((nn,), np.int64), 0]
                    self._nr_offsets[cat + sfx] = np.zeros((nn,),
                                                           np.int32)
        # stage wall-clock accounting, rendered by summary()
        self._clock = _time.time
        self._t0 = self._clock()
        self._perf = {"frames": 0, "bytes": 0, "qp_sum": 0,
                      "fetch_wait": 0.0, "entropy": 0.0,
                      "by_type": {"I": 0, "P": 0, "B": 0}}
        from .ratecontrol import RateControl
        self.rc = RateControl(params)
        # HRD signalling (x265 --hrd) requires VBV: hrd_parameters in the
        # VUI plus buffering-period (IRAP) and pic-timing (every AU) SEIs
        self.hrd = bool(params.hrd)
        if self.hrd and not self.rc.vbv:
            if params.log_level >= 1:
                print("x265_tpu [warning]: --hrd requires --vbv-bufsize/"
                      "--vbv-maxrate; disabling HRD", file=_sys.stderr)
            self.hrd = False
        if self.hrd:
            self._init_hrd()
        self._last_bp_order = 0         # encode order of the last BP SEI
        self._cvs_finish_base = 0       # finish counter at the last IDR
        self._zones: list = []
        if params.zones:
            for z in params.zones.split("/"):
                parts = z.split(",")
                s, e = int(parts[0]), int(parts[1])
                qv = fac = None
                for kv in parts[2:]:
                    k, v = kv.split("=")
                    if k == "q":
                        qv = int(v)
                    elif k == "b":
                        fac = float(v)
                self._zones.append((s, e, qv, fac))
        self._qpfile_map: dict[int, int] = {}
        if params.qpfile:
            with open(params.qpfile) as fh:
                for line in fh:
                    f = line.split()
                    if len(f) >= 3 and int(f[2]) >= 0:
                        self._qpfile_map[int(f[0])] = int(f[2])
        self._prev_half = None
        self.bframes = params.bframes
        self._queue = []                # [(poc, planes, la)] display order
        self._next_poc = 0
        self._display_idx = 0
        self._cvs_base = 0
        self.dpb = {}
        self.dpb_dev = {}
        self.num_ref = max(1, min(4, params.ref))
        self._ref_pocs: list[int] = []
        self._wp_src = {}
        self._col_store = {}
        self.prev_anchor_poc = None
        # the lookahead: cuTree over a rc_lookahead-deep window and the
        # b-adapt trellis; adds output delay (push_frame / flush);
        # encode_frame() is the zero-latency path without it
        self.lookahead = None
        self._use_lookahead = ((params.cu_tree and params.rc_lookahead > 0
                                and self.aq)
                               or (params.b_adapt > 0 and self.bframes > 0
                                   and params.rc_lookahead > 0))
        self._anchor_low = None         # LowresFrame of the last anchor
        self._la_frame = None           # (offsets16, satd, scenecut, frame)
        self._la_off16 = None
        self._inflight: list[_Pending] = []
        self.pipeline_depth = max(1, params.frame_parallelism)
        # b-pyramid: the middle B of each mini-GOP becomes a reference
        self.b_pyramid = bool(params.b_pyramid and self.bframes >= 2)
        if self.bframes:
            # anchors precede their Bs in decode order but follow in
            # output order; the pyramid adds one reorder level and one DPB
            # slot for the reference B
            reorder = 2 if self.b_pyramid else 1
            cap = max(4, self.num_ref + 2) + (1 if self.b_pyramid else 0)
            self.sps.num_reorder_pics = reorder
            self.sps.max_dec_pic_buffering = cap
            self.vps.num_reorder_pics = reorder
            self.vps.max_dec_pic_buffering = cap

    def _init_hrd(self) -> None:
        """x265 RateControl::initHRD: the VBV rate and size in the HRD's
        value/scale notation, and the sizes of the SEI delay fields."""
        p = self.params
        sps = self.sps

        def ctz(x):
            return (x & -x).bit_length() - 1 if x > 0 else 0

        def blen(x):
            return max(1, int(x).bit_length())

        br = p.vbv_max_bitrate * 1000
        cpb = p.vbv_buffer_size * 1000
        sps.hrd_bit_rate_scale = min(15, max(0, ctz(br) - 6))
        sps.hrd_bit_rate_value = br >> (sps.hrd_bit_rate_scale + 6)
        sps.hrd_cpb_size_scale = min(15, max(0, ctz(cpb) - 4))
        sps.hrd_cpb_size_value = cpb >> (sps.hrd_cpb_size_scale + 4)
        br_u = sps.hrd_bit_rate_value << (sps.hrd_bit_rate_scale + 6)
        cpb_u = sps.hrd_cpb_size_value << (sps.hrd_cpb_size_scale + 4)
        self._hrd_bitrate_unscale = br_u
        self._hrd_cpb_unscale = cpb_u
        tick = sps.fps_num / max(1, sps.fps_denom)
        max_cpb_delay = int(min(max(1, p.keyint_max) * 0.5 * tick, 2**31))
        max_dpb_delay = int(max(1, sps.max_dec_pic_buffering * 0.5 * tick))
        max_delay = int(90000.0 * cpb_u / max(1, br_u) + 0.5)
        # inherited from the reference and kept so the streams stay equal:
        # the removal and output delay lengths are sized from the inverted
        # bit lengths
        sps.hrd_initial_cpb_len = 2 + min(22, max(4, 32 - blen(max_delay)))
        sps.hrd_cpb_removal_len = min(31, max(4, 32 - blen(max_cpb_delay)))
        sps.hrd_dpb_output_len = min(31, max(4, 32 - blen(max_dpb_delay)))
        sps.hrd_cbr = (p.rc_mode == 2
                       and p.vbv_max_bitrate <= p.bitrate)
        sps.hrd_present = True
        sps.vui_present = 1
        sps.vui_timing_present = 1

    def _min_keyint(self) -> int:
        p = self.params
        keyint = max(1, p.keyint_max)
        mk = p.keyint_min
        if mk <= 0:
            fps = p.fps_num / max(1, p.fps_denom)
            mk = min(int(fps), keyint // 10)
        return max(1, min(mk, keyint // 2 + 1))

    # -- stream headers ------------------------------------------------------

    def headers(self) -> bytes:
        out = (wrap_nal(NAL_VPS, write_vps(self.vps))
               + wrap_nal(NAL_SPS, write_sps(self.sps))
               + wrap_nal(NAL_PPS, write_pps(self.pps)))
        hdr_seis = []
        if self.params.master_display:
            hdr_seis.append((SEI_MASTERING_DISPLAY,
                             mastering_display_payload(
                                 self.params.master_display)))
        if self.params.max_cll:
            cll, fall = (int(v) for v in self.params.max_cll.split(","))
            hdr_seis.append((SEI_CONTENT_LIGHT_LEVEL,
                             content_light_level_payload(cll, fall)))
        if hdr_seis:
            out += wrap_nal(NAL_PREFIX_SEI, write_sei_rbsp(hdr_seis),
                            long_start_code=False)
        if self.params.emit_info_sei:
            uuid = bytes(range(16))
            info = (f"{_INFO_SEI_NAME} - TPU-native HEVC encoder - "
                    f"qp={self.params.qp} ctu={self.params.ctu_size}"
                    ).encode()
            sei = write_sei_rbsp([(SEI_USER_DATA_UNREGISTERED,
                                   uuid + info)])
            out += wrap_nal(NAL_PREFIX_SEI, sei)
        return out

    def _complexity_estimate(self, orig, is_p: bool) -> float:
        y = orig[0].astype(np.int32)
        half = (y[0::2, 0::2] + y[1::2, 0::2]
                + y[0::2, 1::2] + y[1::2, 1::2] + 2) >> 2
        if is_p and self._prev_half is not None:
            est = 1.5 * float(np.abs(half - self._prev_half).sum())
        else:
            est = 0.8 * float(np.abs(np.diff(half, axis=1)).sum()
                              + np.abs(np.diff(half, axis=0)).sum())
        self._prev_half = half
        return est

    def _mode_gather_tables(self, n, gh, gw, H, W, chroma=False):
        """Cached [B, 4n+1] gather indices + availability of the open-loop
        mode-decision reference vectors (a chroma plane's availability is
        evaluated in luma coordinates: the geometry's z-scan is
        luma-domain)."""
        key = (chroma, n, gh, gw, H, W)
        t = self._mode_tables.get(key)
        if t is not None:
            return t
        g = self.geom
        s = int(chroma)
        ridx = np.zeros((gh * gw, 4 * n + 1), np.int64)
        avails = np.zeros((gh * gw, 4 * n + 1), bool)
        for by in range(gh):
            for bx in range(gw):
                x0, y0 = bx * n, by * n
                xs, ys = intra_neighbor_coords(x0, y0, n)
                avails[by * gw + bx] = g.avail_rows(x0 << s, y0 << s,
                                                    xs << s, ys << s)
                ridx[by * gw + bx] = (np.clip(ys, 0, H - 1) * W
                                      + np.clip(xs, 0, W - 1))
        self._mode_tables[key] = (ridx, avails)
        return ridx, avails

    def _decide_modes(self, orig):
        """Open-loop best intra mode per fixed-size CU (the 35-mode SATD
        argmin over original neighbours), batched on the device.  Returns
        (cu_size, modes [gh, gw] host array, the mode-choice tensor on the
        device)."""
        g = self.geom
        cu_size = min(16, 1 << g.log2_ctb)
        n = cu_size
        y = self._dev(orig[0]).to(torch.int32)
        gh = (g.ctbs_h << g.log2_ctb) // n
        gw = (g.ctbs_w << g.log2_ctb) // n
        H, W = y.shape
        ridx, avails = self._mode_gather_tables(n, gh, gw, H, W)
        refs = substitute_references(y.reshape(-1)[self._dev(ridx)],
                                     self._dev(avails), self.bit_depth)
        preds = predict_all_modes(refs, n, True, self.bit_depth)
        blocks = y.reshape(gh, n, gw, n).permute(0, 2, 1, 3).reshape(
            gh * gw, n, n)
        costs = satd(blocks[:, None], preds)        # [B, 35]
        modes = torch.argmin(costs, dim=1).to(torch.int32)
        return cu_size, modes.cpu().numpy().reshape(gh, gw), modes

    def _encode_lossless(self, ps, orig):
        """All-intra transquant-bypass picture.  recon == source, so intra
        prediction reads the original neighbours: every block's mode
        decision, prediction and residual runs as one batch.  The
        residual samples are coded verbatim through residual_coding.
        Returns the recon planes (the padded source)."""
        bd = self.bit_depth
        cu_size, modes, modes_dev = self._decide_modes(orig)
        s4 = cu_size // 4
        ps.luma_mode[:] = np.kron(modes.astype(np.uint8),
                                  np.ones((s4, s4), np.uint8))
        ps.chroma_mode[:] = ps.luma_mode
        ps.tq_bypass[:] = 1
        jobs = ((orig[0], cu_size, True, ps.coeff_y),
                (orig[1], cu_size // 2, False, ps.coeff_cb),
                (orig[2], cu_size // 2, False, ps.coeff_cr))
        for pl, n, is_luma, coeff in jobs:
            H, W = pl.shape
            gh, gw = H // n, W // n
            ridx, avails = self._mode_gather_tables(n, gh, gw, H, W,
                                                    chroma=not is_luma)
            x = self._dev(pl).to(torch.int32)
            refs = _substitute(x.reshape(-1)[self._dev(ridx)],
                               self._dev(avails), bd)
            pred = _predict_lanes(refs, modes_dev, n, is_luma, bd)
            blocks = x.reshape(gh, n, gw, n).permute(0, 2, 1, 3).reshape(
                -1, n, n)
            resi = (blocks - pred).reshape(gh, gw, n, n).permute(0, 2, 1, 3)
            coeff[:] = resi.reshape(H, W).cpu().numpy()
        return orig

    # -- top level -----------------------------------------------------------

    def encode_frame(self, planes):
        """planes: (Y, Cb, Cr) uint8 source arrays.  Zero-latency path:
        the lookahead is off and the frame pipeline drains synchronously
        (``bframes == 0`` only: B frames reorder the output, use
        ``push_frame`` / ``flush``).  Returns (annexb_bytes,
        recon_planes_cropped)."""
        if self.bframes:
            raise ValueError(
                "bframes > 0 reorders output; use push_frame()/flush()")
        assert self.lookahead is None, \
            "encode_frame() after push_frame() with an active lookahead"
        self._use_lookahead = False
        out = self.push_frame(planes) + self._drain(0)
        assert len(out) == 1
        return out[0].au, out[0].recon

    def push_frame(self, planes) -> list:
        """Feed one display-order frame; returns the EncodedFrames this
        push finished, in encode order (``pipeline_depth`` frames stay in
        flight; with B frames a whole mini-GOP is dispatched once its
        anchor arrives)."""
        if self._use_lookahead:
            if self.lookahead is None:
                from .lookahead import Lookahead
                self.lookahead = Lookahead(self.params, self.bit_depth,
                                           self.device)
            from .aq import aq_offsets
            y = np.asarray(planes[0])
            coded = (y, np.asarray(planes[1]), np.asarray(planes[2]))
            off = aq_offsets(coded, self.params.aq_mode,
                             self.params.aq_strength, self.bit_depth,
                             normalize=self.params.rc_mode == 0)
            for la_out in self.lookahead.push(planes, off):
                self._la_frame = la_out[1:]
                self._gop_input(la_out[0])
        else:
            self._gop_input(planes)
        return self._drain(self.pipeline_depth)

    def flush(self) -> list:
        """Encode any queued frames (end of stream)."""
        if self.lookahead is not None:
            for la_out in self.lookahead.flush():
                self._la_frame = la_out[1:]
                self._gop_input(la_out[0])
        self._emit_minigop()
        return self._drain(0)

    def _drain(self, depth: int) -> list:
        out = []
        while len(self._inflight) > depth:
            out.append(self._finish_one(self._inflight.pop(0)))
        return out

    def _gop_input(self, planes) -> None:
        """GOP structuring of one display-order frame: dispatches device
        work; finished frames are drained by the caller."""
        p = self.params
        keyint = max(1, p.keyint_max)
        la = self._la_frame
        self._la_frame = None
        # lookahead scenecut: the lowres cost ratio decides before dispatch
        min_keyint = self._min_keyint()
        la_scenecut = (la is not None and la[2]
                       and p.scenecut_threshold > 0
                       and (self._display_idx - self._cvs_base)
                       >= min_keyint)
        gop_start = ((self._display_idx - self._cvs_base) % keyint == 0
                     or self.prev_anchor_poc is None
                     or self.force_all_intra
                     or la_scenecut)
        # inherited from the reference and kept so the streams stay equal:
        # when an IDR ends a pending mini-GOP, _emit_minigop below replaces
        # this anchor by the mini-GOP's, so the next trellis after the IDR
        # starts from that stale anchor
        if la is not None and (self.bframes == 0 or gop_start):
            self._anchor_low = la[3]
        if self.bframes == 0:
            poc = 0 if gop_start else self._next_poc
            kind = "I" if gop_start else "P"
            pend = self._dispatch_one(planes, poc, kind,
                                      l0_poc=self.prev_anchor_poc, la=la,
                                      didx=self._display_idx)
            if gop_start:
                self._cvs_base = self._display_idx
            self._after_anchor(pend, idr=pend.kind == "I")
            pend.display_idx = self._display_idx
            self._inflight.append(pend)
            self._display_idx += 1
            return
        if gop_start:
            self._emit_minigop()            # pending frames end their GOP
            self._cvs_base = self._display_idx  # before encode: display_idx
            pend = self._dispatch_one(planes, 0, "I", la=la)
            self._next_poc = 1
            self._after_anchor(pend, idr=True)
            pend.display_idx = self._cvs_base + pend.poc
            self._inflight.append(pend)
        else:
            self._queue.append((self._next_poc, planes, la))
            self._next_poc += 1
            if len(self._queue) == self.bframes + 1:
                if self.params.b_adapt > 0:
                    self._emit_minigop(count=self._slicetype_decide())
                else:
                    self._emit_minigop()
        self._display_idx += 1

    def _after_anchor(self, pf: _Pending, idr: bool = False) -> None:
        """DPB management after an anchor dispatch: the last ``num_ref``
        anchors form the L0 list, nearest first (Bs also need the previous
        anchor at ``ref`` 1)."""
        if idr:
            self.dpb.clear()
            self.dpb_dev.clear()
            self._ref_pocs = []
            self._next_poc = 1
        else:
            self._next_poc = max(self._next_poc, pf.poc + 1)
        keep = max(self.num_ref, 2 if self.bframes else 1)
        self._ref_pocs = [pf.poc] + [p for p in self._ref_pocs
                                     if p != pf.poc][:keep - 1]
        dpb = {pf.poc: pf}
        dpb_dev = {pf.poc: pf.ext} if pf.ext is not None else {}
        for p in self._ref_pocs[1:]:
            if p in self.dpb:
                dpb[p] = self.dpb[p]
            if p in self.dpb_dev:
                dpb_dev[p] = self.dpb_dev[p]
        self.dpb, self.dpb_dev = dpb, dpb_dev
        self.prev_anchor_poc = pf.poc

    def _emit_minigop(self, count=None) -> None:
        """Dispatch the queued mini-GOP: its last frame as the P anchor
        first, then the Bs against their reference pair.  With b-pyramid
        (>= 2 Bs) the middle B is coded first against (previous anchor, new
        anchor) and becomes a reference (TRAIL_R); the outer Bs predict
        from the half-distance pairs.  Without it all Bs are TRAIL_N
        against the anchors."""
        if not self._queue:
            return
        if count is None:
            frames, self._queue = self._queue, []
        else:
            frames = self._queue[:count]
            self._queue = self._queue[count:]
        anchor_poc, anchor_planes, anchor_la = frames[-1]
        if anchor_la is not None:
            self._anchor_low = anchor_la[3]
        l0 = self.prev_anchor_poc
        base = self._cvs_base
        pend = self._dispatch_one(anchor_planes, anchor_poc,
                                  "P" if l0 is not None else "I", l0_poc=l0,
                                  la=anchor_la, didx=base + anchor_poc)
        pend.display_idx = base + anchor_poc
        self._inflight.append(pend)
        self._after_anchor(pend)        # retains prev anchor for the Bs
        bs = frames[:-1]
        if self.b_pyramid and len(bs) >= 2:
            mid_i = len(bs) // 2
            mpoc, mplanes, mla = bs[mid_i]
            mp = self._dispatch_one(mplanes, mpoc, "B", l0_poc=l0,
                                    l1_poc=anchor_poc, la=mla,
                                    ref_b=True, didx=base + mpoc)
            mp.display_idx = base + mpoc
            self._inflight.append(mp)
            self.dpb[mpoc] = mp
            if mp.ext is not None:
                self.dpb_dev[mpoc] = mp.ext
            for group, g_l0, g_l1 in (
                    (bs[:mid_i], l0, mpoc),
                    (bs[mid_i + 1:], mpoc, anchor_poc)):
                self._dispatch_b_group(group, g_l0, g_l1, base,
                                       keep_extra=(mpoc,))
            return
        self._dispatch_b_group(bs, l0, anchor_poc, base)

    def _dispatch_b_group(self, bs, l0, l1, base, keep_extra=()):
        """Dispatch a set of mutually independent TRAIL_N Bs sharing one
        (l0, l1) reference pair, batched when >= 2."""
        if not bs:
            return
        if len(bs) >= 2:
            pends = []
            for poc, planes, la in bs:
                bp = self._dispatch_one(planes, poc, "B", l0_poc=l0,
                                        l1_poc=l1, la=la, defer_b=True,
                                        didx=base + poc)
                bp.display_idx = base + poc
                bp.ps.rps_keep = tuple(set(bp.ps.rps_keep)
                                       | set(keep_extra))
                pends.append(bp)
            self._dispatch_b_batch(pends, l0, l1)
            self._inflight.extend(pends)
        else:
            for poc, planes, la in bs:
                bp = self._dispatch_one(planes, poc, "B", l0_poc=l0,
                                        l1_poc=l1, la=la,
                                        didx=base + poc)
                bp.display_idx = base + poc
                bp.ps.rps_keep = tuple(set(bp.ps.rps_keep)
                                       | set(keep_extra))
                self._inflight.append(bp)

    def _slicetype_decide(self) -> int:
        """Adaptive B placement (b-adapt): a trellis over the queued
        display-order window.  Every segmentation of the window is scored
        as its anchor's lowres P cost plus each B's min(intra, list0,
        list1, bidir-average) cost, with the b-pyramid's reference pairs;
        the cheapest path picks the first mini-GOP's length.  Returns the
        queue prefix length to emit (#Bs + 1 anchor); without the lookahead
        (no lowres costs) the whole queue."""
        la = self.lookahead
        m = len(self._queue)
        if la is None:
            return m
        lows = [e[2][3] for e in self._queue]
        # id()-keyed pair costs of dead frames must not alias new objects:
        # a fresh cache per decision, whose frames are all alive
        la._pair_cache.clear()
        anchors = [self._anchor_low] + lows
        inf = float("inf")
        best = [inf] * (m + 1)
        best[m] = 0.0
        choice = [m - 1] * (m + 1)
        for i in range(m - 1, -1, -1):
            a = anchors[i]
            for k in range(i, min(i + self.bframes, m - 1) + 1):
                c = la.p_cost(lows[k], a) + best[k + 1]
                # B reference pairs as dispatched: with b-pyramid and >= 2
                # Bs the middle B refs (a, anchor), the outer Bs the
                # half-distance pairs
                nb = k - i
                if self.b_pyramid and nb >= 2:
                    mid = i + nb // 2
                    pairs = [(j, a, lows[mid]) if j < mid
                             else (j, lows[mid], lows[k])
                             for j in range(i, k) if j != mid]
                    pairs.append((mid, a, lows[k]))
                else:
                    pairs = [(j, a, lows[k]) for j in range(i, k)]
                for j, r0, r1 in pairs:
                    if c >= best[i]:
                        break
                    c += la.bidir_cost(lows[j], r0, r1)
                if c < best[i]:
                    best[i] = c
                    choice[i] = k
        return choice[0] + 1

    def _qp_override(self, didx):
        if didx is None:
            return None
        q = self._qpfile_map.get(didx)
        if q is not None:
            return min(51, max(0, q))
        for (s, e, qv, fac) in self._zones:
            if s <= didx <= e:
                if qv is not None:
                    return min(51, max(0, qv))
                if fac:
                    return min(51, max(0, round(
                        self.qp - 6.0 * np.log2(fac))))
        return None

    def _dispatch_one(self, planes, poc: int, kind: str, l0_poc=None,
                      l1_poc=None, la=None, cplx=None, defer_b: bool = False,
                      ref_b: bool = False, didx=None,
                      defer_all: bool = False):
        """Run one picture's device work and return its _Pending (a
        deferred B only stashes its inputs: ``_dispatch_b_batch`` runs
        them; with ``defer_all`` any picture only stashes them, for an
        outside batcher such as ``parallel.gop``)."""
        g = self.geom
        p = self.params
        ph = g.ctbs_h << g.log2_ctb
        pw = g.ctbs_w << g.log2_ctb
        orig = (pad_plane(np.asarray(planes[0]), ph, pw),
                pad_plane(np.asarray(planes[1]), ph // 2, pw // 2),
                pad_plane(np.asarray(planes[2]), ph // 2, pw // 2))
        if kind != "I" and (self.force_all_intra or l0_poc is None):
            kind = "I"
            poc = 0
        is_p = kind == "P"
        is_b = kind == "B"
        # frame complexity for rate control: the lowres lookahead cost when
        # the window is active, else the inline half-res estimate
        if cplx is None:
            if la is not None and la[1]:
                cplx = float(la[1])
            else:
                cplx = self._complexity_estimate(orig, kind != "I")
        self._la_off16 = la[0] if la is not None else None
        self.qp = self.rc.frame_qp(is_intra=kind == "I", satd=cplx,
                                   is_b=is_b, is_ref_b=ref_b)
        ov = self._qp_override(didx)
        if ov is not None:
            self.qp = int(ov)

        cu_size = min(16, 1 << g.log2_ctb)
        cu_log2 = cu_size.bit_length() - 1
        ps = PicSyntax(
            g, max_tr_depth_intra=self.sps.max_transform_hierarchy_depth_intra,
            max_tr_depth_inter=self.sps.max_transform_hierarchy_depth_inter,
            sign_hiding=bool(self.pps.sign_data_hiding),
            slice_qp=self.qp, cu_qp_delta_enabled=self.aq)
        ps.depth[:] = g.log2_ctb - cu_log2
        ps.pred_mode[:] = MODE_INTRA
        ps.tu_depth[:] = 0
        self._qp_plan(orig)

        ps.cur_poc = poc
        if is_p and l0_poc is not None:
            active = [q for q in self._ref_pocs if q < poc]
            if l0_poc not in active:
                active = [l0_poc] + active
            ps.ref_pocs_l0 = tuple(active[:self.num_ref])
        else:
            ps.ref_pocs_l0 = (l0_poc,) if l0_poc is not None else ()
        ps.ref_pocs_l1 = (l1_poc,) if l1_poc is not None else ()
        # every picture the DPB must keep past this frame (for Bs also the
        # already-dispatched next anchor)
        ps.rps_keep = tuple(self._ref_pocs)

        pend = _Pending(poc=poc, kind=kind, qp=self.qp, ps=ps,
                        display_idx=0, planes=planes, orig=orig,
                        l0_poc=l0_poc, l1_poc=l1_poc, cu_size=cu_size)
        if p.weightp and kind != "B":
            self._wp_src[poc] = np.asarray(planes[0])
            while len(self._wp_src) > 4:
                self._wp_src.pop(next(iter(self._wp_src)))
        ref_src = self._wp_src.get(l0_poc) if is_p and p.weightp else None
        if ref_src is not None and ref_src.shape == np.asarray(
                planes[0]).shape:
            from .weights import analyse_luma_weight
            pend.wp = analyse_luma_weight(np.asarray(planes[0]), ref_src,
                                          self.bit_depth)
        ps.wp_entry = pend.wp
        if p.lossless:
            pend.rec = self._encode_lossless(ps, orig)
            return pend
        if defer_all:
            # the batcher stacks the device inputs of several encoders
            pend.qp_arrays = self._qp_arrays
            pend.filter_qps = self._filter_qps()
        elif is_b:
            ps.b_is_ref = ref_b         # TRAIL_R
            if defer_b:
                # batched mini-GOP dispatch: _dispatch_b_batch stacks these
                pend.qp_arrays = self._qp_arrays
                pend.filter_qps = self._filter_qps()
            elif ref_b:
                pend.out_dev, pend.ext = self._dispatch_b_ref(
                    orig, l0_poc, l1_poc)
            else:
                pend.out_dev = self._dispatch_b(orig, l0_poc, l1_poc)
        elif is_p:
            pend.out_dev, pend.ext = self._dispatch_p(
                orig, ps.ref_pocs_l0, pend.wp)
            pend.allow_scenecut = bool(p.scenecut_threshold
                                       and self.bframes == 0
                                       and not self._use_lookahead)
        else:
            pend.out_dev, pend.ext = self._dispatch_i(orig)
        return pend

    def _finish_one(self, pend: _Pending) -> EncodedFrame:
        """Host finish: fetch, scatter syntax, derive inter syntax,
        entropy-code, hash SEI, rate control."""
        p = self.params
        self.qp = pend.qp
        ps = pend.ps
        kind = pend.kind
        is_p = kind == "P"
        is_b = kind == "B"
        poc = pend.poc
        keyint = max(1, p.keyint_max)
        if pend.out_dev is None:
            o = None
        elif is_b:
            o = self._finish_b(pend)
        elif is_p:
            o = self._finish_p(pend)
            cost_p, cost_i = self.last_frame_costs
            if (pend.allow_scenecut and not self._inflight
                    and cost_p > 0.85 * cost_i
                    and poc % keyint >= self._min_keyint()):
                # scene change: restart the GOP with an IDR
                redo = self._dispatch_one(pend.planes, 0, "I", cplx=0.0)
                redo.display_idx = pend.display_idx
                self._cvs_base = pend.display_idx
                self._after_anchor(redo, idr=True)
                return self._finish_one(redo)
        else:
            o = self._finish_i(pend)
        if o is None:
            # lossless: the recon is the source; no loop filter runs
            checksums = None
            cw, ch_ = self.sps.pic_width, self.sps.pic_height
            rec = pend.rec
            coded_rec = (rec[0][:ch_, :cw], rec[1][:ch_ // 2, :cw // 2],
                         rec[2][:ch_ // 2, :cw // 2])
            cl, cr, ct, cb = self.sps.conf_win
            wl = cw - 2 * (cl + cr)
            hl = ch_ - 2 * (ct + cb)
            rec_crop = (
                coded_rec[0][2 * ct:2 * ct + hl, 2 * cl:2 * cl + wl],
                coded_rec[1][ct:ct + hl // 2, cl:cl + wl // 2],
                coded_rec[2][ct:ct + hl // 2, cl:cl + wl // 2])
        else:
            checksums = o["checksums"]
            tails = pend.out_dev[1]
            coded_rec = tails["rec_coded"]
            rec_crop = tails["rec_conf"]
            k = pend.batch_idx
            if k is not None:
                coded_rec = tuple(pl[k] for pl in coded_rec)
                rec_crop = tuple(pl[k] for pl in rec_crop)
            rec_crop = tuple(to_host_samples(pl) for pl in rec_crop)

        st = SLICE_B if is_b else SLICE_P if is_p else SLICE_I
        au = self._entropy_encode(ps, st, poc)
        if self.dpb.get(poc) is pend:
            self.dpb[poc] = coded_rec

        if p.decoded_picture_hash:
            if (p.decoded_picture_hash == HASH_CHECKSUM
                    and checksums is not None):
                payload = bytes([2]) + b"".join(
                    int(c).to_bytes(4, "big") for c in checksums)
            else:
                payload = picture_hash_payload(
                    [pl if o is None else to_host_samples(pl)
                     for pl in coded_rec], self.bit_depth,
                    hash_type=p.decoded_picture_hash - 1)
            sei = write_sei_rbsp([(SEI_DECODED_PICTURE_HASH, payload)])
            au += wrap_nal(NAL_SUFFIX_SEI, sei, long_start_code=False)

        if self.hrd:
            # prefix SEI NAL: buffering-period on IRAP AUs + pic-timing
            # on every AU
            sps = self.sps
            order = self.frames_encoded
            msgs = []
            if kind == "I":
                # hrdFullness: the 90 kHz delay from the CPB fill that the
                # rate control tracks
                fill = int(self.rc.buffer_fill)
                dly = (90000 * fill + self._hrd_bitrate_unscale) \
                    // self._hrd_bitrate_unscale
                off = (90000 * self._hrd_cpb_unscale
                       + self._hrd_bitrate_unscale) \
                    // self._hrd_bitrate_unscale - dly
                msgs.append((SEI_BUFFERING_PERIOD,
                             buffering_period_payload(sps, dly, off)))
                self._last_bp_order = order
                self._cvs_finish_base = order
            rem = min(max(1, order - self._last_bp_order),
                      1 << sps.hrd_cpb_removal_len)
            out_delay = max(0, sps.num_reorder_pics + poc
                            - (order - self._cvs_finish_base))
            msgs.append((SEI_PIC_TIMING,
                         pic_timing_payload(sps, rem, out_delay)))
            # inherited from the reference and kept so the streams stay
            # equal: a 3-byte start code, though the NAL opens the AU
            au = wrap_nal(NAL_PREFIX_SEI, write_sei_rbsp(msgs),
                          long_start_code=False) + au

        if p.repeat_headers and kind == "I" and self.frames_encoded > 0:
            au = self.headers() + au
        if p.aud:
            bw = BitWriter()
            bw.write(2 if is_b else 1 if is_p else 0, 3)
            bw.rbsp_trailing_bits()
            au = wrap_nal(NAL_AUD, bw.getvalue(),
                          long_start_code=True) + au
        self.rc.update(len(au) * 8, self.qp, is_intra=kind == "I")
        self.frames_encoded += 1
        self.last_slice_type_str = "B" if is_b else "P" if is_p else "I"
        self.last_ps = ps
        self._perf["frames"] += 1
        self._perf["bytes"] += len(au)
        self._perf["qp_sum"] += self.qp
        self._perf["by_type"][self.last_slice_type_str] += 1
        return EncodedFrame(poc=poc, display_idx=pend.display_idx, au=au,
                            recon=rec_crop, coded=coded_rec,
                            kind=self.last_slice_type_str, qp=self.qp,
                            stats=_frame_cu_stats(ps))

    # -- device pipelines ----------------------------------------------------

    def _get_ctu_scan(self):
        if self._ctu_scan is None:
            from .ctu_scan import CtuScan
            self._ctu_scan = CtuScan(
                self.geom, bit_depth=self.bit_depth,
                sign_hide=bool(self.pps.sign_data_hiding),
                strong_intra_smoothing=bool(
                    self.sps.strong_intra_smoothing),
                rdoq=self.params.rdoq_level > 0,
                noise_reduction=self._nr_enabled,
                psy_rd=self.params.psy_rd,
                psy_rdoq=self.params.psy_rdoq)
        return self._ctu_scan

    def _nr_update(self, o):
        """Noise-reduction running-average update from the frame's
        fetched |DCT coef| sums (frameencoder.cpp:1331
        noiseReductionUpdate, incl. the halving cap and the
        don't-denoise-DC rule)."""
        p = self.params
        max_blocks = {4: 1 << 18, 8: 1 << 16, 16: 1 << 14, 32: 1 << 12}
        for cat, (nn, size) in self._nr_sizes.items():
            key = "nr_" + cat
            if key not in o:
                continue
            v = np.asarray(o[key]).astype(np.int64)
            si, ci = v[:nn], int(v[nn])
            sp, cp = v[nn + 1:2 * nn + 1], int(v[2 * nn + 1])
            for sfx, s_, c_ in (("_i", si, ci), ("_p", sp, cp)):
                st = self._nr_state[cat + sfx]
                st[0] += s_
                st[1] += c_
                if st[1] > max_blocks[size]:
                    st[0] >>= 1
                    st[1] >>= 1
                strength = (p.noise_reduction_intra if sfx == "_i"
                            else p.noise_reduction_inter)
                num = strength * st[1] + st[0] // 2
                off = (num // (st[0] + 1)).astype(np.int32)
                off[0] = 0               # never denoise DC
                self._nr_offsets[cat + sfx] = off

    def _nr_args(self) -> dict:
        """The dispatch's noise-reduction offsets (those current now: the
        scan reads them at the call, and ``_nr_update`` replaces entries)."""
        return dict(nr_offsets=self._nr_offsets if self._nr_enabled
                    else None)

    def _fetch_outputs(self, pend):
        """Fetch the frame's small outputs (one packed copy, shared by the
        frames of a batched B dispatch); returns the host dict and the
        (luma, cb, cr) coefficient planes."""
        t0 = self._clock()
        small = pend.out_dev[0]
        k = pend.batch_idx
        if isinstance(small, _BatchFetch):
            f = small.fetch()
            o = f if k is None else {key: v[k] for key, v in f.items()}
        else:
            o = fetch_packed(small)
        self._perf["fetch_wait"] += self._clock() - t0
        if self._nr_enabled:
            self._nr_update(o)
        return o, (o["cy"], o["ccb"], o["ccr"])

    def _scatter_syntax(self, ps, o, coeffs):
        cy, ccb, ccr = coeffs
        ps.coeff_y[:] = cy.astype(np.int32)
        ps.coeff_cb[:] = ccb.astype(np.int32)
        ps.coeff_cr[:] = ccr.astype(np.int32)
        ps.qp_ctb[:] = o["qp_actual"].astype(np.int32)
        if self.sps.sao_enabled:
            ps.sao_type[:] = o["sao_type"].astype(np.int8)
            ps.sao_eo_class[:] = o["sao_class"].astype(np.int8)
            ps.sao_band_pos[:] = o["sao_bpos"].astype(np.int8)
            ps.sao_offsets[:] = o["sao_offs"].astype(np.int8)

    def _apply_inter_merge(self, ps, o):
        """Merged inter CUs (32/64) from the device masks; quads whose
        in-scan RD chose TU32 code TU == CU."""
        g = self.geom
        m32 = np.asarray(o["m32"]) if o.get("m32") is not None else None
        m64 = np.asarray(o["m64"]) if o.get("m64") is not None else None
        tu32 = None
        if m32 is not None and o.get("use32") is not None:
            u = np.asarray(o["use32"]).reshape(m32.shape)
            m64r = (np.repeat(np.repeat(
                m64, m32.shape[0] // m64.shape[0], 0),
                m32.shape[1] // m64.shape[1], 1)
                if m64 is not None else np.zeros(m32.shape, bool))
            tu32 = u & (m32 | m64r)
        if m32 is not None and m32.any():
            u8 = np.kron(m32, np.ones((8, 8), bool))
            ps.depth[u8] = g.log2_ctb - 5
            ps.tu_depth[u8] = 1
        if m64 is not None and m64.any():
            u16 = np.kron(m64, np.ones((16, 16), bool))
            ps.depth[u16] = g.log2_ctb - 6
            ps.tu_depth[u16] = 2
        if tu32 is not None and tu32.any():
            t8 = np.kron(tu32, np.ones((8, 8), bool))
            ps.tu_depth[t8] -= 1

    def _apply_cu32(self, ps, use32, mode32):
        """Chosen 32x32 intra CUs: one depth-(log2_ctb-5) CU with a 32x32
        luma TU and the 32-mode (DM chroma)."""
        if use32 is None or not use32.any():
            return
        g = self.geom
        d32 = g.log2_ctb - 5
        u8 = np.kron(use32, np.ones((8, 8), bool))
        m8 = np.kron(mode32.astype(np.uint8), np.ones((8, 8), np.uint8))
        ps.depth[u8] = d32
        ps.luma_mode[u8] = m8[u8]
        ps.chroma_mode[u8] = m8[u8]
        ps.tu_depth[u8] = 0
        ps.part[u8] = 0

    def _filter_qps(self):
        dq_cb = chroma_qp(self.qp, self.pps.cb_qp_offset)
        dq_cr = chroma_qp(self.qp, self.pps.cr_qp_offset)
        sao_lam = 0.72 * 2.0 ** ((self.qp - 12) / 3.0)
        return (np.int32(self.qp), np.int32(dq_cb), np.int32(dq_cr),
                np.float32(sao_lam))

    def _qp_plan(self, orig):
        """Per-CTB desired QPs + SSD-domain lambdas (frame QP + AQ, or the
        lookahead's AQ + cuTree offsets when it gave them)."""
        g = self.geom
        p = self.params
        bd_off = 6 * (self.bit_depth - 8)
        if self.aq:
            from .aq import aq_offsets, per_ctb_qp
            off16 = self._la_off16
            if off16 is None:
                cw, ch = self.sps.pic_width, self.sps.pic_height
                coded = (orig[0][:ch, :cw], orig[1][:ch // 2, :cw // 2],
                         orig[2][:ch // 2, :cw // 2])
                off16 = aq_offsets(coded, p.aq_mode, p.aq_strength,
                                   self.bit_depth, normalize=p.rc_mode == 0)
            qp_ctb = per_ctb_qp(np.asarray(off16), self.qp, g)
        else:
            qp_ctb = np.full((g.n_ctbs,), self.qp, np.int32)
        lam = 2.0 ** (qp_ctb / 6.0 - 2.0)
        self._qp_arrays = (
            (qp_ctb + bd_off).astype(np.int32),
            (_chroma_qp_arr(qp_ctb, self.pps.cb_qp_offset)
             + bd_off).astype(np.int32),
            (_chroma_qp_arr(qp_ctb, self.pps.cr_qp_offset)
             + bd_off).astype(np.int32),
            (0.85 * lam * lam).astype(np.float32),
            qp_ctb.astype(np.int32))

    def _dev(self, a):
        return to_device(a, self.device)

    def _dispatch_i(self, orig):
        from .device_pipeline import build_i_pipeline
        if self._i_pipeline is None:
            self._i_pipeline = build_i_pipeline(self)
        qpy, qpb, qpr, lam, qp_ctb = (self._dev(a) for a in self._qp_arrays)
        qp_base, dq_cb, dq_cr, sao_lam = self._filter_qps()
        small, tails, ext = self._i_pipeline(
            *(self._dev(pl) for pl in orig), qpy, qpb, qpr, lam,
            int(qp_base), int(dq_cb), int(dq_cr), float(sao_lam), qp_ctb,
            **self._nr_args())
        return (small, tails), ext

    def _finish_i(self, pend):
        ps = pend.ps
        o, coeffs = self._fetch_outputs(pend)
        g = self.geom
        ph = g.ctbs_h << g.log2_ctb
        pw = g.ctbs_w << g.log2_ctb
        gh, gw = ph // 16, pw // 16
        modes = o["modes"].reshape(gh, gw)
        s4 = pend.cu_size // 4
        ps.luma_mode[:] = np.kron(modes.astype(np.uint8),
                                  np.ones((s4, s4), np.uint8))
        ps.chroma_mode[:] = ps.luma_mode
        if self._get_ctu_scan().t["has32"]:
            use32 = o["use32"].reshape(ph // 32, pw // 32)
            mode32 = o["mode32"].reshape(ph // 32, pw // 32)
            self._apply_cu32(ps, use32, mode32)
        self._scatter_syntax(ps, o, coeffs)
        return o

    def _get_ref_ext(self, poc):
        return self.dpb_dev[poc]

    def _dispatch_p(self, orig, ref_pocs, wp=(64, 0, False)):
        """The P pipeline runs with a FIXED ``num_ref`` reference slots; a
        shorter list repeats its farthest entry (padding slots can never
        win the ref_idx argmin)."""
        from .device_pipeline import build_p_pipeline
        if self._p_pipeline is None:
            self._p_pipeline = build_p_pipeline(self, nr=self.num_ref)
        pocs = list(ref_pocs)
        pocs = pocs + [pocs[-1]] * (self.num_ref - len(pocs))
        refs = [self._get_ref_ext(q) for q in pocs]
        qpy, qpb, qpr, lam, qp_ctb = (self._dev(a) for a in self._qp_arrays)
        qp_base, dq_cb, dq_cr, sao_lam = self._filter_qps()
        small, tails, ext = self._p_pipeline(
            *(self._dev(pl) for pl in orig),
            tuple(r[0] for r in refs), tuple(r[1] for r in refs),
            tuple(r[2] for r in refs),
            qpy, qpb, qpr, lam, int(qp_base), int(dq_cb), int(dq_cr),
            float(sao_lam), qp_ctb, np.asarray(pocs, np.int32),
            int(wp[0]), int(wp[1]), n_act=len(ref_pocs), **self._nr_args())
        return (small, tails), ext

    def _finish_p(self, pend):
        ps = pend.ps
        g = self.geom
        n = cu_size = pend.cu_size
        ph = g.ctbs_h << g.log2_ctb
        pw = g.ctbs_w << g.log2_ctb
        o, coeffs = self._fetch_outputs(pend)
        self.last_frame_costs = (float(o["cost_p"]), float(o["cost_i"]))
        gh, gw = (ph // cu_size, pw // cu_size)
        modes = o["modes"].reshape(gh, gw)
        mv = o["mv"].reshape(gh, gw, 2)
        inter_mask = o["inter"].reshape(gh, gw)
        s4 = n // 4
        ps.luma_mode[:] = np.kron(modes.astype(np.uint8),
                                  np.ones((s4, s4), np.uint8))
        ps.chroma_mode[:] = ps.luma_mode
        pm = np.where(inter_mask, MODE_INTER, MODE_INTRA).astype(np.uint8)
        ps.pred_mode[:] = np.kron(pm, np.ones((s4, s4), np.uint8))
        ps.mv0[:] = np.kron(
            mv.astype(np.int16).transpose(2, 0, 1),
            np.ones((1, s4, s4), np.int16)).transpose(1, 2, 0)
        rsel = np.asarray(o["ref_idx"]).reshape(gh, gw)
        ps.ref_idx0[:] = np.kron(rsel.astype(ps.ref_idx0.dtype),
                                 np.ones((s4, s4), ps.ref_idx0.dtype))
        ps.ref_idx0[ps.pred_mode == MODE_INTRA] = 0
        if self._get_ctu_scan().t["has32"]:
            use32 = self._intra32_mask(o).reshape(ph // 32, pw // 32)
            mode32 = o["mode32"].reshape(ph // 32, pw // 32)
            self._apply_cu32(ps, use32, mode32)
        self._apply_inter_merge(ps, o)
        self._scatter_syntax(ps, o, coeffs)
        self._derive_inter_all(ps)
        return o

    def _b_inputs(self, orig, l0_poc, l1_poc):
        """The device inputs of a single B dispatch, in the pipeline's
        argument order."""
        refs0 = self._get_ref_ext(l0_poc)
        refs1 = self._get_ref_ext(l1_poc)
        qpy, qpb, qpr, lam, qp_ctb = (self._dev(a) for a in self._qp_arrays)
        qp_base, dq_cb, dq_cr, sao_lam = self._filter_qps()
        return ((*(self._dev(pl) for pl in orig), *refs0, *refs1, qpy, qpb,
                 qpr, lam, int(qp_base), int(dq_cb), int(dq_cr),
                 float(sao_lam), int(l0_poc), int(l1_poc), qp_ctb))

    def _dispatch_b(self, orig, l0_poc, l1_poc):
        """A non-reference B: both list searches, the bi trial, the scan
        and the filters on the device."""
        from .device_pipeline import build_b_pipeline
        if self._b_pipeline is None:
            self._b_pipeline = build_b_pipeline(self)
        small, tails, _ = self._b_pipeline(
            *self._b_inputs(orig, l0_poc, l1_poc), **self._nr_args())
        return (small, tails)

    def _dispatch_b_ref(self, orig, l0_poc, l1_poc):
        """The b-pyramid's reference B: the same program plus the DPB
        extension."""
        from .device_pipeline import build_b_pipeline
        if self._b_ref_pipeline is None:
            self._b_ref_pipeline = build_b_pipeline(self, make_ext=True)
        small, tails, ext = self._b_ref_pipeline(
            *self._b_inputs(orig, l0_poc, l1_poc), **self._nr_args())
        return (small, tails), ext

    def _dispatch_b_batch(self, pends, l0_poc, l1_poc):
        """One batched device dispatch for the mutually independent TRAIL_N
        Bs of a mini-GOP (a leading frame dimension: one K2 launch per
        list and one K1 launch per scan level for all of them)."""
        from .device_pipeline import build_b_pipeline
        F = len(pends)
        pipe = self._b_batch_pipelines.get(F)
        if pipe is None:
            pipe = self._b_batch_pipelines[F] = build_b_pipeline(
                self, batch=F)
        refs0 = self._get_ref_ext(l0_poc)
        refs1 = self._get_ref_ext(l1_poc)
        orig = [self._dev(np.stack([p.orig[i] for p in pends]))
                for i in range(3)]
        qs = [self._dev(np.stack([p.qp_arrays[i] for p in pends]))
              for i in range(5)]
        fq = [np.stack([p.filter_qps[i] for p in pends]) for i in range(4)]
        small, tails, _ = pipe(
            *orig, *refs0, *refs1, qs[0], qs[1], qs[2], qs[3], fq[0],
            fq[1], fq[2], fq[3], int(l0_poc), int(l1_poc), qs[4],
            **self._nr_args())
        handle = _BatchFetch(small)
        for k, p in enumerate(pends):
            p.out_dev = (handle, tails)
            p.batch_idx = k

    def _finish_b(self, pend):
        """Scatter the fetched B outputs into PicSyntax and derive the
        merge/AMVP syntax."""
        ps = pend.ps
        g = self.geom
        n = cu_size = pend.cu_size
        ph = g.ctbs_h << g.log2_ctb
        pw = g.ctbs_w << g.log2_ctb
        o, coeffs = self._fetch_outputs(pend)
        gh, gw = (ph // cu_size, pw // cu_size)
        modes = o["modes"].reshape(gh, gw)
        mv0 = o["mv0"].reshape(gh, gw, 2)
        mv1 = o["mv1"].reshape(gh, gw, 2)
        dirs = o["dirs"].reshape(gh, gw)
        inter_mask = o["inter"].reshape(gh, gw)
        s4 = n // 4
        ps.luma_mode[:] = np.kron(modes.astype(np.uint8),
                                  np.ones((s4, s4), np.uint8))
        ps.chroma_mode[:] = ps.luma_mode
        pm = np.where(inter_mask, MODE_INTER, MODE_INTRA).astype(np.uint8)
        ps.pred_mode[:] = np.kron(pm, np.ones((s4, s4), np.uint8))

        def rep(a):
            return np.kron(a.astype(np.int16).transpose(2, 0, 1),
                           np.ones((1, s4, s4), np.int16)).transpose(1, 2, 0)

        ps.mv0[:] = rep(mv0)
        ps.mv1[:] = rep(mv1)
        # uni blocks keep zeros in the unused list (normative neighbor state)
        d_eff = np.where(inter_mask, dirs, 1).astype(np.uint8)
        ps.inter_dir[:] = np.kron(d_eff, np.ones((s4, s4), np.uint8))
        ps.mv0[ps.inter_dir == 2] = 0
        ps.mv1[ps.inter_dir == 1] = 0
        if self._get_ctu_scan().t["has32"]:
            use32 = self._intra32_mask(o).reshape(ph // 32, pw // 32)
            mode32 = o["mode32"].reshape(ph // 32, pw // 32)
            self._apply_cu32(ps, use32, mode32)
        self._apply_inter_merge(ps, o)
        self._scatter_syntax(ps, o, coeffs)
        self._derive_inter_all(ps)
        return o

    @staticmethod
    def _intra32_mask(o):
        """sel32 minus the inter-TU32 quads (merged inter CUs)."""
        u = np.asarray(o["use32"])
        m32 = o.get("m32")
        if m32 is None:
            return u
        m32 = np.asarray(m32)
        m64 = o.get("m64")
        m64r = (np.repeat(np.repeat(np.asarray(m64),
                                    m32.shape[0] // np.asarray(m64).shape[0],
                                    0),
                          m32.shape[1] // np.asarray(m64).shape[1], 1)
                if m64 is not None else np.zeros(m32.shape, bool))
        return u.reshape(m32.shape) & ~(m32 | m64r)

    # -- P-frame syntax derivation -------------------------------------------

    def _derive_inter_all(self, ps):
        """Merge/AMVP/skip derivation over all inter CU leaves (native C);
        TMVP col picture attached here, in entropy order."""
        if self.params.temporal_mvp and ps.ref_pocs_l0 and ps.col is None:
            col = self._col_store.get(ps.ref_pocs_l0[0])
            if col is not None:
                ps.temporal_mvp = True
                ps.col = col
        derive_inter_syntax_native(ps)

    def _store_col_motion(self, ps, poc: int) -> None:
        """Retain this picture's final motion field for TMVP."""
        pocs0 = np.asarray(ps.ref_pocs_l0 or (0,), np.int32)
        pocs1 = np.asarray(ps.ref_pocs_l1 or (0,), np.int32)
        r0 = np.minimum(ps.ref_idx0.astype(np.int32), len(pocs0) - 1)
        r1 = np.minimum(ps.ref_idx1.astype(np.int32), len(pocs1) - 1)
        self._col_store[poc] = dict(
            pred_mode=ps.pred_mode.copy(),
            inter_dir=ps.inter_dir.copy(),
            mv0=ps.mv0.copy(), mv1=ps.mv1.copy(),
            poc0=pocs0[r0], poc1=pocs1[r1], poc=poc)
        while len(self._col_store) > 8:
            self._col_store.pop(next(iter(self._col_store)))

    def _entropy_encode(self, ps: PicSyntax, slice_type: int = SLICE_I,
                        poc: int = 0) -> bytes:
        t0 = self._clock()
        if self.params.temporal_mvp:
            if slice_type == SLICE_I:
                self._col_store.clear()
            self._store_col_motion(ps, poc)

        sao_on = bool(self.sps.sao_enabled)
        if slice_type == SLICE_I:
            sh = SliceHeader(slice_type=SLICE_I, slice_qp=self.qp,
                             sao_luma=int(sao_on), sao_chroma=int(sao_on))
            nal_type = NAL_IDR_W_RADL
        else:
            keep = set(getattr(ps, "rps_keep", ()))
            act0 = [q for q in ps.ref_pocs_l0 if q is not None]
            act1 = [q for q in ps.ref_pocs_l1 if q is not None]
            s0_pocs = sorted({q for q in keep if q < poc} | set(act0),
                             reverse=True)
            s1_pocs = sorted({q for q in keep if q > poc} | set(act1))
            if not s0_pocs:
                s0_pocs = [poc - 1]
            rps = ShortTermRPS(
                delta_pocs_s0=[q - poc for q in s0_pocs],
                used_s0=[1 if q in act0 else 0 for q in s0_pocs],
                delta_pocs_s1=[q - poc for q in s1_pocs],
                used_s1=[1 if q in act1 else 0 for q in s1_pocs])
            if slice_type == SLICE_B:
                # b-pyramid reference Bs are TRAIL_R, the other Bs TRAIL_N
                nal_type = (NAL_TRAIL_R if getattr(ps, "b_is_ref", False)
                            else NAL_TRAIL_N)
            else:
                nal_type = NAL_TRAIL_R
            sh = SliceHeader(
                slice_type=slice_type, slice_qp=self.qp,
                sao_luma=int(sao_on), sao_chroma=int(sao_on),
                pic_order_cnt_lsb=poc % (1 << self.sps.log2_max_poc_lsb),
                rps=rps, max_num_merge_cand=ps.max_merge_cand,
                temporal_mvp_enabled=int(getattr(ps, "temporal_mvp",
                                                 False)))
            n0 = max(1, len(act0))
            sh.num_ref_idx_l0 = n0
            if n0 != self.pps.num_ref_idx_l0_default:
                sh.num_ref_idx_active_override = 1
            if self.pps.weighted_pred and slice_type == SLICE_P:
                w, o, on = getattr(ps, "wp_entry", (64, 0, False))
                sh.luma_log2_weight_denom = 6
                sh.chroma_log2_weight_denom = 6
                sh.weights_l0 = ([(int(bool(on)), w, o, 0, 64, 0, 64, 0)]
                                 + [(0, 64, 0, 0, 64, 0, 64, 0)]
                                 * (n0 - 1))
        bw = write_slice_header(sh, self.sps, self.pps, nal_type)

        data = encode_slice_data_native(
            ps, self.qp, log2_min_cb=self.sps.log2_min_cb_size,
            log2_min_tb=self.sps.log2_min_tb_size,
            log2_max_tb=self.sps.log2_max_tb_size,
            slice_type=(2 if slice_type == SLICE_I
                        else 0 if slice_type == SLICE_B else 1),
            sao_luma=sao_on, sao_chroma=sao_on,
            bit_depth=self.bit_depth,
            num_ref_l0=max(1, len(ps.ref_pocs_l0)),
            num_ref_l1=max(1, len(ps.ref_pocs_l1))
            if slice_type == SLICE_B else 1,
            transquant_bypass=bool(self.pps.transquant_bypass_enabled))
        rbsp = bw.getvalue() + data
        self._perf["entropy"] += self._clock() - t0
        return wrap_nal(nal_type, rbsp)

    def summary(self) -> str:
        """Encode summary (x265 printSummary): frame counts by type,
        average QP, bitrate and wall-clock fps, and the host's wait for
        the packed fetch of each dispatch's outputs against its entropy
        coding."""
        p = self._perf
        el = max(1e-9, self._clock() - self._t0)
        n = max(1, p["frames"])
        fps = self.params.fps_num / max(1, self.params.fps_denom)
        kbps = p["bytes"] * 8.0 * fps / n / 1000.0
        bt = p["by_type"]
        return (f"encoded {p['frames']} frames "
                f"(I {bt['I']} P {bt['P']} B {bt['B']}) in {el:.2f}s "
                f"({p['frames'] / el:.2f} fps), {kbps:.2f} kb/s, "
                f"Avg QP: {p['qp_sum'] / n:.2f} | stage wait: "
                f"fetch {p['fetch_wait']:.2f}s entropy "
                f"{p['entropy']:.2f}s")


def encode_sequence(frames, params: Params,
                    device="cuda") -> tuple[bytes, list]:
    """Encode a list of (Y, Cb, Cr) frames on ``device``; returns (annexb
    stream in decode order, recons in display order)."""
    enc = Encoder(params, device=device)
    out = enc.headers()
    efs = []
    for fr in frames:
        efs += enc.push_frame(fr)
    efs += enc.flush()
    for ef in efs:
        out += ef.au
    recons = [ef.recon for ef in sorted(efs, key=lambda e: e.display_idx)]
    return out, recons
