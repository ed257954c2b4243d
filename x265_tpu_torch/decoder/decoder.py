"""Conformant HEVC decoder (I, P and B slices) — the port of
``x265_tpu/decoder/decoder.py``.

The split is the reference's: (1) the sequential CABAC / syntax parse into
``PicSyntax`` arrays and coefficient planes on the host, (2) the
reconstruction from those arrays on the host in numpy (``common/recon.py``,
the spec path), except for uniform 16x16 all-intra pictures, which the
batched wavefront recon (``encoder/wavefront.py``) rebuilds on the
decoder's device, and (3) the picture-wide loop filters, deblocking and
SAO, on the decoder's device.  A picture's planes go to the device once
and come back once, filtered: the picture hash and the DPB (which the
host's motion compensation reads) take those host planes.

POC derivation, RPS-driven DPB marking, output bumping, TMVP motion
retention, missing-reference concealment and the hash-SEI checks are the
reference's, line for line.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..cabac.ctu import CtuDecoder, PicSyntax
from ..cabac.engine import CabacDecoder
from ..cabac.tables import init_context_states
from ..common.bitstream import (NAL_PPS, NAL_PREFIX_SEI, NAL_SPS,
                                NAL_SUFFIX_SEI, NAL_VPS, BitReader,
                                split_annexb)
from ..common.geometry import PictureGeometry
from ..common.headers import (SLICE_B, SLICE_I, SLICE_P, parse_pps,
                              parse_slice_header, parse_sps, parse_vps)
from ..common.recon import reconstruct_picture
from ..common.sei import (SEI_DECODED_PICTURE_HASH, parse_picture_hash,
                          parse_sei_rbsp, plane_md5)
from ..ops.deblock import deblock_decoded_picture
from ..ops.sao import sao_apply_decoded_plane

# pictures reconstructed by the batched wavefront path (every Decoder)
WAVEFRONT_DECODES = 0

STAGES = ("parse", "recon", "device", "fetch", "hash")


class DecodeError(Exception):
    """Raised on malformed bitstreams (role of libde265's de265_error)."""


@dataclass
class DecodedPicture:
    poc: int
    planes: tuple          # (Y, Cb, Cr) numpy arrays cropped to conf window
    hash_ok: bool | None = None   # None = no hash SEI present
    syntax: PicSyntax | None = None
    qp: int = 0
    bit_depth: int = 8
    coded_planes: tuple | None = None  # full coded-size planes (hash domain)


class Decoder:
    """Stateful Annex-B decoder.  Feed bytes; collect ``.pictures``.

    The device passes run on ``device`` (the card unless the caller asks
    for the CPU); ``walls`` holds each picture's seconds per stage
    (``STAGES``: the parse, the host recon, the device passes, the fetch
    of the filtered planes, the hash check), in decode order."""

    def __init__(self, check_hashes: bool = True, device="cuda"):
        self.device = torch.device(device)
        torch.empty(0, device=self.device)   # no such device: raise here
        self.vps = {}
        self.sps = {}
        self.pps = {}
        self.pictures: list[DecodedPicture] = []  # display (output) order
        self.check_hashes = check_hashes
        self._pending_hash = None
        self._cur: DecodedPicture | None = None
        self._cur_is_ref = True
        self._dpb = {}          # poc -> coded-size planes (reference pics)
        self._col_motion = {}   # poc -> TMVP motion field
        self._reorder = []      # decoded pictures awaiting output bumping
        self._num_reorder = 0   # max pics that may precede in decode order
        self._prev_poc = 0      # PicOrderCntVal of the previous picture
        self._wf_cache = {}     # wavefront decode scans per geometry
        self.warnings: list[str] = []  # non-fatal stream issues (libde265
        #                                error_queue analogue, decctx.h:123)
        self.walls: list[dict] = []

    def _get_ref(self, rp: int, sps):
        """Reference lookup with missing-picture concealment: synthesize
        a mid-gray substitute (libde265 decctx.cc:1429
        generate_unavailable_reference_picture) instead of failing."""
        pic = self._dpb.get(rp)
        if pic is not None:
            return pic
        self.warnings.append(f"missing reference POC {rp}: concealed")
        mid = 1 << (sps.bit_depth_luma - 1)
        subst = (np.full((sps.pic_height, sps.pic_width), mid, np.int16),
                 np.full((sps.pic_height // 2, sps.pic_width // 2), mid,
                         np.int16),
                 np.full((sps.pic_height // 2, sps.pic_width // 2), mid,
                         np.int16))
        self._dpb[rp] = subst
        return subst

    def push_bytes(self, data: bytes) -> None:
        for nal_type, _tid, rbsp in split_annexb(data):
            try:
                self.push_nal(nal_type, rbsp)
            except (IndexError, AssertionError, KeyError,
                    NotImplementedError) as exc:
                raise DecodeError(
                    f"malformed NAL (type {nal_type}): {exc}") from exc
        self.flush()

    def flush(self) -> None:
        if self._cur is not None:
            self._finish_picture()
        # end of stream: drain the reorder buffer (C.5.2.2 bumping)
        self._reorder.sort(key=lambda p: p.poc)
        self.pictures.extend(self._reorder)
        self._reorder = []

    def push_nal(self, nal_type: int, rbsp: bytes) -> None:
        if nal_type == NAL_VPS:
            v = parse_vps(rbsp)
            self.vps[v.vps_id] = v
        elif nal_type == NAL_SPS:
            s = parse_sps(rbsp)
            self.sps[s.sps_id] = s
        elif nal_type == NAL_PPS:
            p = parse_pps(rbsp)
            self.pps[p.pps_id] = p
        elif nal_type in (NAL_PREFIX_SEI, NAL_SUFFIX_SEI):
            for ptype, payload in parse_sei_rbsp(rbsp):
                if ptype == SEI_DECODED_PICTURE_HASH:
                    self._pending_hash = parse_picture_hash(payload)
                    if self._cur is not None:
                        self._finish_picture()
        elif nal_type < 32:    # VCL NAL
            if self._cur is not None:
                self._finish_picture()
            self._decode_slice(nal_type, rbsp)

    # -- slice decode --------------------------------------------------------

    def _decode_slice(self, nal_type: int, rbsp: bytes) -> None:
        global WAVEFRONT_DECODES
        wall = dict.fromkeys(STAGES, 0.0)
        t0 = time.perf_counter()
        # pre-read pps_id to resolve the active parameter sets
        probe = BitReader(rbsp)
        probe.read_flag()                  # first_slice_segment_in_pic_flag
        if 16 <= nal_type <= 23:
            probe.read_flag()              # no_output_of_prior_pics_flag
        pps = self.pps[probe.read_ue()]
        sps = self.sps[pps.sps_id]

        br = BitReader(rbsp)
        sh = parse_slice_header(br, sps, pps, nal_type)

        # PicOrderCntVal (§8.3.1): msb continuation from the previous
        # picture; IDR resets to 0
        is_idr = 16 <= nal_type <= 23
        if is_idr:
            poc = 0
            # IDR starts a new CVS: output everything pending, clear refs
            self._reorder.sort(key=lambda p: p.poc)
            self.pictures.extend(self._reorder)
            self._reorder = []
            self._dpb.clear()
            self._col_motion.clear()
        else:
            max_lsb = 1 << sps.log2_max_poc_lsb
            lsb = sh.pic_order_cnt_lsb
            prev_lsb = self._prev_poc % max_lsb
            prev_msb = self._prev_poc - prev_lsb
            if lsb < prev_lsb and prev_lsb - lsb >= max_lsb // 2:
                msb = prev_msb + max_lsb
            elif lsb > prev_lsb and lsb - prev_lsb > max_lsb // 2:
                msb = prev_msb - max_lsb
            else:
                msb = prev_msb
            poc = msb + lsb
        # TRAIL_N and other *_N types are never referenced (§7.4.2.2)
        self._cur_is_ref = nal_type % 2 == 1 or is_idr
        self._num_reorder = max(
            self._num_reorder, sps.num_reorder_pics,
            *(v.num_reorder_pics for v in self.vps.values()))

        # RPS-driven DPB marking (§8.3.2): pictures outside the current
        # RPS become "unused for reference" and leave the DPB (replaces
        # any bound heuristic; libde265 decctx.cc:1461 process_reference_
        # picture_set)
        if not is_idr and sh.rps is not None:
            keep = {poc + d for d in sh.rps.delta_pocs_s0}
            keep |= {poc + d for d in sh.rps.delta_pocs_s1}
            for gone in [p for p in self._dpb if p not in keep]:
                del self._dpb[gone]

        # reference lists from the slice RPS (§8.3.2-3, no modification)
        refs_l0, refs_l1 = [], []
        pocs_l0, pocs_l1 = [], []
        if sh.slice_type != SLICE_I and sh.rps is not None:
            before = [poc + d for d, u in zip(sh.rps.delta_pocs_s0,
                                              sh.rps.used_s0) if u]
            after = [poc + d for d, u in zip(sh.rps.delta_pocs_s1,
                                             sh.rps.used_s1) if u]
            # l0 = before (closest first) then after; l1 = after then before
            l0 = before + after
            l1 = after + before
            for rp in l0[:sh.num_ref_idx_l0]:
                refs_l0.append(self._get_ref(rp, sps))
                pocs_l0.append(rp)
            if sh.slice_type == SLICE_B:
                for rp in l1[:sh.num_ref_idx_l1]:
                    refs_l1.append(self._get_ref(rp, sps))
                    pocs_l1.append(rp)

        geom = PictureGeometry(sps.pic_width, sps.pic_height,
                               sps.log2_ctb_size, sps.log2_min_cb_size)
        ps = PicSyntax(
            geom,
            max_tr_depth_intra=sps.max_transform_hierarchy_depth_intra,
            max_tr_depth_inter=sps.max_transform_hierarchy_depth_inter,
            sign_hiding=bool(pps.sign_data_hiding))
        ps.max_merge_cand = sh.max_num_merge_cand
        ps.cur_poc = poc
        ps.ref_pocs_l0 = tuple(pocs_l0)
        ps.ref_pocs_l1 = tuple(pocs_l1)
        # TMVP: attach the collocated picture's retained motion field
        if sh.temporal_mvp_enabled and sh.slice_type != SLICE_I:
            col_list = pocs_l0 if sh.collocated_from_l0 else pocs_l1
            if col_list:
                ci = min(sh.collocated_ref_idx, len(col_list) - 1)
                col = self._col_motion.get(col_list[ci])
                if col is not None:
                    ps.temporal_mvp = True
                    ps.col = col
        ps.slice_qp = sh.slice_qp
        ps.cu_qp_delta_enabled = bool(pps.cu_qp_delta_enabled)
        ps.qp_ctb[:] = sh.slice_qp
        coder = CtuDecoder(ps, sps.log2_min_cb_size, sps.log2_min_tb_size,
                           sps.log2_max_tb_size, slice_type=sh.slice_type,
                           sao_luma=bool(sh.sao_luma),
                           sao_chroma=bool(sh.sao_chroma),
                           bit_depth=sps.bit_depth_luma,
                           num_ref_l0=max(1, len(pocs_l0)),
                           num_ref_l1=max(1, len(pocs_l1)),
                           mvd_l1_zero=bool(sh.mvd_l1_zero),
                           transquant_bypass=bool(
                               pps.transquant_bypass_enabled))

        # CABAC init (§9.3.2.2, cabac_init_flag 0): I->0, P->1, B->2
        init_type = {SLICE_I: 0, SLICE_P: 1, SLICE_B: 2}[sh.slice_type]
        ctx = init_context_states(init_type, sh.slice_qp)
        data = rbsp[br.bit_pos >> 3:]  # slice data starts byte-aligned
        dec = CabacDecoder(BitReader(data), ctx)
        for ctu in range(geom.n_ctbs):
            coder.decode_ctu(dec, ctu)
            end = dec.decode_terminate()
            if ctu < geom.n_ctbs - 1:
                if end:
                    raise DecodeError(
                        f"premature end_of_slice at CTU {ctu}")
            elif not end:
                raise DecodeError("missing end_of_slice flag")
        t1 = time.perf_counter()
        wall["parse"] = t1 - t0

        h = geom.ctbs_h << geom.log2_ctb
        w = geom.ctbs_w << geom.log2_ctb
        bd = sps.bit_depth_luma
        if sh.slice_type != SLICE_I and not refs_l0:
            raise DecodeError("inter slice without reference")
        dev_planes = None
        if (sh.slice_type == SLICE_I
                and not pps.transquant_bypass_enabled):
            dev_planes = self._wavefront_decode(ps, sh, sps, pps, geom)
        if dev_planes is not None:
            WAVEFRONT_DECODES += 1
            t2 = t1
        else:
            planes = (np.zeros((h, w), np.int16),
                      np.zeros((h // 2, w // 2), np.int16),
                      np.zeros((h // 2, w // 2), np.int16))
            use_w = (pps.weighted_pred and sh.slice_type == SLICE_P) or \
                (pps.weighted_bipred and sh.slice_type == SLICE_B)
            reconstruct_picture(
                ps, planes, sh.slice_qp, bd,
                pps.cb_qp_offset, pps.cr_qp_offset,
                strong_smoothing=bool(sps.strong_intra_smoothing),
                ref_planes=refs_l0 or None, refs_l1=refs_l1 or None,
                weights=sh if use_w else None)
            t2 = time.perf_counter()
            wall["recon"] = t2 - t1

        # retain this picture's motion field for later TMVP use
        pocs0a = np.asarray(ps.ref_pocs_l0 or (0,), np.int32)
        pocs1a = np.asarray(ps.ref_pocs_l1 or (0,), np.int32)
        r0 = np.minimum(ps.ref_idx0.astype(np.int32), len(pocs0a) - 1)
        r1 = np.minimum(ps.ref_idx1.astype(np.int32), len(pocs1a) - 1)
        self._col_motion[poc] = dict(
            pred_mode=ps.pred_mode.copy(),
            inter_dir=ps.inter_dir.copy(),
            mv0=ps.mv0.copy(), mv1=ps.mv1.copy(),
            poc0=pocs0a[r0], poc1=pocs1a[r1], poc=poc)
        while len(self._col_motion) > 8:
            self._col_motion.pop(next(iter(self._col_motion)))

        # decoded picture = coded size; output view = conformance-cropped.
        # The loop filters run on the device over the CTB-padded planes;
        # only the coded-size crop comes back.
        cw, ch = sps.pic_width, sps.pic_height
        filt = (not sh.deblocking_filter_disabled or sh.sao_luma
                or sh.sao_chroma)
        if dev_planes is None and not filt:
            coded = (planes[0][:ch, :cw], planes[1][:ch // 2, :cw // 2],
                     planes[2][:ch // 2, :cw // 2])
        else:
            if dev_planes is None:
                dev_planes = self._upload(planes)
            dev_planes = self._filter(dev_planes, ps, sh, pps, geom, bd)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t3 = time.perf_counter()
            wall["device"] = t3 - t2
            coded = self._fetch(dev_planes, cw, ch)
            wall["fetch"] = time.perf_counter() - t3
        cl, cr, ct, cb = sps.conf_win   # offsets in chroma units
        wl = cw - 2 * (cl + cr)
        hl = ch - 2 * (ct + cb)
        y = coded[0][2 * ct:2 * ct + hl, 2 * cl:2 * cl + wl]
        u = coded[1][ct:ct + hl // 2, cl:cl + wl // 2]
        v = coded[2][ct:ct + hl // 2, cl:cl + wl // 2]
        if self._cur_is_ref:
            self._prev_poc = poc     # §8.3.1 prevTid0Pic
        self._cur = DecodedPicture(poc=poc,
                                   planes=(y, u, v), syntax=ps,
                                   qp=sh.slice_qp, bit_depth=bd,
                                   coded_planes=coded)
        wall["poc"] = poc
        self.walls.append(wall)

    # -- device passes ------------------------------------------------------

    def _upload(self, planes):
        """The host recon's (Y, Cb, Cr) int16 planes on the device as int32,
        in one copy."""
        flat = torch.from_numpy(np.concatenate([p.ravel() for p in planes]))
        flat = flat.to(self.device).to(torch.int32)
        out, k = [], 0
        for p in planes:
            out.append(flat[k:k + p.size].view(p.shape))
            k += p.size
        return tuple(out)

    def _fetch(self, dev_planes, cw: int, ch: int):
        """The coded-size crops of the device planes as host int16 planes,
        in one copy."""
        crops = (dev_planes[0][:ch, :cw], dev_planes[1][:ch // 2, :cw // 2],
                 dev_planes[2][:ch // 2, :cw // 2])
        flat = torch.cat([c.reshape(-1) for c in crops]).to(
            torch.int16).cpu().numpy()
        out, k = [], 0
        for c in crops:
            n = c.numel()
            out.append(flat[k:k + n].reshape(c.shape))
            k += n
        return tuple(out)

    def _filter(self, dev_planes, ps, sh, pps, geom, bd):
        """Deblocking then SAO on the device, as the reference runs
        ``deblock_intra_picture_np`` and ``sao_apply_plane_np`` on the
        coded-size planes."""
        y, cb, cr = (p.to(torch.int32) for p in dev_planes)
        if not sh.deblocking_filter_disabled:
            y, cb, cr = deblock_decoded_picture(
                ps, (y, cb, cr), sh.slice_qp, bd,
                sh.beta_offset_div2, sh.tc_offset_div2,
                pps.cb_qp_offset, pps.cr_qp_offset)
        ctb = 1 << geom.log2_ctb
        cw, ch = geom.width, geom.height
        if sh.sao_luma:
            y = sao_apply_decoded_plane(y, ps, 0, ctb, cw, ch, bd)
        if sh.sao_chroma:
            cb = sao_apply_decoded_plane(cb, ps, 1, ctb // 2, cw // 2,
                                         ch // 2, bd)
            cr = sao_apply_decoded_plane(cr, ps, 2, ctb // 2, cw // 2,
                                         ch // 2, bd)
        return y, cb, cr

    def _wavefront_decode(self, ps, sh, sps, pps, geom):
        """Batched device reconstruction for uniform fixed-16-CU intra
        pictures (the structure our encoder emits): the encoder's
        wavefront scan in decode mode, on the decoder's device.  Returns
        the CTB-padded (Y, Cb, Cr) planes there, or None when the parsed
        structure doesn't fit (the numpy spec path covers it)."""
        n = 16
        if (1 << geom.log2_ctb) < n or geom.width % n or geom.height % n:
            return None
        if pps.cu_qp_delta_enabled:
            return None              # per-CTB QP -> numpy spec path
        h4c, w4c = geom.height >> 2, geom.width >> 2
        d = geom.log2_ctb - 4
        from ..cabac.ctu import MODE_INTRA as _INTRA
        if not ((ps.depth[:h4c, :w4c] == d).all()
                and (ps.part[:h4c, :w4c] == 0).all()
                and (ps.tu_depth[:h4c, :w4c] == 0).all()
                and (ps.pred_mode[:h4c, :w4c] == _INTRA).all()
                and (ps.chroma_mode[:h4c, :w4c]
                     == ps.luma_mode[:h4c, :w4c]).all()):
            return None

        from ..encoder.wavefront import WavefrontIntraRecon

        bd = sps.bit_depth_luma
        key = (geom.width, geom.height, geom.log2_ctb, bd)
        wfs = self._wf_cache.get(key)
        if wfs is None:
            wfs = [WavefrontIntraRecon(geom.width, geom.height,
                                       geom.log2_ctb, n, is_luma=True,
                                       bit_depth=bd, device=self.device),
                   WavefrontIntraRecon(geom.width, geom.height,
                                       geom.log2_ctb, n // 2, is_luma=False,
                                       chroma_shift=1, bit_depth=bd,
                                       device=self.device)]
            wfs.append(wfs[1].paired_scan_fn(encode=False))
            self._wf_cache[key] = wfs
        if wfs[0].sched["host_mask"].any():
            return None

        from ..cabac.ctu import chroma_qp
        bd_off = 6 * (bd - 8)
        qp_y = sh.slice_qp + bd_off
        qp_cb = chroma_qp(sh.slice_qp, pps.cb_qp_offset) + bd_off
        qp_cr = chroma_qp(sh.slice_qp, pps.cr_qp_offset) + bd_off
        modes = ps.luma_mode[::4, ::4].astype(np.int32).reshape(-1)

        def blocks(plane, bn):
            gh, gw = wfs[0].sched["grid"]
            return plane.reshape(gh, bn, gw, bn).transpose(
                0, 2, 1, 3).reshape(-1, bn, bn)

        y = wfs[0].decode(blocks(ps.coeff_y, n), modes, qp_y)
        cb, cr = wfs[2]((blocks(ps.coeff_cb, n // 2),
                         blocks(ps.coeff_cr, n // 2)), modes, (qp_cb, qp_cr))
        return y, cb, cr

    def _finish_picture(self) -> None:
        pic = self._cur
        self._cur = None
        if pic is None:
            return
        t0 = time.perf_counter()
        if self._pending_hash is not None and self.check_hashes:
            htype, digests = self._pending_hash
            from ..common.sei import plane_checksum, plane_crc
            fn = {0: plane_md5, 1: plane_crc, 2: plane_checksum}[htype]
            dt = np.uint8 if pic.bit_depth == 8 else np.uint16
            pic.hash_ok = all(
                fn(p.astype(dt), pic.bit_depth) == d
                for p, d in zip(pic.coded_planes, digests))
        self._pending_hash = None
        self.walls[-1]["hash"] = time.perf_counter() - t0
        if self._cur_is_ref:
            # post-filter picture joins the DPB as a reference; eviction
            # is RPS-driven at the next slice header (§8.3.2), this bound
            # is only a safety net against RPS-less malformed streams
            self._dpb[pic.poc] = pic.coded_planes
            if len(self._dpb) > 16:
                del self._dpb[min(self._dpb)]
        # output bumping (C.5.2.2): emit lowest-POC pictures once more
        # than num_reorder are waiting
        self._reorder.append(pic)
        while len(self._reorder) > self._num_reorder:
            nxt = min(range(len(self._reorder)),
                      key=lambda i: self._reorder[i].poc)
            self.pictures.append(self._reorder.pop(nxt))


def decode_annexb(data: bytes, check_hashes: bool = True, device="cuda"):
    """One-shot convenience: full stream bytes -> [DecodedPicture]."""
    d = Decoder(check_hashes=check_hashes, device=device)
    d.push_bytes(data)
    return d.pictures
