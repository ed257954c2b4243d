"""The plain reference decoder that judges a run's Annex-B stream.

A frozen copy of the encoder port's decoder (parse, numpy recon, deblock
and SAO in plain torch), restructured so that one picture can be decoded
alone:

* ``index_stream`` walks every NAL unit once: the parameter sets, each
  picture's slice header, its picture order count (§8.3.1), its reference
  lists from the slice's RPS (§8.3.2-3), the coded video sequence it
  belongs to, its display index and the decoded-picture hash SEI that
  follows it.  Slice data is not parsed here.
* ``decode_picture`` parses one picture's slice data (CABAC, §9.3),
  reconstructs it (§8.4-8.6) from reference planes the caller hands in,
  deblocks and applies SAO (§8.7), and returns the decoded coded-size
  planes and the picture's motion field as TMVP retains it.

Decoding a picture alone needs its reference pictures and its collocated
picture's motion field.  The caller takes those from the program's own
output and state (its reconstructions and retained motion fields), and
holds each of them against this decoder whenever that picture is itself
decoded: the chain is followed one step at a time.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .cabac.ctu import CtuDecoder, PicSyntax
from .cabac.engine import CabacDecoder
from .cabac.tables import init_context_states
from .common.bitstream import (NAL_PPS, NAL_PREFIX_SEI, NAL_SPS,
                               NAL_SUFFIX_SEI, NAL_VPS, BitReader,
                               split_annexb)
from .common.geometry import PictureGeometry
from .common.headers import (SLICE_B, SLICE_I, SLICE_P, parse_pps,
                             parse_slice_header, parse_sps, parse_vps)
from .common.recon import reconstruct_picture
from .common.sei import (SEI_DECODED_PICTURE_HASH, parse_picture_hash,
                         parse_sei_rbsp, plane_checksum, plane_crc,
                         plane_md5)
from .ops.deblock import deblock_decoded_picture
from .ops.sao import sao_apply_decoded_plane


class DecodeError(Exception):
    """A malformed stream or picture."""


@dataclass
class PictureEntry:
    """One coded picture of the stream, as the headers describe it."""
    order: int              # decode order in the stream
    nal_type: int
    cvs: int                # coded video sequence (an IDR starts one)
    poc: int
    display: int            # display index over the whole stream
    slice_type: int
    slice_qp: int
    sh: object
    sps: object
    pps: object
    rbsp: bytes
    data_pos: int           # bit position of the slice data in ``rbsp``
    refs_l0: tuple
    refs_l1: tuple
    col_poc: int | None     # TMVP collocated picture, if the slice uses it
    hash: tuple | None = None   # (hash type, [digest per plane])


def index_stream(data: bytes) -> list:
    """Every picture of an Annex-B stream in decode order (one slice a
    picture, as the encoder writes), with display indices: a CVS's
    pictures follow the previous CVS's in display order."""
    vps, sps_d, pps_d = {}, {}, {}
    pics: list[PictureEntry] = []
    prev_poc = 0
    cvs = -1
    for nal_type, _tid, rbsp in split_annexb(data):
        if nal_type == NAL_VPS:
            v = parse_vps(rbsp)
            vps[v.vps_id] = v
        elif nal_type == NAL_SPS:
            s = parse_sps(rbsp)
            sps_d[s.sps_id] = s
        elif nal_type == NAL_PPS:
            p = parse_pps(rbsp)
            pps_d[p.pps_id] = p
        elif nal_type in (NAL_PREFIX_SEI, NAL_SUFFIX_SEI):
            for ptype, payload in parse_sei_rbsp(rbsp):
                if ptype == SEI_DECODED_PICTURE_HASH and pics:
                    pics[-1].hash = parse_picture_hash(payload)
        elif nal_type < 32:
            probe = BitReader(rbsp)
            if not probe.read_flag():
                raise DecodeError("more than one slice in a picture")
            if 16 <= nal_type <= 23:
                probe.read_flag()
            pps = pps_d[probe.read_ue()]
            sps = sps_d[pps.sps_id]
            br = BitReader(rbsp)
            sh = parse_slice_header(br, sps, pps, nal_type)
            is_idr = 16 <= nal_type <= 23
            if is_idr:
                poc = 0
                cvs += 1
            else:
                if cvs < 0:
                    raise DecodeError("stream does not start with an IDR")
                max_lsb = 1 << sps.log2_max_poc_lsb
                lsb = sh.pic_order_cnt_lsb
                prev_lsb = prev_poc % max_lsb
                prev_msb = prev_poc - prev_lsb
                if lsb < prev_lsb and prev_lsb - lsb >= max_lsb // 2:
                    msb = prev_msb + max_lsb
                elif lsb > prev_lsb and lsb - prev_lsb > max_lsb // 2:
                    msb = prev_msb - max_lsb
                else:
                    msb = prev_msb
                poc = msb + lsb
            if nal_type % 2 == 1 or is_idr:
                prev_poc = poc
            l0, l1 = (), ()
            if sh.slice_type != SLICE_I and sh.rps is not None:
                before = [poc + d for d, u in zip(sh.rps.delta_pocs_s0,
                                                  sh.rps.used_s0) if u]
                after = [poc + d for d, u in zip(sh.rps.delta_pocs_s1,
                                                 sh.rps.used_s1) if u]
                l0 = tuple((before + after)[:sh.num_ref_idx_l0])
                if sh.slice_type == SLICE_B:
                    l1 = tuple((after + before)[:sh.num_ref_idx_l1])
            col = None
            if sh.temporal_mvp_enabled and sh.slice_type != SLICE_I:
                lst = l0 if sh.collocated_from_l0 else l1
                if lst:
                    col = lst[min(sh.collocated_ref_idx, len(lst) - 1)]
            pics.append(PictureEntry(
                order=len(pics), nal_type=nal_type, cvs=cvs, poc=poc,
                display=0, slice_type=sh.slice_type, slice_qp=sh.slice_qp,
                sh=sh, sps=sps, pps=pps, rbsp=rbsp, data_pos=br.bit_pos,
                refs_l0=l0, refs_l1=l1, col_poc=col))
    base, cur, top = 0, -1, 0
    for e in pics:
        if e.cvs != cur:
            base, cur = (top, e.cvs) if cur >= 0 else (0, e.cvs)
        e.display = base + e.poc
        top = max(top, e.display + 1)
    return pics


def motion_field(ps: PicSyntax) -> dict:
    """The motion field that TMVP retains of a decoded picture."""
    pocs0 = np.asarray(ps.ref_pocs_l0 or (0,), np.int32)
    pocs1 = np.asarray(ps.ref_pocs_l1 or (0,), np.int32)
    r0 = np.minimum(ps.ref_idx0.astype(np.int32), len(pocs0) - 1)
    r1 = np.minimum(ps.ref_idx1.astype(np.int32), len(pocs1) - 1)
    return dict(pred_mode=ps.pred_mode.copy(), inter_dir=ps.inter_dir.copy(),
                mv0=ps.mv0.copy(), mv1=ps.mv1.copy(), poc0=pocs0[r0],
                poc1=pocs1[r1], poc=ps.cur_poc)


def decode_picture(e: PictureEntry, refs: dict, col: dict | None,
                   device="cpu", keep: dict | None = None):
    """Decode picture ``e`` alone: ``refs`` maps each POC of its reference
    lists to coded-size (Y, Cb, Cr) planes, ``col`` is the collocated
    picture's motion field (None if the slice uses no TMVP).  Returns the
    decoded coded-size planes (int16) and the picture's motion field.
    The loop filters run in plain torch on ``device``.  ``keep``, where
    given, gets the coded-size planes before SAO (``pre_sao``) and the
    picture's parsed syntax (``syntax``)."""
    sh, sps, pps = e.sh, e.sps, e.pps
    geom = PictureGeometry(sps.pic_width, sps.pic_height,
                           sps.log2_ctb_size, sps.log2_min_cb_size)
    ps = PicSyntax(
        geom,
        max_tr_depth_intra=sps.max_transform_hierarchy_depth_intra,
        max_tr_depth_inter=sps.max_transform_hierarchy_depth_inter,
        sign_hiding=bool(pps.sign_data_hiding))
    ps.max_merge_cand = sh.max_num_merge_cand
    ps.cur_poc = e.poc
    ps.ref_pocs_l0 = tuple(e.refs_l0)
    ps.ref_pocs_l1 = tuple(e.refs_l1)
    if e.col_poc is not None:
        if col is None:
            raise DecodeError(f"no motion field of the collocated picture "
                              f"POC {e.col_poc}")
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
                       num_ref_l0=max(1, len(e.refs_l0)),
                       num_ref_l1=max(1, len(e.refs_l1)),
                       mvd_l1_zero=bool(sh.mvd_l1_zero),
                       transquant_bypass=bool(pps.transquant_bypass_enabled))
    # CABAC init (§9.3.2.2, cabac_init_flag 0): I->0, P->1, B->2
    init_type = {SLICE_I: 0, SLICE_P: 1, SLICE_B: 2}[sh.slice_type]
    dec = CabacDecoder(BitReader(e.rbsp[e.data_pos >> 3:]),
                       init_context_states(init_type, sh.slice_qp))
    for ctu in range(geom.n_ctbs):
        coder.decode_ctu(dec, ctu)
        end = dec.decode_terminate()
        if ctu < geom.n_ctbs - 1:
            if end:
                raise DecodeError(f"premature end_of_slice at CTU {ctu}")
        elif not end:
            raise DecodeError("missing end_of_slice flag")

    try:
        refs_l0 = [refs[p] for p in e.refs_l0]
        refs_l1 = [refs[p] for p in e.refs_l1]
    except KeyError as exc:
        raise DecodeError(f"reference POC {exc} not given") from exc
    h = geom.ctbs_h << geom.log2_ctb
    w = geom.ctbs_w << geom.log2_ctb
    bd = sps.bit_depth_luma
    planes = (np.zeros((h, w), np.int16), np.zeros((h // 2, w // 2), np.int16),
              np.zeros((h // 2, w // 2), np.int16))
    use_w = (pps.weighted_pred and sh.slice_type == SLICE_P) or \
        (pps.weighted_bipred and sh.slice_type == SLICE_B)
    reconstruct_picture(
        ps, planes, sh.slice_qp, bd, pps.cb_qp_offset, pps.cr_qp_offset,
        strong_smoothing=bool(sps.strong_intra_smoothing),
        ref_planes=refs_l0 or None, refs_l1=refs_l1 or None,
        weights=sh if use_w else None)

    cw, ch = sps.pic_width, sps.pic_height
    if keep is not None:
        keep["syntax"] = ps
    if sh.deblocking_filter_disabled and not (sh.sao_luma or sh.sao_chroma):
        coded = (planes[0][:ch, :cw], planes[1][:ch // 2, :cw // 2],
                 planes[2][:ch // 2, :cw // 2])
        if keep is not None:
            keep["pre_sao"] = coded
    else:
        dev = torch.device(device)
        y, cb, cr = (torch.from_numpy(p).to(dev).to(torch.int32)
                     for p in planes)
        if not sh.deblocking_filter_disabled:
            y, cb, cr = deblock_decoded_picture(
                ps, (y, cb, cr), sh.slice_qp, bd, sh.beta_offset_div2,
                sh.tc_offset_div2, pps.cb_qp_offset, pps.cr_qp_offset)
        ctb = 1 << geom.log2_ctb
        if keep is not None:
            keep["pre_sao"] = tuple(
                p[:hh, :ww].to(torch.int16).cpu().numpy()
                for p, hh, ww in ((y, ch, cw), (cb, ch // 2, cw // 2),
                                  (cr, ch // 2, cw // 2)))
        if sh.sao_luma:
            y = sao_apply_decoded_plane(y, ps, 0, ctb, cw, ch, bd)
        if sh.sao_chroma:
            cb = sao_apply_decoded_plane(cb, ps, 1, ctb // 2, cw // 2,
                                         ch // 2, bd)
            cr = sao_apply_decoded_plane(cr, ps, 2, ctb // 2, cw // 2,
                                         ch // 2, bd)
        coded = tuple(p[:hh, :ww].to(torch.int16).cpu().numpy()
                      for p, hh, ww in ((y, ch, cw), (cb, ch // 2, cw // 2),
                                        (cr, ch // 2, cw // 2)))
    return coded, motion_field(ps)


def hash_matches(e: PictureEntry, coded) -> bool | None:
    """Whether the decoded planes match the picture's hash SEI (None: the
    picture carries none)."""
    if e.hash is None:
        return None
    htype, digests = e.hash
    fn = {0: plane_md5, 1: plane_crc, 2: plane_checksum}[htype]
    bd = e.sps.bit_depth_luma
    dt = np.uint8 if bd == 8 else np.uint16
    return all(fn(np.asarray(p).astype(dt), bd) == d
               for p, d in zip(coded, digests))
