"""Rate control: CQP / CRF / ABR with frame-level VBV + 2-pass.

Port of the core of x265's RateControl state machine
(x265_1.9/source/encoder/ratecontrol.cpp): rateEstimateQscale (:1463),
getQScale's qComp complexity curve (:2243), tuneAbrQScaleFromFeedback
(:1436), frame-level clipQscale VBV (:1870) with x264-style frame-size
predictors, the rateControlEnd accumulators (cplxrSum /
wantedBitsWindow / accumPQp), and 2-pass: pass 1 writes per-frame stat
lines (writeRateControlFrameStats :2474), pass 2 re-plans every frame's
qscale from the recorded complexities (initPass2 :824: blurred
complexity^ (1-qcomp) scaled so the predicted total hits the target).
Runs as host scalar state between device frame steps (SURVEY.md §7
design stance).

The per-frame complexity input (x265's lowres lookahead SATD,
m_currentSatd) is supplied by the lookahead / half-res host estimate;
the qComp power curve only needs relative complexity, so the estimate's
scale is absorbed by BASE_CPLX.
"""

from __future__ import annotations

import math
import os

from ..common.params import RC_ABR, RC_CQP, RC_CRF


def qp_to_qscale(qp: float) -> float:
    return 0.85 * 2.0 ** ((qp - 12.0) / 6.0)


def qscale_to_qp(qs: float) -> float:
    return 12.0 + 6.0 * math.log2(qs / 0.85)


MIN_QPSCALE = qp_to_qscale(0)
MAX_QPSCALE = qp_to_qscale(51)


class Predictor:
    """x264-style frame-size predictor: bits ~= coeff * satd / qscale."""

    def __init__(self, coeff: float = 1.0):
        self.coeff = coeff
        self.count = 1.0
        self.decay = 0.5

    def predict(self, satd: float, qscale: float) -> float:
        return self.coeff * satd / max(qscale, 1e-4) / self.count

    def update(self, bits: float, satd: float, qscale: float) -> None:
        if satd <= 0 or bits <= 0:
            return
        self.count *= self.decay
        self.coeff *= self.decay
        self.count += 1.0
        self.coeff += bits * qscale / satd


class RateControl:
    def __init__(self, params):
        self.p = params
        self.fps = params.fps_num / max(1, params.fps_denom)
        self.frame_duration = 1.0 / self.fps
        self.mode = {RC_CQP: "cqp", RC_CRF: "crf",
                     RC_ABR: "abr"}[params.rc_mode]
        if self.mode == "abr" and params.bitrate <= 0:
            self.mode = "cqp"
        self.qcomp = params.qcomp
        self.ip_factor = abs(getattr(params, "ip_factor", 1.4) or 1.4)
        self.pb_factor = abs(getattr(params, "pb_factor", 1.3) or 1.3)
        self.ip_offset = 6.0 * math.log2(self.ip_factor)
        self.pb_offset = 6.0 * math.log2(self.pb_factor)
        self.lstep = 2.0 ** (params.qp_step / 6.0)
        w, h = params.source_width, params.source_height
        self.ncu = (w * h) // 256 or 1

        self.frames_done = 0
        self.total_bits = 0.0
        # complexity blur (rateEstimateQscale 1-pass ABR section)
        self.short_cplx_sum = 0.0
        self.short_cplx_count = 0.0
        self.last_satd = 0.0
        # CRF: rate factor from the target "quality" QP
        base_cplx = self.ncu * 80.0
        self.rate_factor_const = (base_cplx ** (1.0 - self.qcomp)
                                  / qp_to_qscale(params.crf))
        # ABR accumulators (init: ratecontrol.cpp:377)
        self.bitrate = params.bitrate * 1000.0
        self.rate_tolerance = 1.0
        self.cplxr_sum = (0.01 * (7.0e5 ** self.qcomp)
                          * (self.ncu ** 0.5))
        self.wanted_bits_window = self.bitrate / self.fps
        self.accum_p_qp = 0.01 * (params.qp if self.mode == "cqp"
                                  else params.crf)
        self.accum_p_norm = 0.01
        self.last_qscale_for = {"I": qp_to_qscale(26),
                                "P": qp_to_qscale(26),
                                "B": qp_to_qscale(26)}
        if self.mode == "abr":
            bpp = self.bitrate / self.fps / max(1, w * h)
            qs = 0.3 * (0.9 / max(bpp, 1e-4)) ** 0.6
            q0 = min(48.0, max(10.0, qscale_to_qp(qs)))
            self.accum_p_qp = q0 * self.accum_p_norm
            self.last_qscale_for = {"I": qp_to_qscale(q0 - self.ip_offset),
                                    "P": qp_to_qscale(q0),
                                    "B": qp_to_qscale(q0 + self.pb_offset)}

        # VBV (frame level)
        self.vbv = (params.vbv_buffer_size > 0
                    and params.vbv_max_bitrate > 0
                    and self.mode != "cqp")
        if self.vbv:
            self.buffer_size = params.vbv_buffer_size * 1000.0
            self.buffer_rate = (params.vbv_max_bitrate * 1000.0 / self.fps)
            self.buffer_fill = self.buffer_size * params.vbv_buffer_init
        self.pred = {"I": Predictor(2.0), "P": Predictor(1.0),
                     "B": Predictor(0.8)}
        self._last = None           # (type, qscale, satd) of current frame

        # 2-pass (ratecontrol.cpp:824 initPass2 / :2474 frame stats)
        self.stats_pass = getattr(params, "stats_pass", 0)
        self.stats_file = getattr(params, "stats_file", "x265_2pass.log")
        self._stats_fh = None
        self.pass2_qp: list[int] = []
        if self.stats_pass == 1:
            self._stats_fh = open(self.stats_file, "w", buffering=1)
        elif self.stats_pass >= 2:
            self._init_pass2()
            self.mode = "2pass"

    # -- 2-pass ---------------------------------------------------------------

    def _init_pass2(self) -> None:
        """Plan per-frame QPs from the pass-1 stats (initPass2:824).

        Complexity of frame k = bits1_k * qscale1_k (the bits the frame
        would cost at qscale 1), blurred over +-cplxblur neighbors; the
        target curve is qscale_k = f * blurcplx_k^(1-qcomp) with type
        offsets, and f solves sum(complexity_k / qscale_k) == target.
        """
        if not os.path.exists(self.stats_file):
            raise ValueError(
                f"--pass 2 requires stats file {self.stats_file!r}")
        entries = []          # (type, bits, qscale)
        with open(self.stats_file) as fh:
            for line in fh:
                kv = dict(tok.split(":", 1) for tok in line.split()
                          if ":" in tok)
                if "type" not in kv:
                    continue
                entries.append((kv["type"],
                                float(kv.get("bits", 0)),
                                qp_to_qscale(float(kv.get("q", 26)))))
        if not entries:
            raise ValueError(f"empty stats file {self.stats_file!r}")
        cplx = [b * q for (_t, b, q) in entries]
        # cplxblur gaussian-ish blur (getDiffLimitedQScale's blur role)
        blur = max(0.1, getattr(self.p, "cplxblur", 20.0))
        n = len(cplx)
        blurred = []
        for k in range(n):
            num = den = 0.0
            for j in range(max(0, k - 10), min(n, k + 11)):
                wgt = math.exp(-((j - k) ** 2) / (2.0 * (blur / 4.0) ** 2))
                num += cplx[j] * wgt
                den += wgt
            blurred.append(num / max(den, 1e-9))
        u = []
        for (t, _b, _q), c in zip(entries, blurred):
            base = max(c, 1.0) ** (1.0 - self.qcomp)
            if t == "I":
                base /= self.ip_factor
            elif t == "B":
                base *= self.pb_factor
            u.append(base)
        target_total = self.bitrate / self.fps * n
        if target_total <= 0:
            raise ValueError("--pass 2 requires --bitrate")
        # bits_k(f) = cplx_k / (f * u_k); solve for f
        inv = sum(c / uk for c, uk in zip(cplx, u))
        f = inv / target_total
        self.pass2_qp = [
            int(min(51, max(0, round(qscale_to_qp(
                min(MAX_QPSCALE, max(MIN_QPSCALE, f * uk)))))))
            for uk in u]

    # -- per-frame decision --------------------------------------------------

    def _rceq(self) -> float:
        """qComp complexity curve value for the current blur state."""
        blurred = (self.short_cplx_sum / max(self.short_cplx_count, 1e-9)
                   if self.short_cplx_count > 0 else 1.0)
        return max(blurred, 1.0) ** (1.0 - self.qcomp)

    def frame_qp(self, is_intra: bool, satd: float = 0.0,
                 is_b: bool = False, is_ref_b: bool = False) -> int:
        """QP for the next frame.  ``satd`` is the frame complexity
        estimate (lookahead cost analogue); 0 keeps the previous blur.
        Non-referenced B frames ride pbFactor above their anchors
        (ratecontrol.cpp:1540 B-frame qscale interpolation, flat case);
        a b-pyramid reference B sits halfway (x265 rateEstimateQscale
        halves the pbFactor offset for referenced Bs)."""
        ftype = "B" if is_b else "I" if is_intra else "P"
        if self.mode == "2pass":
            idx = min(self.frames_done, len(self.pass2_qp) - 1)
            qs = qp_to_qscale(self.pass2_qp[idx])
            if self.vbv and satd > 0:
                qs = self._clip_qscale_vbv(qs, satd, ftype)
            self._last = (ftype, qs, satd)
            return int(min(51, max(0, round(qscale_to_qp(qs)))))
        if self.mode == "cqp":
            boff = round(self.pb_offset / 2 if is_ref_b
                         else self.pb_offset)
            q = self.p.qp + (boff if is_b
                             else -round(self.ip_offset) if is_intra else 0)
            self._last = (ftype, qp_to_qscale(q), satd)
            return int(min(51, max(0, q)))
        if is_b:
            # B QP from the surrounding anchor qscale * pbFactor
            pbf = (self.pb_factor ** 0.5 if is_ref_b else self.pb_factor)
            qs = self.last_qscale_for["P"] * pbf
            qs = min(MAX_QPSCALE, max(MIN_QPSCALE, qs))
            self._last = (ftype, qs, satd)
            return int(min(51, max(0, round(qscale_to_qp(qs)))))

        if satd > 0:
            self.short_cplx_sum *= 0.5
            self.short_cplx_count *= 0.5
            self.short_cplx_sum += satd
            self.short_cplx_count += 1
            self.last_satd = satd
        rceq = self._rceq()

        if self.mode == "crf":
            qs = rceq / self.rate_factor_const
        else:
            # 1-pass ABR (rateEstimateQscale:1646)
            qs = rceq / (self.wanted_bits_window / self.cplxr_sum)
            qs = self._abr_feedback(qs)

        if is_intra and self.frames_done > 0:
            # I frames track the accumulated P QP / ipfactor (:1682)
            qs = qp_to_qscale(self.accum_p_qp / self.accum_p_norm)
            qs /= self.ip_factor
        elif self.frames_done > 0 and self.mode == "abr":
            lqmin = self.last_qscale_for[ftype] / self.lstep
            lqmax = self.last_qscale_for[ftype] * self.lstep
            qs = min(lqmax, max(lqmin, qs))
        elif self.frames_done == 0 and self.mode == "crf":
            qs = qp_to_qscale(self.p.crf) / self.ip_factor

        qs = min(MAX_QPSCALE, max(MIN_QPSCALE, qs))
        qs = self._clip_qscale_vbv(qs, satd, ftype)
        self.last_qscale_for[ftype] = qs
        if is_intra:
            self.last_qscale_for["P"] = max(
                self.last_qscale_for["P"], qs * self.ip_factor)
        self._last = (ftype, qs, satd)
        return int(min(51, max(0, round(qscale_to_qp(qs)))))

    def _abr_feedback(self, qs: float) -> float:
        """tuneAbrQScaleFromFeedback (:1436)."""
        if self.last_satd <= 0 or self.frames_done == 0:
            return qs
        abr_buffer = 2.0 * self.rate_tolerance * self.bitrate
        time_done = self.frames_done * self.frame_duration
        wanted = time_done * self.bitrate
        if wanted > 0 and self.total_bits > 0:
            abr_buffer *= max(1.0, math.sqrt(time_done))
            overflow = min(2.0, max(
                0.5, 1.0 + (self.total_bits - wanted) / abr_buffer))
            qs *= overflow
        return qs

    def _clip_qscale_vbv(self, qs: float, satd: float,
                         ftype: str) -> float:
        """Frame-level clipQscale (:1870): keep the predicted frame size
        inside the buffer; raise q on underflow risk, lower on overflow."""
        if not self.vbv or satd <= 0:
            return qs
        pred = self.pred[ftype]
        # underflow guard: frame must leave >= 10% buffer
        max_bits = self.buffer_fill + self.buffer_rate \
            - 0.1 * self.buffer_size
        if max_bits > 0:
            size = pred.predict(satd, qs)
            if size > max_bits:
                qs = pred.coeff / pred.count * satd / max_bits
        # overflow guard: don't let the buffer overflow (pad with quality)
        min_bits = self.buffer_fill + self.buffer_rate - self.buffer_size
        if min_bits > 0:
            size = pred.predict(satd, qs)
            if size < min_bits:
                qs = pred.coeff / pred.count * satd / min_bits
        return min(MAX_QPSCALE, max(MIN_QPSCALE, qs))

    # -- post-frame accounting ----------------------------------------------

    def update(self, bits: int, qp_used: int, is_intra: bool) -> None:
        """rateControlEnd: accumulate bits / complexity ratios / VBV."""
        ftype, qs, satd = self._last or ("I", qp_to_qscale(qp_used), 0.0)
        if self._stats_fh is not None:
            # writeRateControlFrameStats (:2474), reduced field set
            self._stats_fh.write(
                f"in:{self.frames_done} out:{self.frames_done} "
                f"type:{ftype} q:{qp_used:.2f} bits:{bits} "
                f"satd:{satd:.0f}\n")
        self.total_bits += bits
        self.frames_done += 1
        if self.mode != "cqp":
            rceq = self._rceq()
            self.cplxr_sum += bits * qp_to_qscale(qp_used) / max(rceq,
                                                                 1e-9)
            self.wanted_bits_window += self.bitrate / self.fps
            if ftype == "P":
                self.accum_p_qp = 0.95 * self.accum_p_qp + qp_used
                self.accum_p_norm = 0.95 * self.accum_p_norm + 1.0
        if satd > 0:
            self.pred[ftype].update(bits, satd, qs)
        if self.vbv:
            self.buffer_fill = min(
                self.buffer_size,
                max(0.0, self.buffer_fill - bits + self.buffer_rate))
