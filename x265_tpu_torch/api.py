"""x265-style procedural API (x265.h:1334-1403 / api.cpp) on the port — a
copy of ``x265_tpu/api.py`` whose encoder runs on ``device`` (the card
unless the caller asks for the CPU).

Thin functional wrappers over the object API for users porting from the
reference's C interface:

    param = x265_param_default_preset("medium", tune=None)
    x265_param_parse(param, "crf", "23")
    enc = x265_encoder_open(param)            # device="cuda"
    nals = x265_encoder_headers(enc)
    nals, recon = x265_encoder_encode(enc, (y, cb, cr))
    stats = x265_encoder_get_stats(enc)
    x265_encoder_close(enc)
"""

from __future__ import annotations

from dataclasses import dataclass

from .common.params import Params, default_params, param_parse
from .encoder import Encoder

X265_BUILD = 1


def x265_param_default() -> Params:
    return Params()


def x265_param_default_preset(preset: str = "medium",
                              tune: str | None = None, **kw) -> Params:
    return default_params(preset, tune, **kw)


def x265_param_parse(param: Params, name: str,
                     value: str | None = None) -> None:
    param_parse(param, name, value)


def x265_encoder_open(param: Params, device="cuda") -> Encoder:
    return Encoder(param, device=device)


def x265_encoder_headers(enc: Encoder) -> bytes:
    return enc.headers()


def x265_encoder_encode(enc: Encoder, pic_in):
    """Feed one picture (or None to flush); returns (annexb_bytes,
    recon_planes) for the next output picture in ENCODE order, or
    (b"", None) when the encoder is buffering (B-frame lag) / drained.
    Mirrors the x265_encoder_encode outNal/pic_out contract
    (x265.h:1334: *pi_nal==0 while the lookahead fills)."""
    if not hasattr(enc, "_api_out_fifo"):
        enc._api_out_fifo = []
    if pic_in is not None:
        enc._api_out_fifo.extend(enc.push_frame(pic_in))
    else:
        enc._api_out_fifo.extend(enc.flush())
    if not enc._api_out_fifo:
        return b"", None
    ef = enc._api_out_fifo.pop(0)
    return ef.au, ef.recon


@dataclass
class x265_stats:
    encoded_picture_count: int = 0
    accumulated_bits: int = 0


def x265_encoder_get_stats(enc: Encoder) -> x265_stats:
    return x265_stats(encoded_picture_count=enc.rc.frames_done,
                      accumulated_bits=int(enc.rc.total_bits))


def x265_encoder_close(enc: Encoder) -> None:
    enc.ref = None


def x265_encoder_reconfig(enc: Encoder, **fields) -> None:
    """Mid-stream safe param subset swap (x265.h:1361; encoder.cpp:867).
    Currently: qp / crf / bitrate."""
    for k, v in fields.items():
        if k not in ("qp", "crf", "bitrate"):
            raise ValueError(f"{k} is not runtime-reconfigurable")
        setattr(enc.params, k, v)
    from .encoder.ratecontrol import RateControl
    enc.rc = RateControl(enc.params)
