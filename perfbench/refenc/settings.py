"""The settings of the reference's CTU step and subpel refine, from the
stream's parameter sets and the configuration, never from the program.

The stream gives the geometry, the bit depth, sign hiding and strong intra
smoothing; the configuration (its preset, tune and fields) gives the rest,
read through a frozen copy of x265's documented preset and tune values of
the fields the two steps read (x265 ``doc/reST/presets.rst``,
``cli.rst``; ``source/common/param.cpp`` for the defaults).
"""

from __future__ import annotations

from dataclasses import dataclass

DEFAULTS = dict(rdoq_level=0, psy_rd=2.0, psy_rdoq=0.0,
                noise_reduction_intra=0, noise_reduction_inter=0,
                subme=2, me_range=57)
PRESETS = {
    "ultrafast": dict(subme=0, rdoq_level=0),
    "superfast": dict(subme=1, rdoq_level=0),
    "veryfast": dict(subme=1, rdoq_level=0),
    "faster": dict(subme=2, rdoq_level=0),
    "fast": dict(subme=2, rdoq_level=0),
    "medium": dict(),
    "slow": dict(subme=3, rdoq_level=2, psy_rdoq=1.0),
    "slower": dict(subme=3, rdoq_level=2, psy_rdoq=1.0),
    "veryslow": dict(subme=4, rdoq_level=2, psy_rdoq=1.0, me_range=57),
    "placebo": dict(subme=5, me_range=92, rdoq_level=2, psy_rdoq=1.0),
}
TUNES = {
    "psnr": dict(psy_rd=0.0, psy_rdoq=0.0),
    "ssim": dict(psy_rd=0.0, psy_rdoq=0.0),
    "grain": dict(psy_rd=0.5, psy_rdoq=30.0),
    "fastdecode": dict(),
    "zerolatency": dict(),
}


@dataclass(frozen=True)
class StepSettings:
    width: int
    height: int
    log2_ctb: int
    bit_depth: int
    sign_hide: bool
    strong_intra_smoothing: bool
    rdoq: bool
    noise_reduction: bool
    psy_rd: float
    psy_rdoq: float
    subme: int
    me_range: int


def configured(config: dict) -> dict:
    """The fields above as the configuration sets them."""
    out = dict(DEFAULTS)
    out.update(PRESETS[config["preset"]])
    if config.get("tune"):
        out.update(TUNES[config["tune"]])
    out.update({k: v for k, v in config["params"].items() if k in out})
    return out


def step_settings(sps, pps, config: dict) -> StepSettings:
    c = configured(config)
    return StepSettings(
        width=sps.pic_width, height=sps.pic_height,
        log2_ctb=sps.log2_ctb_size, bit_depth=sps.bit_depth_luma,
        sign_hide=bool(pps.sign_data_hiding),
        strong_intra_smoothing=bool(sps.strong_intra_smoothing),
        rdoq=c["rdoq_level"] > 0,
        noise_reduction=bool(c["noise_reduction_intra"]
                             or c["noise_reduction_inter"]),
        psy_rd=float(c["psy_rd"]), psy_rdoq=float(c["psy_rdoq"]),
        subme=int(c["subme"]), me_range=int(c["me_range"]))
