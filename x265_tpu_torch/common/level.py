"""Profile/tier/level determination and enforcement (H.265 Annex A).

Parity with the reference's level machinery (x265_1.9/source/encoder/
level.cpp:44 levels[], :63 determineLevel, :279 enforceLevel): given the
coded resolution, frame rate and rate-control ceiling, pick the smallest
conforming level for the SPS profile_tier_level, honoring an explicit
--level-idc / --high-tier request, and validate stream parameters
against the chosen level's limits.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class LevelSpec:
    name: str
    level_idc: int            # level * 30
    max_luma_samples: int     # MaxLumaPs (A.4.1)
    max_luma_sr: int          # MaxLumaSr (samples/sec)
    max_bitrate_main: int     # kbps, main tier
    max_bitrate_high: int     # kbps, high tier (0 = no high tier)
    max_cpb_main: int         # kbits
    max_cpb_high: int


# Table A.6 / level.cpp:44 (Main profile, 4:2:0)
LEVELS: tuple[LevelSpec, ...] = (
    LevelSpec("1",   30,    36864,     552960,    128,      0,    350,      0),
    LevelSpec("2",   60,    122880,    3686400,   1500,     0,    1500,     0),
    LevelSpec("2.1", 63,    245760,    7372800,   3000,     0,    3000,     0),
    LevelSpec("3",   90,    552960,    16588800,  6000,     0,    6000,     0),
    LevelSpec("3.1", 93,    983040,    33177600,  10000,    0,    10000,    0),
    LevelSpec("4",   120,   2228224,   66846720,  12000,    30000,  12000,  30000),
    LevelSpec("4.1", 123,   2228224,   133693440, 20000,    50000,  20000,  50000),
    LevelSpec("5",   150,   8912896,   267386880, 25000,    100000, 25000,  100000),
    LevelSpec("5.1", 153,   8912896,   534773760, 40000,    160000, 40000,  160000),
    LevelSpec("5.2", 156,   8912896,   1069547520, 60000,   240000, 60000,  240000),
    LevelSpec("6",   180,   35651584,  1069547520, 60000,   240000, 60000,  240000),
    LevelSpec("6.1", 183,   35651584,  2139095040, 120000,  480000, 120000, 480000),
    LevelSpec("6.2", 186,   35651584,  4278190080, 240000,  800000, 240000, 800000),
)


def determine_level(width: int, height: int, fps_num: int, fps_denom: int,
                    bitrate_kbps: int = 0,
                    requested_idc: int = 0,
                    high_tier: bool = False) -> tuple[int, int]:
    """(level_idc, tier_flag) — smallest level satisfying the stream
    (level.cpp:63 determineLevel).  ``requested_idc`` > 0 forces at least
    that level; raises ValueError if the stream cannot conform to it.
    """
    luma_ps = width * height
    luma_sr = luma_ps * fps_num / max(1, fps_denom)
    for lv in LEVELS:
        if requested_idc and lv.level_idc < requested_idc:
            continue
        if luma_ps > lv.max_luma_samples or luma_sr > lv.max_luma_sr:
            continue
        # A.4.1: picture dims each <= sqrt(8 * MaxLumaPs)
        if width * width > 8 * lv.max_luma_samples:
            continue
        if height * height > 8 * lv.max_luma_samples:
            continue
        # tier: honor an explicit request; else auto-promote to high tier
        # when the bitrate exceeds the main-tier cap (determineLevel:63)
        tier = 1 if (high_tier and lv.max_bitrate_high) else 0
        if bitrate_kbps:
            if bitrate_kbps > lv.max_bitrate_main and not tier:
                if lv.max_bitrate_high and \
                        bitrate_kbps <= lv.max_bitrate_high:
                    tier = 1
                else:
                    continue
            elif tier and bitrate_kbps > lv.max_bitrate_high:
                continue
        return lv.level_idc, tier
    raise ValueError(
        f"no HEVC level fits {width}x{height}@{luma_sr:.0f} samples/s "
        f"at {bitrate_kbps} kbps")


def enforce_level(params, level_idc: int,
                  tier: int | None = None) -> list[str]:
    """Clamp rate-control parameters to the level's ceiling and return
    warnings (level.cpp:279 enforceLevel, reduced to the honored knobs).

    ``tier`` is the RESOLVED tier flag from determine_level — which may
    have auto-promoted the stream to high tier beyond params.high_tier;
    the cap must come from the tier the PTL actually signals, not from
    the user request, or an auto-promoted stream gets its rate-control
    target silently clamped to the main-tier cap."""
    spec = next((lv for lv in LEVELS if lv.level_idc == level_idc), None)
    out = []
    if spec is None:
        return out
    if tier is None:
        tier = 1 if (params.high_tier and spec.max_bitrate_high) else 0
    cap = spec.max_bitrate_high if tier and \
        spec.max_bitrate_high else spec.max_bitrate_main
    if params.bitrate and params.bitrate > cap:
        out.append(f"x265_tpu [warning]: bitrate {params.bitrate} kbps "
                   f"exceeds level {spec.name} cap {cap}; clamping")
        params.bitrate = cap
    if params.vbv_max_bitrate and params.vbv_max_bitrate > cap:
        out.append(f"x265_tpu [warning]: vbv-maxrate clamped to level "
                   f"{spec.name} cap {cap}")
        params.vbv_max_bitrate = cap
    return out
