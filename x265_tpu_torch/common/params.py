"""Encoder parameters — the ``Params`` dataclass of
``x265_tpu/common/params.py`` (same fields, same defaults: x265's preset
'medium'), copied line for line with its enums and the warnings for
options the engine does not honour, and its preset and tune tables with
``default_params``, and ``param_parse`` (x265_param_parse: one option by
its CLI name) with its alias and VUI name tables.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

# --- enums (mirroring x265.h values where they are API-visible) -------------

CSP_I400, CSP_I420, CSP_I422, CSP_I444 = 0, 1, 2, 3

ME_DIA, ME_HEX, ME_UMH, ME_STAR, ME_FULL = 0, 1, 2, 3, 4
ME_NAMES = ["dia", "hex", "umh", "star", "full"]

RC_CQP, RC_CRF, RC_ABR = 0, 1, 2

B_ADAPT_NONE, B_ADAPT_FAST, B_ADAPT_TRELLIS = 0, 1, 2

AQ_NONE, AQ_VARIANCE, AQ_AUTO_VARIANCE, AQ_AUTO_VARIANCE_BIASED = 0, 1, 2, 3

HASH_NONE, HASH_MD5, HASH_CRC, HASH_CHECKSUM = 0, 1, 2, 3

PRESETS = ["ultrafast", "superfast", "veryfast", "faster", "fast",
           "medium", "slow", "slower", "veryslow", "placebo"]
TUNES = ["psnr", "ssim", "grain", "fastdecode", "zerolatency"]

MAX_MAX_QP = 51
QP_BD_OFFSET_PER_DEPTH = 6  # 6*(bitDepth-8)


@dataclass
class Params:
    """Encoder configuration.  Defaults = x265 defaults at preset 'medium'."""

    # input description
    source_width: int = 0
    source_height: int = 0
    fps_num: int = 25
    fps_denom: int = 1
    internal_csp: int = CSP_I420
    internal_bit_depth: int = 8
    input_bit_depth: int = 8
    total_frames: int = 0
    interlace_mode: int = 0

    # quality metrics
    psnr: bool = True
    ssim: bool = False

    # logging
    log_level: int = 2  # info
    csv_file: str | None = None

    # parallelism (mesh/sharding knobs — the TPU analogue of
    # --frame-threads/--pools/--wpp, SURVEY.md §2.6)
    frame_parallelism: int = 1      # frames in flight across the mesh
    wavefront: bool = True          # lattice-scan wavefront (WPP analogue)
    lookahead_slices: int = 8

    # CTU / CU structure
    ctu_size: int = 64              # --ctu 16/32/64
    min_cu_size: int = 8            # --min-cu-size
    max_tu_size: int = 32           # --max-tu-size
    tu_intra_depth: int = 1
    tu_inter_depth: int = 1
    rd_penalty: int = 0

    # mode decision
    rd_level: int = 3               # --rd 0..6
    limit_refs: int = 3
    limit_modes: bool = False
    rect: bool = False
    amp: bool = False
    early_skip: bool = False
    fast_intra: bool = False
    b_intra: bool = False
    cu_lossless: bool = False
    tskip: bool = False
    tskip_fast: bool = False
    max_merge: int = 2

    # RDO / quant
    rdoq_level: int = 0     # x265 1.9 medium default; slow+ presets use 2
    psy_rd: float = 2.0     # x265 1.9 default (param.cpp:188)
    psy_rdoq: float = 0.0   # x265 1.9 default (param.cpp:189); slow+ -> 1.0
    sign_hide: bool = True
    noise_reduction_intra: int = 0
    noise_reduction_inter: int = 0
    lossless: bool = False

    # motion
    me: int = ME_HEX
    subme: int = 2
    me_range: int = 57
    temporal_mvp: bool = True
    weightp: bool = True
    weightb: bool = False

    # intra
    strong_intra_smoothing: bool = True
    constrained_intra: bool = False

    # slice / GOP structure
    open_gop: bool = True
    keyint_max: int = 250
    keyint_min: int = 0             # auto
    scenecut_threshold: int = 40
    rc_lookahead: int = 20
    bframes: int = 4
    b_adapt: int = B_ADAPT_TRELLIS
    bframe_bias: int = 0
    b_pyramid: bool = True
    ref: int = 3
    intra_refresh: bool = False

    # rate control
    # direct-API default is CQP (explicit qp field); the CLI/param_parse
    # switches to CRF/ABR when --crf/--bitrate are given (x265's default
    # mode is CRF via its CLI)
    rc_mode: int = RC_CQP
    bitrate: int = 0                # kbps (ABR)
    crf: float = 28.0
    qp: int = 32                    # CQP
    qp_step: int = 4
    ip_factor: float = 1.4
    pb_factor: float = 1.3
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    aq_mode: int = AQ_AUTO_VARIANCE
    aq_strength: float = 1.0
    qg_size: int = 32
    cu_tree: bool = True
    vbv_buffer_size: int = 0
    vbv_max_bitrate: int = 0
    vbv_buffer_init: float = 0.9
    stats_pass: int = 0             # --pass
    stats_file: str = "x265_2pass.log"
    qcomp: float = 0.6
    qblur: float = 0.5
    cplxblur: float = 20.0

    # loop filters
    deblock: bool = True
    deblock_tc_offset: int = 0
    deblock_beta_offset: int = 0
    sao: bool = True
    sao_non_deblock: bool = False

    # bitstream / SEI
    annexb: bool = True
    repeat_headers: bool = False
    aud: bool = False
    hrd: bool = False
    emit_info_sei: bool = True
    decoded_picture_hash: int = HASH_NONE
    temporal_layers: int = 1

    # profile/level
    profile: str = "main"
    level_idc: int = 0              # auto
    high_tier: bool = False
    allow_non_conformance: bool = False

    # VUI (pass-through signaling)
    sar_width: int = 0
    sar_height: int = 0
    video_format: int = 5
    video_full_range: bool = False
    colorprim: int = 2
    transfer: int = 2
    colormatrix: int = 2
    chromaloc: int = 0
    # HDR static metadata SEIs (SMPTE ST 2086 / CTA-861.3)
    master_display: str | None = None   # "G(x,y)B(..)R(..)WP(..)L(max,min)"
    max_cll: str | None = None          # "cll,fall"
    # per-range overrides (x265 --zones "s,e,q=QP/s,e,b=FACTOR") and
    # per-frame QP file (x264/x265 --qpfile "frame type qp" lines)
    zones: str | None = None
    qpfile: str | None = None

    # --- derived helpers ---------------------------------------------------

    @property
    def ctb_log2(self) -> int:
        return self.ctu_size.bit_length() - 1

    @property
    def pic_width_in_ctbs(self) -> int:
        return (self.source_width + self.ctu_size - 1) // self.ctu_size

    @property
    def pic_height_in_ctbs(self) -> int:
        return (self.source_height + self.ctu_size - 1) // self.ctu_size

    @property
    def chroma_shift(self) -> tuple[int, int]:
        """(hshift, vshift) for the chroma planes."""
        return {CSP_I400: (0, 0), CSP_I420: (1, 1),
                CSP_I422: (1, 0), CSP_I444: (0, 0)}[self.internal_csp]

    def validate(self) -> None:
        assert self.source_width > 0 and self.source_height > 0, "input res unset"
        assert self.ctu_size in (16, 32, 64), "--ctu must be 16/32/64"
        assert self.min_cu_size in (8, 16, 32), "--min-cu-size must be 8/16/32"
        assert self.max_tu_size in (4, 8, 16, 32)
        assert 0 <= self.qp <= 51
        assert self.source_width % self.min_cu_size == 0 and \
            self.source_height % self.min_cu_size == 0, \
            "picture size must be a multiple of min CU size (conformance window TBD)"


# ---------------------------------------------------------------------------
# Presets (x265 1.9 preset matrix, doc/reST/presets.rst:26-90)
# ---------------------------------------------------------------------------

_PRESET_OVERRIDES: dict[str, dict] = {
    # name: field overrides relative to defaults (medium)
    "ultrafast": dict(ctu_size=32, min_cu_size=16, bframes=3, b_adapt=0,
                      rc_lookahead=5, lookahead_slices=8, scenecut_threshold=0,
                      ref=1, limit_refs=0, me=ME_DIA, subme=0, rd_level=2,
                      aq_mode=AQ_NONE, aq_strength=0.0, cu_tree=False,
                      early_skip=True, fast_intra=True, sao=False,
                      sign_hide=False, weightp=False, deblock=True,
                      b_intra=False, rdoq_level=0, tu_intra_depth=1,
                      tu_inter_depth=1, max_merge=2),
    "superfast": dict(ctu_size=32, bframes=3, b_adapt=0, rc_lookahead=10,
                      scenecut_threshold=40, ref=1, limit_refs=0, me=ME_HEX,
                      subme=1, rd_level=2, aq_mode=AQ_NONE, aq_strength=0.0,
                      cu_tree=False, early_skip=True, fast_intra=True,
                      sao=True, sign_hide=True, weightp=False, rdoq_level=0),
    "veryfast": dict(bframes=3, b_adapt=0, rc_lookahead=15, ref=2,
                     limit_refs=3, me=ME_HEX, subme=1, rd_level=2,
                     early_skip=True, fast_intra=True, rdoq_level=0),
    "faster": dict(bframes=3, b_adapt=0, rc_lookahead=15, ref=2,
                   limit_refs=3, me=ME_HEX, subme=2, rd_level=2,
                   fast_intra=True, rdoq_level=0),
    "fast": dict(bframes=3, b_adapt=0, rc_lookahead=15, ref=3, me=ME_HEX,
                 subme=2, rd_level=2, rdoq_level=0),
    "medium": dict(),  # defaults
    "slow": dict(b_adapt=2, rc_lookahead=25, ref=4, me=ME_STAR, subme=3,
                 rd_level=4, rect=True, limit_modes=True, rdoq_level=2,
                 psy_rdoq=1.0),
    "slower": dict(b_adapt=2, bframes=8, rc_lookahead=30, ref=4, me=ME_STAR,
                   subme=3, rd_level=6, rect=True, amp=True, limit_refs=1,
                   limit_modes=True, rdoq_level=2, psy_rdoq=1.0,
                   tu_intra_depth=3, tu_inter_depth=3, b_intra=True,
                   weightb=True, max_merge=3),
    "veryslow": dict(b_adapt=2, bframes=8, rc_lookahead=40, ref=5,
                     me=ME_STAR, subme=4, rd_level=6, rect=True, amp=True,
                     limit_refs=0, limit_modes=False, rdoq_level=2,
                     psy_rdoq=1.0, tu_intra_depth=3, tu_inter_depth=3,
                     b_intra=True, weightb=True, max_merge=4, me_range=57),
    "placebo": dict(b_adapt=2, bframes=8, rc_lookahead=60, ref=5, me=ME_STAR,
                    subme=5, me_range=92, rd_level=6, rect=True, amp=True,
                    limit_refs=0, rdoq_level=2, psy_rdoq=1.0,
                    tu_intra_depth=4, tu_inter_depth=4, b_intra=True,
                    weightb=True, max_merge=5, tskip=True),
}

_TUNE_OVERRIDES: dict[str, dict] = {
    "psnr": dict(aq_strength=0.0, psy_rd=0.0, psy_rdoq=0.0),
    "ssim": dict(aq_mode=AQ_AUTO_VARIANCE, psy_rd=0.0, psy_rdoq=0.0,
                 ssim=True),
    "grain": dict(aq_mode=AQ_NONE, cu_tree=False, ip_factor=1.1,
                  pb_factor=1.0, psy_rd=0.5, psy_rdoq=30.0, qp_step=1,
                  sao=False, rc_mode=RC_CRF),
    "fastdecode": dict(deblock=False, sao=False, weightp=False,
                       weightb=False, b_intra=False),
    "zerolatency": dict(b_adapt=0, bframes=0, rc_lookahead=0,
                        frame_parallelism=1, cu_tree=False),
}


def default_params(preset: str = "medium", tune: str | None = None,
                   **overrides) -> Params:
    """x265_param_default_preset equivalent."""
    if preset not in _PRESET_OVERRIDES:
        raise ValueError(f"unknown preset {preset!r} (choose from {PRESETS})")
    p = Params()
    for k, v in _PRESET_OVERRIDES[preset].items():
        setattr(p, k, v)
    if tune:
        if tune not in _TUNE_OVERRIDES:
            raise ValueError(f"unknown tune {tune!r} (choose from {TUNES})")
        for k, v in _TUNE_OVERRIDES[tune].items():
            setattr(p, k, v)
    for k, v in overrides.items():
        if not hasattr(p, k):
            raise ValueError(f"unknown parameter {k!r}")
        setattr(p, k, v)
    return p


_PARSE_ALIASES = {
    # CLI spelling -> field name (subset; grows with x265_param_parse parity)
    "input-res": None,  # handled specially ("WxH")
    "ctu": "ctu_size",
    "min-cu-size": "min_cu_size",
    "max-tu-size": "max_tu_size",
    "rd": "rd_level",
    "me": "me",
    "subme": "subme",
    "merange": "me_range",
    "ref": "ref",
    "bframes": "bframes",
    "b-adapt": "b_adapt",
    "keyint": "keyint_max",
    "min-keyint": "keyint_min",
    "rc-lookahead": "rc_lookahead",
    "qp": "qp",
    "crf": "crf",
    "bitrate": "bitrate",
    "aq-mode": "aq_mode",
    "aq-strength": "aq_strength",
    "qg-size": "qg_size",
    "cutree": "cu_tree",
    "sao": "sao",
    "signhide": "sign_hide",
    "rdoq-level": "rdoq_level",
    "psy-rd": "psy_rd",
    "psy-rdoq": "psy_rdoq",
    "weightp": "weightp",
    "weightb": "weightb",
    "wpp": "wavefront",
    "hash": "decoded_picture_hash",
    "lossless": "lossless",
    "tskip": "tskip",
    "early-skip": "early_skip",
    "fast-intra": "fast_intra",
    "strong-intra-smoothing": "strong_intra_smoothing",
    "constrained-intra": "constrained_intra",
    "open-gop": "open_gop",
    "b-pyramid": "b_pyramid",
    "interlace": "interlace_mode",
    "repeat-headers": "repeat_headers",
    "aud": "aud",
    "hrd": "hrd",
    "ssim": "ssim",
    "psnr": "psnr",
    "deblock": "deblock",
    "vbv-bufsize": "vbv_buffer_size",
    "vbv-maxrate": "vbv_max_bitrate",
    "vbv-init": "vbv_buffer_init",
    "ipratio": "ip_factor",
    "pbratio": "pb_factor",
    "qcomp": "qcomp",
    "qpstep": "qp_step",
    "scenecut": "scenecut_threshold",
    "pass": "stats_pass",
    "stats": "stats_file",
    "qblur": "qblur",
    "cplxblur": "cplxblur",
    "max-merge": "max_merge",
    "nr-intra": "noise_reduction_intra",
    "nr-inter": "noise_reduction_inter",
    "temporal-mvp": "temporal_mvp",
    "tu-intra-depth": "tu_intra_depth",
    "tu-inter-depth": "tu_inter_depth",
    "limit-refs": "limit_refs",
    "limit-modes": "limit_modes",
    "rect": "rect",
    "amp": "amp",
    "b-intra": "b_intra",
    "cu-lossless": "cu_lossless",
    "profile": "profile",
    "level-idc": "level_idc",
    "high-tier": "high_tier",
    "range": "video_full_range",
    "videoformat": "video_format",
    "colorprim": "colorprim",
    "transfer": "transfer",
    "colormatrix": "colormatrix",
    "chromaloc": "chromaloc",
    "master-display": "master_display",
    "max-cll": "max_cll",
    "zones": "zones",
    "qpfile": "qpfile",
    "sar": None,  # handled specially ("W:H" or an index name)
    "fps": None,  # handled specially
}

# VUI name tables (x265cli.h / Annex E code points)
_COLORPRIM = ["reserved", "bt709", "undef", "reserved", "bt470m",
              "bt470bg", "smpte170m", "smpte240m", "film", "bt2020"]
_TRANSFER = ["reserved", "bt709", "undef", "reserved", "bt470m",
             "bt470bg", "smpte170m", "smpte240m", "linear", "log100",
             "log316", "iec61966-2-4", "bt1361e", "iec61966-2-1",
             "bt2020-10", "bt2020-12", "smpte-st-2084", "smpte-st-428",
             "arib-std-b67"]
_COLORMATRIX = ["GBR", "bt709", "undef", "reserved", "fcc", "bt470bg",
                "smpte170m", "smpte240m", "YCgCo", "bt2020nc", "bt2020c"]
_VIDEOFORMAT = ["component", "pal", "ntsc", "secam", "mac", "undef"]


# ---------------------------------------------------------------------------
# Honesty layer: options x265 honors that this engine does not (yet).
# x265 silently obeys everything in param.cpp; here anything accepted by
# param_parse but without engine effect is declared, and Encoder startup
# warns when the user set it away from the effective behavior — so
# "supported" vs "parsed-but-dropped" is always visible (VERDICT r02).
# Entries are removed as features land.
# ---------------------------------------------------------------------------

_UNSUPPORTED: dict[str, tuple[object, str]] = {
    # field: (effective value used by the engine, explanation)
    "rect": (False, "NxN/rect partitions not implemented (2NX2N only)"),
    "amp": (False, "asymmetric partitions not implemented"),
    "tskip": (False, "transform-skip not implemented"),
    "tskip_fast": (False, "transform-skip not implemented"),
    "cu_lossless": (False, "per-CU lossless trial not implemented"),
    # --lossless itself IS honored (all-intra transquant bypass)
    # --b-pyramid IS honored (middle B of each mini-GOP referenced)
    # --nr-intra/--nr-inter ARE honored (device denoiseDct + host
    # running-average update)
    "weightb": (False, "weighted bi-prediction not implemented"),
    "intra_refresh": (False, "periodic intra refresh not implemented"),
    "interlace_mode": (0, "field coding not implemented"),
    "temporal_layers": (1, "temporal sub-layers not implemented"),
    "rd_penalty": (0, "--rdpenalty not implemented"),
    "tu_intra_depth": (1, "TU quadtree depth fixed at 1"),
    "tu_inter_depth": (1, "TU quadtree depth fixed at 1"),
    "limit_refs": (0, "no effect (all refs always searched)"),
    "limit_modes": (False, "no effect (all modes always evaluated)"),
    "early_skip": (False, "no effect (batched full evaluation)"),
    "fast_intra": (False, "no effect (all-modes batch is free)"),
    "b_intra": (False, "no effect"),
    "qblur": (0.5, "2-pass qp blur not implemented"),
    "constrained_intra": (False, "constrained intra pred not implemented"),
    "rd_level": (3, "no effect (single fixed analysis path)"),
    "me": (ME_HEX, "search method fixed (hierarchical coarse + full "
           "local search)"),
    # --subme IS honored (0 = full-pel, 1 = +half, >= 2 = +quarter)
}


def unsupported_param_warnings(p: Params) -> list[str]:
    """Warnings for options set away from the engine's effective behavior
    (x265_log analogue of param.cpp's config validation).

    Only USER deviations warn: a field still at its library default is
    silently coerced to the effective value (matching the reference's
    param.cpp behavior) — otherwise every default-config Encoder()
    would print warnings for unimplemented default-on features."""
    defaults = {f.name: f.default for f in dataclasses.fields(Params)}
    out = []
    for fname, (effective, why) in _UNSUPPORTED.items():
        val = getattr(p, fname)
        if val != effective and val != defaults.get(fname):
            out.append(f"x265_tpu [warning]: --{fname.replace('_', '-')}"
                       f"={val!r} not honored: {why}; using {effective!r}")
    return out


def param_parse(p: Params, name: str, value: str | None = None) -> None:
    """x265_param_parse equivalent: set one option by CLI name.

    Supports the ``no-`` prefix for booleans and name=value strings.
    """
    if value is None and "=" in name:
        name, value = name.split("=", 1)
    negated = False
    if name.startswith("no-"):
        negated = True
        name = name[3:]
    if name == "input-res":
        w, h = value.lower().split("x")
        p.source_width, p.source_height = int(w), int(h)
        return
    if name == "fps":
        if "/" in value:
            n, d = value.split("/")
            p.fps_num, p.fps_denom = int(n), int(d)
        else:
            f = float(value)
            if f == int(f):
                p.fps_num, p.fps_denom = int(f), 1
            else:
                p.fps_num, p.fps_denom = int(round(f * 1000)), 1000
        return
    if name == "preset":
        newp = default_params(value)
        for f in dataclasses.fields(Params):
            setattr(p, f.name, getattr(newp, f.name))
        return
    if name == "me" and value in ME_NAMES:
        p.me = ME_NAMES.index(value)
        return
    if name in ("qp", "crf", "bitrate"):
        p.rc_mode = {"qp": RC_CQP, "crf": RC_CRF, "bitrate": RC_ABR}[name]
        setattr(p, _PARSE_ALIASES[name], type(getattr(p, _PARSE_ALIASES[name]))(value))
        return
    if name == "sar":
        sep = ":" if ":" in value else "x"
        a, b = value.split(sep)
        p.sar_width, p.sar_height = int(a), int(b)
        return
    if name in ("colorprim", "transfer", "colormatrix", "videoformat") \
            and value is not None and not value.lstrip("-").isdigit():
        table = {"colorprim": _COLORPRIM, "transfer": _TRANSFER,
                 "colormatrix": _COLORMATRIX,
                 "videoformat": _VIDEOFORMAT}[name]
        field_n = {"videoformat": "video_format"}.get(name, name)
        setattr(p, field_n, table.index(value))
        return
    if name == "range" and value in ("full", "limited"):
        p.video_full_range = value == "full"
        return
    if name == "hash" and value is not None and not value.isdigit():
        p.decoded_picture_hash = {"md5": HASH_MD5, "crc": HASH_CRC,
                                  "checksum": HASH_CHECKSUM}[value.lower()]
        return
    field_name = _PARSE_ALIASES.get(name, name.replace("-", "_"))
    if field_name is None or not hasattr(p, field_name):
        raise ValueError(f"unknown option --{name}")
    cur = getattr(p, field_name)
    if isinstance(cur, bool):
        if negated:
            setattr(p, field_name, False)
        elif value is None or value in ("1", "true", "yes"):
            setattr(p, field_name, True)
        else:
            setattr(p, field_name, False)
    elif isinstance(cur, int):
        setattr(p, field_name, int(value))
    elif isinstance(cur, float):
        setattr(p, field_name, float(value))
    else:
        setattr(p, field_name, value)
