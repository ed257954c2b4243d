"""Write the golden digests of the 1080p slices that ``chip_smoke.py``
holds the port's streams against: ``x265_tpu`` (the JAX reference) encodes
the same frames with the same parameters on the CPU, and the MD5, the total
size, the size of each access unit and the encode-order POCs go to

* ``x265_tpu_torch/data/golden_1080p_ippp.json``: the IPPP slice through
  ``Encoder.encode_frame`` (~2 min);
* ``x265_tpu_torch/data/golden_1080p_b.json``: the B slice (b-pyramid,
  lookahead off) through ``push_frame`` / ``flush``;
* ``x265_tpu_torch/data/golden_1080p_bench.json``: the bench slice
  (``bench.py``'s configuration and ten frames, the lookahead on) through
  ``push_frame`` / ``flush``, also with each frame's slice kind in encode
  order, so that the lookahead's choices are on record;
* ``x265_tpu_torch/data/golden_1080p_bench10.json``: the bench slice at
  Main10 (``internal_bit_depth=10``) on ten frames of 10-bit content,
  likewise with the encode order and kinds (the reference runs its jnp
  scan and refine at 10 bits);
* ``x265_tpu_torch/data/golden_1080p_slow.json``: the slow slice (the
  bench slice's frames at ``default_params("slow")``: RDOQ with psy-RDOQ,
  ``ref=4``), likewise with the encode order and kinds;
* ``x265_tpu_torch/data/golden_1080p_nr.json``: the NR slice (the B
  slice's configuration with ``noise_reduction_intra=noise_reduction_inter
  =600``, ten frames) through ``push_frame`` / ``flush``, with the encode
  order and kinds;
* ``x265_tpu_torch/data/golden_1080p_superfast.json`` and
  ``golden_1080p_ultrafast.json``: the bench slice's frames at
  ``default_params("superfast" | "ultrafast")`` (CTU 32, MD5 hash SEI)
  through ``push_frame`` / ``flush``, with the encode order and kinds;
* ``x265_tpu_torch/data/golden_1080p_ctu16.json``: the IPPP slice at
  ``ctu_size=16`` with the MD5 hash SEI through ``Encoder.encode_frame``;
* ``x265_tpu_torch/data/golden_1080p_crf_cli.json``: the reference's own
  CLI (``x265_tpu.cli.main``) at ``--crf 28`` on a Y4M of the bench
  slice's frames, with the CSV log's text;
* ``x265_tpu_torch/data/golden_1080p_abr_vbv_hrd.json``: the procedural
  API at ABR 1000 kbps with VBV 1000 kbps / 1000 kbit and HRD, with the
  payload types of each AU's prefix SEIs; it asserts that the VBV binds
  (the stream differs from the same ABR without VBV);
* ``x265_tpu_torch/data/golden_1080p_twopass.json``: 2-pass ABR at 1000
  kbps through ``encode_sequence``, with pass 1's stats file text;
* ``x265_tpu_torch/data/golden_1080p_lossless.json``: two lossless frames
  through ``encode_sequence`` (the reference codes them with its Python
  CABAC, ~1 min a frame).

The last four also record each access unit's size and the encode-order
POCs and kinds (from the reference's ``Encoder._finish_one``).

    JAX_PLATFORMS=cpu python tools/make_golden.py [ippp] [b] [bench] \
        [bench10] [slow] [nr] [superfast] [ultrafast] [ctu16] [crf_cli] \
        [abr_vbv_hrd] [twopass] [lossless]

With no argument it writes all thirteen.
"""

import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DATA = os.path.join(ROOT, "x265_tpu_torch", "data")


def _write(name, params, aus, pocs, kinds=None):
    stream = b"".join(aus)
    out = dict(params=params, frames=len(aus) - 1,
               md5=hashlib.md5(stream).hexdigest(),
               total_bytes=len(stream),
               au_bytes=[len(a) for a in aus],
               made_by="x265_tpu on the CPU (tools/make_golden.py)")
    if pocs is not None:
        out["encode_pocs"] = pocs
    if kinds is not None:
        out["encode_kinds"] = kinds
    with open(os.path.join(DATA, name), "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps(out))


def ippp(name="golden_1080p_ippp.json", params=None):
    from x265_tpu.common.params import Params
    from x265_tpu.encoder import Encoder
    from x265_tpu_torch.smoke_config import smoke_frames, smoke_params

    params = params or smoke_params()
    enc = Encoder(Params(**params))
    aus = [enc.headers()]
    for planes in smoke_frames():
        au, _rec = enc.encode_frame(planes)
        aus.append(au)
    _write(name, params, aus, None)


def ctu16():
    from x265_tpu_torch.smoke_config import smoke_params_ctu16

    ippp("golden_1080p_ctu16.json", smoke_params_ctu16())


def bslice():
    from x265_tpu.common.params import Params
    from x265_tpu.encoder import Encoder
    from x265_tpu_torch.smoke_config import smoke_frames_b, smoke_params_b

    enc = Encoder(Params(**smoke_params_b()))
    efs = []
    for planes in smoke_frames_b():
        efs += enc.push_frame(planes)
    efs += enc.flush()
    _write("golden_1080p_b.json", smoke_params_b(),
           [enc.headers()] + [ef.au for ef in efs], [ef.poc for ef in efs])


def nr():
    from x265_tpu_torch.smoke_config import smoke_frames_nr, smoke_params_nr

    _bench("golden_1080p_nr.json", smoke_params_nr(), smoke_frames_nr())


def _bench(name, params, frames):
    from x265_tpu.common.params import Params
    from x265_tpu.encoder import Encoder

    enc = Encoder(Params(**params))
    efs = []
    for planes in frames:
        efs += enc.push_frame(planes)
    efs += enc.flush()
    _write(name, params, [enc.headers()] + [ef.au for ef in efs],
           [ef.poc for ef in efs], [ef.kind for ef in efs])


def bench():
    from x265_tpu_torch.smoke_config import (smoke_frames_bench,
                                             smoke_params_bench)

    _bench("golden_1080p_bench.json", smoke_params_bench(),
           smoke_frames_bench())


def bench10():
    from x265_tpu_torch.smoke_config import (smoke_frames_bench10,
                                             smoke_params_bench10)

    _bench("golden_1080p_bench10.json", smoke_params_bench10(),
           smoke_frames_bench10())


def slow():
    from x265_tpu.common.params import default_params
    from x265_tpu_torch.smoke_config import (smoke_frames_slow,
                                             smoke_params_bench,
                                             smoke_params_slow)

    # the reference's own preset table, checked against the port's copy
    ref = default_params("slow", **smoke_params_bench())
    params = smoke_params_slow()
    assert all(getattr(ref, k) == v for k, v in params.items())
    _bench("golden_1080p_slow.json", params, smoke_frames_slow())


def _preset(preset):
    from x265_tpu.common.params import default_params
    from x265_tpu_torch import smoke_config as sc

    params = getattr(sc, f"smoke_params_{preset}")()
    # the reference's own preset table, checked against the port's copy
    ref = default_params(preset, qp=32, decoded_picture_hash=1,
                         source_width=sc.WIDTH, source_height=sc.HEIGHT)
    assert all(getattr(ref, k) == v for k, v in params.items())
    _bench(f"golden_1080p_{preset}.json", params,
           getattr(sc, f"smoke_frames_{preset}")())


def _recording():
    """Record every EncodedFrame that the reference's Encoder finishes
    (in encode order); returns the list and a function that unwraps."""
    from x265_tpu.encoder import intra_encoder

    real = intra_encoder.Encoder._finish_one
    log = []

    def finish(self, pend):
        ef = real(self, pend)
        if not log or log[-1] is not ef:
            log.append(ef)
        return ef

    intra_encoder.Encoder._finish_one = finish
    return log, lambda: setattr(intra_encoder.Encoder, "_finish_one", real)


def _write_stream(name, params, stream, efs, **extra):
    out = dict(params=params, frames=len(efs),
               md5=hashlib.md5(stream).hexdigest(), total_bytes=len(stream),
               au_bytes=[len(ef.au) for ef in efs],
               encode_pocs=[ef.poc for ef in efs],
               encode_kinds=[ef.kind for ef in efs], **extra,
               made_by="x265_tpu on the CPU (tools/make_golden.py)")
    assert len(stream) - sum(out["au_bytes"]) > 0      # the headers
    with open(os.path.join(DATA, name), "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({k: v for k, v in out.items() if k != "stats"}))


def crf_cli():
    import tempfile

    from x265_tpu import cli
    from x265_tpu.io import write_y4m
    from x265_tpu_torch import smoke_config as sc

    with tempfile.TemporaryDirectory() as tmp:
        y4m, out, csv = (os.path.join(tmp, f)
                         for f in ("in.y4m", "out.265", "log.csv"))
        write_y4m(y4m, sc.smoke_frames_bench(), sc.WIDTH, sc.HEIGHT)
        log, undo = _recording()
        try:
            assert cli.main(sc.smoke_args_crf_cli(y4m, out, csv)) == 0
        finally:
            undo()
        with open(out, "rb") as f:
            stream = f.read()
        with open(csv) as f:
            csv_text = f.read()
    _write_stream("golden_1080p_crf_cli.json",
                  sc.smoke_args_crf_cli("in.y4m", "out.265", "log.csv"),
                  stream, log, csv=csv_text)


def _sei_payload_types(au):
    """The payload types of each prefix SEI NAL (type 39) of an AU."""
    from x265_tpu.common.sei import parse_sei_rbsp

    out = []
    for nal in au.split(b"\x00\x00\x01")[1:]:
        nal = nal.rstrip(b"\x00")
        if (nal[0] >> 1) & 0x3F == 39:
            rbsp = nal[2:].replace(b"\x00\x00\x03", b"\x00\x00")
            out.append([t for t, _p in parse_sei_rbsp(rbsp)])
    return out


def _api_encode(parse):
    from x265_tpu import api
    from x265_tpu_torch import smoke_config as sc

    p = api.x265_param_default_preset("medium")
    for name, value in parse:
        api.x265_param_parse(p, name, value)
    p.source_width, p.source_height = sc.WIDTH, sc.HEIGHT
    enc = api.x265_encoder_open(p)
    aus = [api.x265_encoder_headers(enc)]
    for planes in sc.smoke_frames_bench() + [None] * 64:
        au, _rec = api.x265_encoder_encode(enc, planes)
        if planes is None and not au:
            break
        aus.append(au)
    return [a for a in aus if a]


def abr_vbv_hrd():
    from x265_tpu_torch import smoke_config as sc

    parse = sc.smoke_parse_abr_vbv_hrd()
    log, undo = _recording()
    try:
        aus = _api_encode(parse)
    finally:
        undo()
    stream = b"".join(aus)
    # the VBV must bind: the same ABR without it gives another stream
    plain = b"".join(_api_encode([kv for kv in parse
                                  if kv[0] in ("bitrate", "hash")]))
    assert plain != stream, "the VBV does not bind at these rates"
    _write_stream("golden_1080p_abr_vbv_hrd.json", parse, stream, log,
                  sei_types=[_sei_payload_types(a) for a in aus[1:]],
                  md5_without_vbv=hashlib.md5(plain).hexdigest())


def twopass():
    import tempfile

    from x265_tpu.common.params import Params
    from x265_tpu.encoder import encode_sequence
    from x265_tpu_torch import smoke_config as sc

    frames = sc.smoke_frames_bench()
    with tempfile.TemporaryDirectory() as tmp:
        stats = os.path.join(tmp, "2pass.log")
        s1, _ = encode_sequence(frames,
                                Params(**sc.smoke_params_twopass(stats, 1)))
        with open(stats) as f:
            text = f.read()
        log, undo = _recording()
        try:
            s2, _ = encode_sequence(
                frames, Params(**sc.smoke_params_twopass(stats, 2)))
        finally:
            undo()
    params = sc.smoke_params_twopass("2pass.log", 2)
    _write_stream("golden_1080p_twopass.json", params, s2, log, stats=text,
                  md5_pass1=hashlib.md5(s1).hexdigest())


def lossless():
    from x265_tpu.common.params import Params
    from x265_tpu.encoder import encode_sequence
    from x265_tpu_torch import smoke_config as sc

    log, undo = _recording()
    try:
        stream, recons = encode_sequence(
            sc.smoke_frames_lossless(), Params(**sc.smoke_params_lossless()))
    finally:
        undo()
    for fr, rec in zip(sc.smoke_frames_lossless(), recons):
        assert all((a == b).all() for a, b in zip(fr, rec))
    _write_stream("golden_1080p_lossless.json", sc.smoke_params_lossless(),
                  stream, log)


if __name__ == "__main__":
    which = sys.argv[1:] or ["ippp", "b", "bench", "bench10", "slow", "nr",
                             "superfast", "ultrafast", "ctu16", "crf_cli",
                             "abr_vbv_hrd", "twopass", "lossless"]
    for name in which:
        dict(ippp=ippp, b=bslice, bench=bench, bench10=bench10, slow=slow,
             nr=nr, superfast=lambda: _preset("superfast"),
             ultrafast=lambda: _preset("ultrafast"), ctu16=ctu16,
             crf_cli=crf_cli, abr_vbv_hrd=abr_vbv_hrd, twopass=twopass,
             lossless=lossless)[name]()
