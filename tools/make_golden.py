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
  CABAC, ~1 min a frame);
* ``x265_tpu_torch/data/golden_1080p_gop_parallel.json``: the gop_parallel
  slice (24 frames, 8 closed IPPP GOPs of 3) through the reference's own
  ``x265_tpu.parallel.gop.encode_gop_parallel`` on a mesh of 8 virtual CPU
  devices (``--xla_force_host_platform_device_count=8``, set here before
  JAX starts when this golden is asked for);
* ``x265_tpu_torch/data/golden_1080p_wavefront.json``: the MD5s of the
  reference ``WavefrontIntraRecon``'s recon plane and levels on
  ``smoke_wavefront_inputs`` (luma 16x16 and Cb 8x8 blocks at
  1920x1088);
* ``x265_tpu_torch/data/golden_1080p_rqt.json``: the MD5s of the outputs
  (``smoke_config.scan_digests``) of the reference ``CtuScan``'s P scan
  with the inter RQT split (``scan_fn(inter=True, decide32=True,
  rqt=True)``, psy-rd 2.0, sign hiding, strong intra smoothing, 8 bits,
  CTB 64) on ``smoke_config.scan_frame(1)`` (1920x1088 seeded inputs,
  ``chip_smoke.k1_inputs``' first frame), and the number of blocks coded
  with the split (``rqt``: ~4 min, ~3 GB);
* ``x265_tpu_torch/data/golden_1080p_decode.json``: the reference's
  decoder (``x265_tpu.decoder.decode_annexb``) on the reference's own
  streams of the bench slice, the Main10 bench slice (each checked
  against its encode golden) and the intra16 stream (two all-intra
  frames at CTU 16 without AQ, ``Encoder.encode_frame``; its MD5 and
  sizes are recorded here): each picture's POC in output order, hash
  check, QP and the MD5 of each cropped plane (uint8, or little-endian
  uint16 at 10 bits).

The last four also record each access unit's size and the encode-order
POCs and kinds (from the reference's ``Encoder._finish_one``).

    JAX_PLATFORMS=cpu python tools/make_golden.py [ippp] [b] [bench] \
        [bench10] [slow] [nr] [superfast] [ultrafast] [ctu16] [crf_cli] \
        [abr_vbv_hrd] [twopass] [lossless] \
        [gop_parallel] [wavefront] [decode] [rqt]

With no argument it writes all seventeen.
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


def gop_parallel():
    import jax

    from x265_tpu.common.params import Params
    from x265_tpu.parallel.gop import encode_gop_parallel
    from x265_tpu_torch import smoke_config as sc

    assert len(jax.devices()) == sc.GOPS, jax.devices()
    params = sc.smoke_params_gop_parallel()
    log, undo = _recording()
    try:
        stream = encode_gop_parallel(sc.smoke_frames_gop_parallel(),
                                     Params(**params))
    finally:
        undo()
    _write_stream("golden_1080p_gop_parallel.json",
                  dict(params, n_gops=sc.GOPS), stream, log)


def wavefront():
    import numpy as np

    from x265_tpu.encoder.wavefront import WavefrontIntraRecon
    from x265_tpu_torch import smoke_config as sc

    x = sc.smoke_wavefront_inputs()
    out = dict(width=x["width"], height=x["height"],
               made_by="x265_tpu on the CPU (tools/make_golden.py)")
    for name, n, luma in (("y", 16, True), ("cb", 8, False)):
        blocks, modes, qp = x[name]
        wf = WavefrontIntraRecon(x["width"], x["height"], 6, n, is_luma=luma,
                                 chroma_shift=0 if luma else 1)
        plane, levels = (np.asarray(a) for a in wf.encode(blocks, modes, qp))
        dec = np.asarray(wf.decode(levels, modes, qp))
        assert np.array_equal(dec, plane)
        out[name] = dict(n=n, qp=qp, levels=int(wf.sched["n_levels"]),
                         plane_md5=hashlib.md5(plane.tobytes()).hexdigest(),
                         levels_md5=hashlib.md5(
                             levels.astype("<i2").tobytes()).hexdigest(),
                         plane_dtype=str(plane.dtype),
                         nonzero_levels=int((levels != 0).sum()))
    with open(os.path.join(DATA, "golden_1080p_wavefront.json"), "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps(out))


def rqt():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from x265_tpu.common.geometry import PictureGeometry
    from x265_tpu.encoder.ctu_scan import CtuScan
    from x265_tpu_torch import smoke_config as sc

    opts = dict(bit_depth=8, sign_hide=True, strong_intra_smoothing=True,
                psy_rd=2.0)
    scan = CtuScan(PictureGeometry(1920, 1088, 6, 3), **opts)
    fn = jax.jit(scan.scan_fn(inter=True, decide32=True, rqt=True))
    x = {k: jnp.asarray(v) for k, v in sc.scan_frame(1).items()}
    outs = fn(x["oy"], x["ocb"], x["ocr"], x["modes"], x["mode32"],
              x["use32"], x["qp"], x["qp"], x["qp"], lam=x["lam"],
              is_inter=x["is_inter"], ipred_y=x["ipred_y"],
              ipred_cb=x["ipred_cb"], ipred_cr=x["ipred_cr"],
              m32_in=x["m32_in"])
    outs = [None if o is None else np.asarray(o) for o in outs[:11]]
    out = dict(inputs="smoke_config.scan_frame(1): 1920x1088, CTB 64",
               options=dict(opts, inter=True, decide32=True, rqt=True),
               digests=sc.scan_digests(outs),
               split_blocks=int(outs[10].sum()),
               inter_blocks=int(np.asarray(x["is_inter"]).sum()),
               made_by="x265_tpu on the CPU (tools/make_golden.py)")
    with open(os.path.join(DATA, "golden_1080p_rqt.json"), "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps(out))


def _decode_record(stream):
    import time

    import numpy as np

    from x265_tpu.decoder import decode_annexb

    t0 = time.perf_counter()
    pics = decode_annexb(stream)
    secs = time.perf_counter() - t0
    assert pics and all(p.hash_ok is True for p in pics)
    out = []
    for p in pics:
        dt = np.uint8 if p.bit_depth == 8 else np.dtype("<u2")
        out.append(dict(poc=p.poc, hash_ok=p.hash_ok, qp=p.qp,
                        bit_depth=p.bit_depth, shape=list(p.planes[0].shape),
                        md5=[hashlib.md5(np.ascontiguousarray(
                            pl.astype(dt)).tobytes()).hexdigest()
                            for pl in p.planes]))
    print(f"decoded {len(pics)} pictures in {secs:.1f} s", flush=True)
    return out


def decode():
    from x265_tpu.common.params import Params
    from x265_tpu.encoder import Encoder
    from x265_tpu_torch import smoke_config as sc

    out = dict(made_by="x265_tpu on the CPU (tools/make_golden.py): "
                       "x265_tpu.decoder.decode_annexb")
    for name in ("bench", "bench10"):
        enc = Encoder(Params(**getattr(sc, f"smoke_params_{name}")()))
        efs = []
        for planes in getattr(sc, f"smoke_frames_{name}")():
            efs += enc.push_frame(planes)
        efs += enc.flush()
        stream = enc.headers() + b"".join(ef.au for ef in efs)
        md5 = hashlib.md5(stream).hexdigest()
        with open(os.path.join(DATA, f"golden_1080p_{name}.json")) as f:
            assert md5 == json.load(f)["md5"], name
        out[name] = dict(md5=md5, total_bytes=len(stream),
                         pictures=_decode_record(stream))
    params = sc.smoke_params_intra16()
    enc = Encoder(Params(**params))
    aus = [enc.headers()]
    for planes in sc.smoke_frames_intra16():
        aus.append(enc.encode_frame(planes)[0])
    stream = b"".join(aus)
    out["intra16"] = dict(params=params, md5=hashlib.md5(stream).hexdigest(),
                          total_bytes=len(stream),
                          au_bytes=[len(a) for a in aus],
                          pictures=_decode_record(stream))
    with open(os.path.join(DATA, "golden_1080p_decode.json"), "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({k: v for k, v in out.items() if k != "made_by"}))


if __name__ == "__main__":
    which = sys.argv[1:] or ["ippp", "b", "bench", "bench10", "slow", "nr",
                             "superfast", "ultrafast", "ctu16", "crf_cli",
                             "abr_vbv_hrd", "twopass", "lossless",
                             "gop_parallel", "wavefront", "decode", "rqt"]
    if "gop_parallel" in which:
        # the reference shards the GOPs over a mesh: one virtual CPU
        # device per GOP, set before JAX starts
        from x265_tpu_torch.smoke_config import GOPS
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={GOPS}"
            ).strip()
    for name in which:
        dict(ippp=ippp, b=bslice, bench=bench, bench10=bench10, slow=slow,
             nr=nr, superfast=lambda: _preset("superfast"),
             ultrafast=lambda: _preset("ultrafast"), ctu16=ctu16,
             crf_cli=crf_cli, abr_vbv_hrd=abr_vbv_hrd, twopass=twopass,
             lossless=lossless, gop_parallel=gop_parallel,
             wavefront=wavefront, decode=decode, rqt=rqt)[name]()
