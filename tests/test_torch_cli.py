"""The port's user-facing surface against x265_tpu's: the x265-style
procedural API round trip and reconfig, the CLI in-process (``cli.main``)
on a small Y4M at CRF with ``--csv --ssim --recon`` and lossless (stream,
CSV text and recon file equal) and its ``--profile-dir`` trace, the Y4M /
YUV readers and writers at 8 and 10 bits and the Y4M colour-space tags,
SSIM (the numpy metric exactly, the torch ``ssim_plane`` against
``ssim_plane_jnp`` within float32 rounding) and the input dithering."""

import numpy as np
import pytest
import torch

import x265_tpu.api as ref_api
import x265_tpu.cli as ref_cli
import x265_tpu.io as ref_io
import x265_tpu.native as ref_native
import x265_tpu.ops.ssim as ref_ssim
from x265_tpu.decoder import decode_annexb
from x265_tpu_torch import api, cli, io
from x265_tpu_torch.native import dither_image
from x265_tpu_torch.ops import ssim
from x265_tpu_torch.smoke_config import synthetic_frame
from torch_threads import one_torch_thread  # noqa: F401

W, H = 64, 64


def _frames(n):
    base = synthetic_frame(W, H, 0)
    return [(np.roll(base[0], 3 * t, axis=1), base[1], base[2])
            for t in range(n)]


def _api_encode(mod, **open_kw):
    p = mod.x265_param_default_preset("medium")
    for name, value in (("qp", "30"), ("hash", "md5"), ("merange", "8"),
                        ("b-adapt", "0")):
        mod.x265_param_parse(p, name, value)
    p.source_width, p.source_height = W, H
    enc = mod.x265_encoder_open(p, **open_kw)
    stream = mod.x265_encoder_headers(enc)
    au, _rec = mod.x265_encoder_encode(enc, _frames(1)[0])
    stream += au
    # the lookahead buffers: flush with no picture until the AU arrives
    while not au:
        au, _rec = mod.x265_encoder_encode(enc, None)
        stream += au
    st = mod.x265_encoder_get_stats(enc)
    mod.x265_encoder_close(enc)
    return stream, (st.encoded_picture_count, st.accumulated_bits)


def test_procedural_api_roundtrip():
    """x265_param_default_preset / _parse, x265_encoder_open on the CPU,
    _headers, _encode until the delayed AU arrives, _get_stats: the
    reference's stream and stats."""
    want, want_st = _api_encode(ref_api)
    got, got_st = _api_encode(api, device="cpu")
    assert got == want
    assert got_st == want_st and got_st[0] == 1 and got_st[1] > 0
    assert decode_annexb(got)[0].hash_ok is True


def test_reconfig_matches_reference():
    """x265_encoder_reconfig swaps qp / crf / bitrate and refuses the
    rest, as the reference's does."""
    encs = []
    for mod, kw in ((ref_api, {}), (api, dict(device="cpu"))):
        p = mod.x265_param_default_preset("medium")
        p.source_width, p.source_height = W, H
        enc = mod.x265_encoder_open(p, **kw)
        mod.x265_encoder_reconfig(enc, qp=28, crf=20.0)
        with pytest.raises(ValueError):
            mod.x265_encoder_reconfig(enc, bframes=2)
        encs.append((enc.params.qp, enc.params.crf, enc.rc.mode))
    assert encs[1] == encs[0] and encs[1][:2] == (28, 20.0)


CLI_ARGS = {
    "crf": ["--crf", "28", "--bframes", "0", "--merange", "8", "--b-adapt",
            "0", "--hash", "md5", "--ssim", "--no-progress"],
    "lossless": ["--lossless", "--hash", "md5", "--no-progress"],
}


@pytest.mark.parametrize("case", list(CLI_ARGS))
def test_cli_matches_reference(case, tmp_path, capsys):
    """cli.main in-process on a 3-frame Y4M: the stream, the per-frame
    CSV and the recon Y4M equal the reference CLI's; the stream decodes
    with matching hashes; stderr ends with the encode summary."""
    frames = _frames(3)
    inp = tmp_path / "in.y4m"
    io.write_y4m(str(inp), frames, W, H)
    outs = {}
    for pkg, main, extra in (("ref", ref_cli.main, []),
                             ("port", cli.main, ["--device", "cpu"])):
        d = tmp_path / pkg
        d.mkdir()
        rc = main([str(inp), "-o", str(d / "out.265"), "--csv",
                   str(d / "log.csv"), "--recon", str(d / "rec.y4m")]
                  + CLI_ARGS[case] + extra)
        assert rc == 0
        outs[pkg] = [(d / f).read_bytes()
                     for f in ("out.265", "log.csv", "rec.y4m")]
    err = capsys.readouterr().err
    assert outs["port"][0] == outs["ref"][0]
    assert outs["port"][1].decode() == outs["ref"][1].decode()
    assert outs["port"][2] == outs["ref"][2]
    lines = outs["port"][1].decode().splitlines()
    assert len(lines) == 4 and ("ssim" in lines[0]) == (case == "crf")
    pics = decode_annexb(outs["port"][0])
    assert len(pics) == 3 and all(p.hash_ok for p in pics)
    assert err.count("encoded 3 frames (I ") == 2
    if case == "lossless":
        rec, _meta = io.read_y4m(str(tmp_path / "port" / "rec.y4m"))
        assert all(np.array_equal(a, b) for fa, fb in zip(frames, rec)
                   for a, b in zip(fa, fb))


def test_cli_profile_dir_writes_a_trace(tmp_path):
    """--profile-dir: a torch.profiler trace of the encode."""
    inp = tmp_path / "in.y4m"
    io.write_y4m(str(inp), _frames(1), W, H)
    prof = tmp_path / "prof"
    assert cli.main([str(inp), "-o", str(tmp_path / "out.265"),
                     "--lossless", "--no-progress", "--device", "cpu",
                     "--profile-dir", str(prof)]) == 0
    assert list(prof.glob("*.pt.trace.json"))


def _planes(bd, w=48, h=32, n=2, seed=3):
    rng = np.random.RandomState(seed)
    dt = np.uint8 if bd == 8 else np.uint16
    return [tuple(rng.randint(0, 1 << bd, s).astype(dt)
                  for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
            for _ in range(n)]


@pytest.mark.parametrize("fmt", ["y4m", "yuv"])
@pytest.mark.parametrize("bd", [8, 10])
def test_yuv_io_matches_reference(bd, fmt, tmp_path):
    """The writers' bytes and the readers' frames and metadata."""
    frames = _planes(bd)
    files = []
    for mod in (ref_io.y4m, io.y4m):
        path = str(tmp_path / f"{len(files)}.{fmt}")
        if fmt == "y4m":
            w = mod.Y4MWriter(path, 48, 32, 30000, 1001, bit_depth=bd)
        else:
            w = mod.YUVWriter(path, bd)
        for fr in frames:
            w.write(fr)
        w.close()
        files.append(path)
    assert open(files[0], "rb").read() == open(files[1], "rb").read()
    reads = []
    for mod in (ref_io.y4m, io.y4m):
        if fmt == "y4m":
            r = mod.Y4MReader(files[1])
            meta = (r.width, r.height, r.fps_num, r.fps_denom, r.csp,
                    r.bit_depth)
        else:
            r = mod.YUVReader(files[1], 48, 32, bit_depth=bd)
            meta = (r.width, r.height)
        reads.append((meta, list(r)))
        r.close()
    assert reads[1][0] == reads[0][0]
    assert len(reads[1][1]) == len(frames)
    for fa, fb, fr in zip(reads[0][1], reads[1][1], frames):
        for a, b, c in zip(fa, fb, fr):
            assert b.dtype == a.dtype and np.array_equal(a, b)
            assert np.array_equal(b, c)


@pytest.mark.parametrize("tag", ["420", "420jpeg", "420mpeg2", "420paldv",
                                 "420p10", "422", "444", "mono", "444p12"])
def test_y4m_colour_space_tags_match_reference(tag, tmp_path):
    path = tmp_path / "t.y4m"
    path.write_bytes(b"YUV4MPEG2 W16 H8 F25:1 Ip A1:1 C" + tag.encode()
                     + b"\nFRAME\n" + bytes(16 * 8 * 3 * 2))
    got = []
    for mod in (ref_io.y4m, io.y4m):
        r = mod.Y4MReader(str(path))
        fr = next(r)
        got.append((r.csp, r.bit_depth, r.sar, r.shapes,
                    [p.dtype for p in fr], [p.tobytes() for p in fr]))
        r.close()
    assert got[1] == got[0]


@pytest.mark.parametrize("bd", [8, 10])
def test_ssim_matches_reference(bd):
    """ssim_plane_np (float64) equal to the reference's; the torch
    ssim_plane within 2e-6 of ssim_plane_jnp (both float32, summed in
    different orders); ssim_db equal."""
    rng = np.random.RandomState(bd)
    a = rng.randint(0, 1 << bd, (72, 100)).astype(np.int64)
    b = np.clip(a + rng.randint(-9, 10, a.shape), 0, (1 << bd) - 1)
    want = ref_ssim.ssim_plane_np(a, b, bd)
    assert ssim.ssim_plane_np(a, b, bd) == want
    got_t = float(ssim.ssim_plane(torch.as_tensor(a), torch.as_tensor(b),
                                  bd))
    want_j = float(ref_ssim.ssim_plane_jnp(a, b, bd))
    assert abs(got_t - want_j) <= 2e-6
    assert abs(got_t - want) <= 2e-6
    assert ssim.ssim_db(want) == ref_ssim.ssim_db(want)


@pytest.mark.parametrize("src,dst", [(10, 8), (12, 8), (12, 10), (16, 8)])
def test_dither_matches_reference(src, dst):
    rng = np.random.RandomState(src + dst)
    planes = [rng.randint(0, 1 << src, s).astype(np.uint16)
              for s in ((24, 40), (12, 20), (12, 20))]
    want = ref_native.dither_image(planes, src, dst)
    got = dither_image(planes, src, dst)
    for a, b in zip(want, got):
        assert b.dtype == a.dtype and np.array_equal(a, b)
