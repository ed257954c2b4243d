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
  ``ctu_size=16`` with the MD5 hash SEI through ``Encoder.encode_frame``.

    JAX_PLATFORMS=cpu python tools/make_golden.py [ippp] [b] [bench] \
        [bench10] [slow] [nr] [superfast] [ultrafast] [ctu16]

With no argument it writes all nine.
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


if __name__ == "__main__":
    which = sys.argv[1:] or ["ippp", "b", "bench", "bench10", "slow", "nr",
                             "superfast", "ultrafast", "ctu16"]
    for name in which:
        dict(ippp=ippp, b=bslice, bench=bench, bench10=bench10, slow=slow,
             nr=nr, superfast=lambda: _preset("superfast"),
             ultrafast=lambda: _preset("ultrafast"), ctu16=ctu16)[name]()
