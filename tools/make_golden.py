"""Write the golden digest of the 1080p IPPP slice that ``chip_smoke.py``
holds the port's stream against: ``x265_tpu`` (the JAX reference) encodes
the same frames with the same parameters on the CPU, and the MD5, the total
size and the size of each access unit go to
``x265_tpu_torch/data/golden_1080p_ippp.json``.

    JAX_PLATFORMS=cpu python tools/make_golden.py
"""

import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "x265_tpu_torch", "data", "golden_1080p_ippp.json")


def main():
    from x265_tpu.common.params import Params
    from x265_tpu.encoder import Encoder
    from x265_tpu_torch.smoke_config import smoke_frames, smoke_params

    p = Params(**smoke_params())
    enc = Encoder(p)
    aus = [enc.headers()]
    for planes in smoke_frames():
        au, _rec = enc.encode_frame(planes)
        aus.append(au)
    stream = b"".join(aus)
    out = dict(params=smoke_params(), frames=len(aus) - 1,
               md5=hashlib.md5(stream).hexdigest(),
               total_bytes=len(stream),
               au_bytes=[len(a) for a in aus],
               made_by="x265_tpu on the CPU (tools/make_golden.py)")
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
