"""Y4M / raw-YUV file input and output — a copy of ``x265_tpu/io/y4m.py``.

Frames are (Y, Cb, Cr) tuples of numpy arrays (uint8 for 8-bit, uint16 for
>8-bit), Y at full res and chroma subsampled per the colorspace.
"""

from __future__ import annotations

import re

import numpy as np

CSP_SUBSAMPLING = {  # csp name -> (sub_w_shift, sub_h_shift) or None for mono
    "420": (1, 1), "422": (1, 0), "444": (0, 0), "mono": None,
}


def _plane_shapes(width, height, csp):
    sub = CSP_SUBSAMPLING[csp]
    if sub is None:
        return [(height, width)]
    sw, sh = sub
    return [(height, width),
            (height >> sh, width >> sw),
            (height >> sh, width >> sw)]


class Y4MReader:
    """Parses a YUV4MPEG2 stream (8- or 10/16-bit via C420p10 etc.)."""

    def __init__(self, path: str):
        self.f = open(path, "rb")
        header = self.f.readline().decode("ascii", "replace").strip()
        if not header.startswith("YUV4MPEG2"):
            raise ValueError("not a Y4M file")
        self.width = self.height = 0
        self.fps_num, self.fps_denom = 25, 1
        self.csp, self.bit_depth = "420", 8
        self.sar = "0:0"
        for tok in header.split()[1:]:
            key, val = tok[0], tok[1:]
            if key == "W":
                self.width = int(val)
            elif key == "H":
                self.height = int(val)
            elif key == "F":
                n, d = val.split(":")
                self.fps_num, self.fps_denom = int(n), int(d)
            elif key == "A":
                self.sar = val
            elif key == "C":
                # forms: 420 / 420mpeg2 / 420paldv / 420jpeg / 422 / 444 /
                # mono, optionally followed by p<depth> (e.g. 420p10)
                m = re.match(r"^(mono|420|422|444)([a-z]*?)(?:p(\d+))?$", val)
                if m:
                    self.csp = m.group(1)
                    if m.group(3):
                        self.bit_depth = int(m.group(3))
        self.dtype = np.uint8 if self.bit_depth == 8 else np.uint16
        self.shapes = _plane_shapes(self.width, self.height, self.csp)

    def __iter__(self):
        return self

    def __next__(self):
        line = self.f.readline()
        if not line:
            raise StopIteration
        if not line.startswith(b"FRAME"):
            raise ValueError("bad frame marker: %r" % line[:16])
        planes = []
        for shape in self.shapes:
            count = shape[0] * shape[1]
            buf = self.f.read(count * self.dtype().itemsize)
            if len(buf) < count * self.dtype().itemsize:
                raise StopIteration
            planes.append(np.frombuffer(buf, self.dtype).reshape(shape))
        return tuple(planes)

    def close(self):
        self.f.close()


class Y4MWriter:
    def __init__(self, path: str, width: int, height: int, fps_num: int = 25,
                 fps_denom: int = 1, csp: str = "420", bit_depth: int = 8):
        self.f = open(path, "wb")
        c = csp + ("p%d" % bit_depth if bit_depth > 8 else "")
        if csp == "420" and bit_depth == 8:
            c = "420mpeg2"
        self.f.write(b"YUV4MPEG2 W%d H%d F%d:%d Ip A0:0 C%s\n"
                     % (width, height, fps_num, fps_denom, c.encode()))
        self.dtype = np.uint8 if bit_depth == 8 else np.uint16

    def write(self, planes) -> None:
        self.f.write(b"FRAME\n")
        for p in planes:
            self.f.write(np.ascontiguousarray(p, dtype=self.dtype).tobytes())

    def close(self):
        self.f.close()


class YUVReader:
    """Raw planar YUV (requires explicit geometry, like --input-res)."""

    def __init__(self, path: str, width: int, height: int, csp: str = "420",
                 bit_depth: int = 8):
        self.f = open(path, "rb")
        self.width, self.height = width, height
        self.dtype = np.uint8 if bit_depth == 8 else np.uint16
        self.shapes = _plane_shapes(width, height, csp)

    def __iter__(self):
        return self

    def __next__(self):
        planes = []
        for shape in self.shapes:
            count = shape[0] * shape[1] * self.dtype().itemsize
            buf = self.f.read(count)
            if len(buf) < count:
                raise StopIteration
            planes.append(np.frombuffer(buf, self.dtype).reshape(shape))
        return tuple(planes)

    def close(self):
        self.f.close()


class YUVWriter:
    def __init__(self, path: str, bit_depth: int = 8):
        self.f = open(path, "wb")
        self.dtype = np.uint8 if bit_depth == 8 else np.uint16

    def write(self, planes) -> None:
        for p in planes:
            self.f.write(np.ascontiguousarray(p, dtype=self.dtype).tobytes())

    def close(self):
        self.f.close()


def read_y4m(path: str, max_frames: int | None = None):
    """Convenience: returns (frames, meta dict)."""
    r = Y4MReader(path)
    frames = []
    for i, fr in enumerate(r):
        if max_frames is not None and i >= max_frames:
            break
        frames.append(fr)
    meta = dict(width=r.width, height=r.height, fps_num=r.fps_num,
                fps_denom=r.fps_denom, csp=r.csp, bit_depth=r.bit_depth)
    r.close()
    return frames, meta


def write_y4m(path: str, frames, width: int, height: int, **kw):
    w = Y4MWriter(path, width, height, **kw)
    for fr in frames:
        w.write(fr)
    w.close()
