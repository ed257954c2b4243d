"""Seeded video content for the benchmark's traffic: the frozen generator.

A pool of 4:2:0 8-bit frames is made from the run's seed and a traffic
file's parameters, in bulk, on the device the caller names, then copied
to the host once.  The recipe starts from the encoder port's
``smoke_config.synthetic_frame`` (smooth structures + texture + noise)
and adds what real footage makes an encoder do:

* shots: each shot is its own seeded canvas, larger than the picture,
  panned at the shot's own speed (a camera pan); a cut starts the next
  shot, so an encoder with scene-cut detection opens a new GOP there;
* 2-6 seeded textured objects per shot, each moving at its own speed and
  drawn in a fixed depth order, so they occlude each other and the
  background;
* fresh noise of +-``noise`` luma levels in every frame, as a camera's
  sensor gives.

Pan speeds and object counts come from evenly spaced ladders over the
ranges that the traffic file gives, in the same order for every seed;
each shot's object speeds and sizes from ladders dealt to its objects in
an order drawn from the seed.  So every seed cuts at the same frames and
puts the same amount of motion at the same frames; directions, positions
and textures differ.  The structure is drawn on the host (Python's ``random``);
the pixels come from a ``torch.Generator`` on the device, so one seed on
one device gives the same frames bit for bit.
"""

from __future__ import annotations

import hashlib
import math
import random
from dataclasses import dataclass

import torch


def sub_seed(seed: int, what: str) -> int:
    """A 63-bit seed for one purpose, drawn from the run's seed (any
    integer, also beyond 32 bits)."""
    h = hashlib.sha256(f"{int(seed)}:{what}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def ladder(lo: float, hi: float, n: int) -> list:
    """``n`` evenly spaced values from ``lo`` to ``hi``."""
    if n == 1:
        return [(lo + hi) / 2]
    return [lo + (hi - lo) * i / (n - 1) for i in range(n)]


@dataclass
class Shot:
    start: int          # first pool frame
    frames: int
    segments: list      # [(first frame in shot, pan (vy, vx) px/frame)]
    objects: list       # [(h, w, y0, x0, vy, vx, stripe period, level)]
    scale: float        # of the canvas's structures


def plan(traffic: dict, width: int, height: int, seed: int) -> list:
    """The shots of the pool: cut positions from the traffic file; pan
    speeds a shot (or a segment) and object counts from ladders over the
    file's ranges, in pool order, so that every seed puts the same motion
    at the same frames; each shot's object sizes and speeds from ladders
    dealt to its objects in a seeded order; directions and positions
    drawn from the seed."""
    rng = random.Random(sub_seed(seed, "plan"))
    pool = int(traffic["pool_frames"])
    lengths = list(traffic.get("shot_frames") or [pool])
    shots, start, i = [], 0, 0
    while start < pool:
        n = min(int(lengths[i % len(lengths)]), pool - start)
        shots.append((start, n))
        start += n
        i += 1
    seg_len = int(traffic.get("segment_frames") or pool)
    n_seg = sum(math.ceil(n / seg_len) for _, n in shots)
    pans = _spread(ladder(*traffic["pan_px"], n_seg))
    counts = _spread([round(c) for c in
                      ladder(*traffic["objects"], len(shots))])
    out = []
    for (start, n), count in zip(shots, counts):
        segs = []
        for k in range(0, n, seg_len):
            a = rng.uniform(0, 2 * math.pi)
            s = pans.pop(0)
            segs.append((k, (s * math.sin(a), s * math.cos(a))))
        speeds = ladder(*traffic["object_px"], count)
        hs = ladder(height // 8, height // 2, count)
        ws = ladder(width // 10, width // 3, count)
        periods = ladder(6, 20, count)
        levels = ladder(60, 190, count)
        for lst in (speeds, hs, ws, periods, levels):
            rng.shuffle(lst)
        objs = []
        for s, h, w, p, lv in zip(speeds, hs, ws, periods, levels):
            h, w = int(h) & ~1, int(w) & ~1
            a = rng.uniform(0, 2 * math.pi)
            objs.append((h, w, rng.randrange(0, height - h),
                         rng.randrange(0, width - w), s * math.sin(a),
                         s * math.cos(a), p, lv))
        out.append(Shot(start, n, segs, objs, _SCALES[len(out) % 3]))
    return out


# the canvas's structure scales, shot by shot
_SCALES = (1.0, 0.8, 1.25)


def _spread(values: list) -> list:
    """A ladder reordered so that neighbours differ: from the middle
    outwards, above before below (the same order for every seed)."""
    v = sorted(values)
    mid = len(v) // 2
    return [v[i] for i in sorted(range(len(v)),
                                 key=lambda i: (abs(i - mid), i < mid))]


def _path(shot: Shot) -> list:
    """The pan's integer offset (y, x) at each frame of the shot."""
    pos, y, x = [], 0.0, 0.0
    segs = shot.segments + [(shot.frames, None)]
    for (k0, (vy, vx)), (k1, _) in zip(segs, segs[1:]):
        for _ in range(k0, k1):
            pos.append((round(y), round(x)))
            y, x = y + vy, x + vx
    return pos


def _bounce(p0: float, v: float, t: int, span: int) -> int:
    """Position at frame ``t`` of a point moving at ``v`` inside
    [0, span], reflected at the ends."""
    if span <= 0:
        return 0
    q = (p0 + v * t) % (2 * span)
    return round(q if q <= span else 2 * span - q)


def _canvas(h: int, w: int, scale: float, g: torch.Generator,
            dev) -> torch.Tensor:
    """One shot's background (float luma): ``synthetic_frame``'s smooth
    structures at the shot's scale and seeded phases, with its texture."""
    r = torch.rand(3, generator=g, device=dev, dtype=torch.float64)
    yy = torch.arange(h, device=dev, dtype=torch.float64)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float64)[None, :]
    p1, p2, p3 = 41 * scale, 29 * scale, 97 * scale
    y = (120 + 60 * torch.sin(xx / p1 + 6.3 * r[0])
         * torch.cos(yy / p2 + 6.3 * r[1])
         + 40 * torch.sin((xx + yy) / p3 + 6.3 * r[2]))
    tex = torch.randint(-6, 6, (h, w), generator=g, device=dev)
    return (y + tex).float()


def _chroma(h: int, w: int, scale: float, g: torch.Generator,
            dev) -> tuple:
    """The canvas's chroma: ``synthetic_frame``'s, at the shot's scale and
    seeded phases."""
    r = torch.rand(2, generator=g, device=dev, dtype=torch.float64)
    yy = torch.arange(h, device=dev, dtype=torch.float64)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float64)[None, :]
    u = 128 + 40 * torch.sin(xx / (53 * scale) + 6.3 * r[0]) + 0 * yy
    v = 128 + 40 * torch.cos(yy / (67 * scale) + 6.3 * r[1]) + 0 * xx
    return u.float(), v.float()


def _object(h: int, w: int, period: float, level: float,
            g: torch.Generator, dev) -> tuple:
    """A textured object: stripes of the given period at a seeded angle
    over the given level, with its own texture, and flat chroma."""
    r = torch.rand(3, generator=g, device=dev, dtype=torch.float64)
    yy = torch.arange(h, device=dev, dtype=torch.float64)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float64)[None, :]
    a = 6.3 * r[0]
    t = xx * torch.cos(a) + yy * torch.sin(a)
    y = (level + 50 * torch.sign(torch.sin(t / period))
         + torch.randint(-10, 11, (h, w), generator=g, device=dev))
    u = torch.full((h // 2, w // 2), float(60 + 136 * r[1]), device=dev)
    v = torch.full((h // 2, w // 2), float(60 + 136 * r[2]), device=dev)
    return y.float(), u.float(), v.float()


def generate(traffic: dict, width: int, height: int, seed: int,
             device="cpu") -> list:
    """The pool of (Y, Cb, Cr) uint8 host frames, in display order."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(sub_seed(seed, "pixels"))
    noise = int(traffic.get("noise", 2))
    pool = int(traffic["pool_frames"])
    ys = torch.empty((pool, height, width), dtype=torch.uint8, device=dev)
    us = torch.empty((pool, height // 2, width // 2), dtype=torch.uint8,
                     device=dev)
    vs = torch.empty_like(us)
    for shot in plan(traffic, width, height, seed):
        path = _path(shot)
        ylo = min(p[0] for p in path)
        xlo = min(p[1] for p in path)
        ch = (max(p[0] for p in path) - ylo + height + 1) & ~1
        cw = (max(p[1] for p in path) - xlo + width + 1) & ~1
        bg = _canvas(ch, cw, shot.scale, g, dev)
        bu, bv = _chroma(ch // 2, cw // 2, shot.scale, g, dev)
        objs = [(o, _object(o[0], o[1], o[6], o[7], g, dev))
                for o in shot.objects]
        for k, (py, px) in enumerate(path):
            oy, ox = (py - ylo) & ~1, (px - xlo) & ~1
            y = bg[oy:oy + height, ox:ox + width].clone()
            u = bu[oy // 2:oy // 2 + height // 2,
                   ox // 2:ox // 2 + width // 2].clone()
            v = bv[oy // 2:oy // 2 + height // 2,
                   ox // 2:ox // 2 + width // 2].clone()
            for (h, w, y0, x0, vy, vx, _p, _lv), (to, tu, tv) in objs:
                ty = _bounce(y0, vy, k, height - h) & ~1
                tx = _bounce(x0, vx, k, width - w) & ~1
                y[ty:ty + h, tx:tx + w] = to
                u[ty // 2:(ty + h) // 2, tx // 2:(tx + w) // 2] = tu
                v[ty // 2:(ty + h) // 2, tx // 2:(tx + w) // 2] = tv
            if noise:
                y += torch.randint(-noise, noise + 1, y.shape, generator=g,
                                   device=dev)
            f = shot.start + k
            ys[f] = y.round().clamp(0, 255).to(torch.uint8)
            us[f] = u.round().clamp(0, 255).to(torch.uint8)
            vs[f] = v.round().clamp(0, 255).to(torch.uint8)
    ys, us, vs = ys.cpu().numpy(), us.cpu().numpy(), vs.cpu().numpy()
    return [(ys[i], us[i], vs[i]) for i in range(pool)]


def cut_frames(traffic: dict, width: int, height: int, seed: int) -> list:
    """Pool indices at which a new shot starts (the first excluded)."""
    return [s.start for s in plan(traffic, width, height, seed)[1:]]

