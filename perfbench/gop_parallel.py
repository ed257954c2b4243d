"""The ``gop_parallel`` driver: closed GOPs encoded together, one a
channel, as a multi-channel live encoder codes its channels' GOPs.

A configuration selects it with ``"driver": "gop_parallel"`` and
``"gops": G`` beside its preset.  The pool is G GOPs of ``keyint_max``
frames each, made from the traffic's parameters, and one
``x265_tpu_torch.parallel`` ``GopParallelEncoder`` of G GOPs encodes them
in one call: round r codes frame r of every GOP in one batched dispatch,
then each GOP's host encoder finishes its frame of the round.  The driver
follows the call through each GOP encoder's ``_finish_one`` (each AU, its
reconstruction and the time it was finished) and ``_store_col_motion``
(the motion field it retains for TMVP); a round ends when its last GOP
has finished.

The traffic's ``warmup_frames`` counts the frames of each GOP coded
before the window, that is rounds.  The window opens at the end of the
last warm-up round and closes at the end of the first round that ends
``--seconds`` or more after it opened, or at the end of the GOPs' last
round, whichever comes first: it holds whole rounds of G AUs, and never
the I round or a round with fewer reference pictures of a GOP after it.
Then the hook stops the call by raising: each of the G GOPs ends after
that round, a closed GOP cut short that still decodes.  The stream that
is judged is one header block and then the GOP streams in GOP order, as
``encode_gop_parallel`` concatenates them; the reconstructions and motion
fields are kept in that decode order.
"""

from __future__ import annotations

import sys
import time
from types import SimpleNamespace

from . import measure
from .harness import HarnessError, PlaneStore


class _Closed(Exception):
    """Raised from the finish hook at the end of the window's last round."""


def pool_frames(config: dict, params, traffic: dict) -> int:
    """G GOPs of ``keyint_max`` frames."""
    return int(config["gops"]) * int(params.keyint_max)


def drive(run, win) -> SimpleNamespace:
    from x265_tpu_torch.parallel.gop import GopParallelEncoder
    params, pool = run.params, run.pool
    G, K = int(run.config["gops"]), int(params.keyint_max)
    warm = int(run.traffic["warmup_frames"])
    if not 0 < warm < K:
        raise HarnessError(f"warmup_frames {warm} leaves no round of a "
                           f"{K}-frame GOP to measure")
    enc = GopParallelEncoder(params, G, device=run.device)
    recon = PlaneStore(len(pool), run.cuda)
    aus = []            # one record an AU, in the order they were finished
    st = SimpleNamespace(finished=[0] * G, done={}, ends=[])

    def round_end(r: int, t: float) -> None:
        if win.t_open is None:
            if r == warm - 1:
                win.open(t)
                st.ends.append(t)
            return
        st.ends.append(t)
        if win.step(t, G, last=r == K - 1):
            raise _Closed

    def hook(k: int, e) -> None:
        finish, store = e._finish_one, e._store_col_motion
        kept = {}

        def keep_motion(ps, poc):
            store(ps, poc)
            kept["motion"] = e._col_store[poc]

        def finish_one(pend):
            ef = finish(pend)
            t = time.perf_counter()
            r = st.finished[k]
            st.finished[k] = r + 1
            recon.add(ef.coded)
            aus.append(SimpleNamespace(
                order=(k, r), au=ef.au, recon=len(recon.items) - 1,
                motion=kept.pop("motion", None),
                in_window=win.t_open is not None, kind=ef.kind,
                refs=len(e.last_ps.ref_pocs_l0) if ef.kind == "P" else 0))
            st.done[r] = st.done.get(r, 0) + 1
            if st.done[r] == G:
                round_end(r, t)
            return ef
        e._store_col_motion = keep_motion
        e._finish_one = finish_one

    for k, e in enumerate(enc.encoders):
        hook(k, e)
    try:
        enc.encode([pool[k * K:(k + 1) * K] for k in range(G)])
    except _Closed:
        pass
    win.close()
    short = win.t_close - win.t_open < win.seconds
    if short:
        print(f"perfbench: the window closed at the GOPs' last round, "
              f"{win.t_close - win.t_open:.3f} s after it opened",
              file=sys.stderr)
    headers = enc.encoders[0].headers()

    aus.sort(key=lambda a: a.order)         # decode order
    motion = []
    for a in aus:
        if a.motion is None:                # a field the program never kept
            break
        motion.append(a.motion)
    kinds, refs = {}, {}
    for a in aus:
        if a.in_window:
            kinds[a.kind] = kinds.get(a.kind, 0) + 1
            refs[str(a.refs)] = refs.get(str(a.refs), 0) + 1
    round_s = [b - a for a, b in zip(st.ends, st.ends[1:])]
    info = dict(pushed=len(aus), window_kinds=kinds, window_refs=refs,
                window_at_gop_end=short)
    if round_s:
        info["round_s"] = dict(n=len(round_s),
                               p50=measure.percentile(round_s, 50),
                               p90=measure.percentile(round_s, 90),
                               max=max(round_s))
    return SimpleNamespace(
        stream=[headers] + [a.au for a in aus], recon=recon,
        order=[a.recon for a in aus], motion=motion, pushed=len(aus),
        win_orders=[i for i, a in enumerate(aus) if a.in_window],
        pool_index=lambda cvs, poc, display: cvs * K + poc, info=info)
