"""The program's own spans in a traced run, as the readers of the metrics
that read them find them.

The harness turns the program's recorder (``x265_tpu_torch.trace``) on
when the profiled part of a traced window opens and off when it closes,
reads the spans against the device trace (``perfbench.attribute``),
prints them as the ``program_spans`` info line and hands them to the
readers as ``ctx.spans`` (as recorded) and ``ctx.program`` (the
readings).  Against a program without the recorder, or in an untraced
run, there is nothing to read: every such reader returns None.  Every
reading is per AU returned in the profiled part: the spans ``finish``
that no other ``finish`` encloses.
"""

from __future__ import annotations

# tools/profile_torch.py reads the spans through these names
from perfbench.attribute import marker_launch, readings  # noqa: F401


def program(ctx):
    """The readings, or None where the run recorded no span."""
    return getattr(ctx, "program", None)


def under_per_frame(ctx, span: str, what: int):
    """Device ns (``what`` 0) or operations (1) launched under ``span``
    per AU of the profiled part; None where the run has no device trace
    read against the spans."""
    p = program(ctx)
    if p is None or p.under is None or not p.frames:
        return None
    return p.under.get(span, [0, 0])[what] / p.frames
