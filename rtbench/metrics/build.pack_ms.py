"""build.pack_ms: device ms of the build's ``pack`` span (the leaf rows
and K1's tables written after the links: ``ops/pack_cuda``'s kernel, or
the plain pack where it does not engage) a frame, the median over the
walk window's frames (``rtbench/walks.py``).  None for a program without
the span."""

from rtbench import walks


def read(run):
    summary = walks.window(run)
    if summary is None:
        return None
    return summary["span_ms"].get("pack")
