"""build.frame_ms: device ms of the ``build`` span inside the frame or the
step replay (the program's marks, ``utils.profiling.spans``), the median
over the span window's calls (``rtbench/spans.py``)."""

from rtbench import spans


def read(run):
    return spans.median_of(spans.window(run), "build_ms")
