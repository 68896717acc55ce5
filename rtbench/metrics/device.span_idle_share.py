"""device.span_idle_share: 1 - (the sum over the span window's calls of a
replay's first to last mark) / (the window's first mark to its last): the
share of the window in which the card ran no frame or step, with no
profiler attached."""

from rtbench import spans


def read(run):
    summary = spans.window(run)
    return None if summary is None else summary["idle_share"]
