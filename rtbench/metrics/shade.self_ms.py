"""shade.self_ms: device ms a frame of the ``shade.primary`` and
``shade.bounce`` spans less their ``gather`` children, summed over a frame
or a step's ``forward``: the plain elementwise shading; the median over
the span window's calls."""

from rtbench import spans


def read(run):
    return spans.median_of(spans.window(run), "shade_self_ms")
