"""build.fit_ms: device ms of the build's ``fit`` span (the boxes,
``ops/bvh.fit_aabbs``) a frame, the median over the walk window's frames
(``rtbench/walks.py``)."""

from rtbench import walks


def read(run):
    return walks.median_ms(walks.window(run), "fit_ms")
