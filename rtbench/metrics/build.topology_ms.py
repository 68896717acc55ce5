"""build.topology_ms: device ms of the build's ``topology`` span (the
Karras emit, ``ops/bvh.karras_children_rmq``) a frame, the median over the
walk window's frames (``rtbench/walks.py``)."""

from rtbench import walks


def read(run):
    return walks.median_ms(walks.window(run), "topology_ms")
