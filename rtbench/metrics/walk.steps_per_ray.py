"""walk.steps_per_ray: node steps over rays walked, a frame, the median
over the walk window's frames (``rtbench/walks.py``): the program's walk
counts (``utils.profiling.counts``), every walk of a frame together."""

from rtbench import walks


def read(run):
    return walks.steps_per_ray(walks.window(run))
