"""walk.ns_per_step: device ns of the walk kernels (K1, K4, K5, K6, by
kernel name, as ``walk.device_ms``) a frame of the traced window, over the
node steps a frame of the same frames (the walk window's first frames,
``rtbench/walks.py``, counted by the program): what a node step costs,
which grows when the tree's reads leave the L2."""

from rtbench import walks
from rtbench.tracing import kernel_of

WALKS = ("K1", "K4", "K5", "K6")


def read(run):
    tr = run.traced
    if tr is None:
        return None
    keep = lambda name: kernel_of(name) in WALKS
    if not tr.count(keep):
        return None
    steps = walks.traced_steps(walks.window(run))
    return tr.kernel_ms(keep) * 1e6 / steps if steps else None
