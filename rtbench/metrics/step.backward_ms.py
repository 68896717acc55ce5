"""step.backward_ms: device ms of the step's ``backward`` span (autograd's
backward of the frame, K3 among its kernels), the median over the span
window's steps."""

from rtbench import spans


def read(run):
    return spans.median_of(spans.window(run), "backward_ms")
