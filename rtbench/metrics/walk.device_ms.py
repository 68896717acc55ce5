"""walk.device_ms: device ms an iteration of the walks, K1, K4, K5 and K6
(csrc/traverse.cu, csrc/traverse_shared.cu), by kernel name."""

from rtbench.tracing import kernel_of

WALKS = ("K1", "K4", "K5", "K6")


def read(run):
    tr = run.traced
    if tr is None:
        return None
    keep = lambda name: kernel_of(name) in WALKS
    return tr.kernel_ms(keep) if tr.count(keep) else None
