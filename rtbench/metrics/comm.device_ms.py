"""comm.device_ms: device ms a step of NCCL's kernels on the first rank."""

from rtbench.tracing import is_nccl


def read(run):
    tr = run.traced
    if tr is None or not tr.count(is_nccl):
        return None
    return tr.kernel_ms(is_nccl)
