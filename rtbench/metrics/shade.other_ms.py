"""shade.other_ms: device ms an iteration of every kernel that is neither
one of the program's K1-K8 nor NCCL's: the plain elementwise shading, its
autograd backward and the optimizer's update."""

from rtbench.tracing import is_nccl, kernel_of


def read(run):
    tr = run.traced
    if tr is None:
        return None
    keep = lambda name: kernel_of(name) is None and not is_nccl(name)
    return tr.kernel_ms(keep) if tr.count(keep) else None
