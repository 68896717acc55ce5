"""graphs.pool_GiB: GiB the largest graph capture of the run's set-up
held at once, spans off: the capture log's ``peak_bytes``
(``utils.profiling.captures``), the most its allocations held above what
was allocated at its start.  A replay allocates nothing, so this is what
``peak_mem_GiB`` (``torch.cuda.max_memory_allocated``) counts of a
graph; the pool's reserved bytes (``pool_bytes``) are more."""

from raytracebvh_tpu_torch.utils import profiling

GIB = float(1 << 30)


def read(run):
    # a program without the capture log or its peak (a commit before
    # them) has none
    if run.setup_s is None or not hasattr(profiling, "captures"):
        return None
    mark_ns = (run.t_start + run.setup_s + run.reference_s) * 1e9
    peaks = [getattr(r, "peak_bytes", None)
             for r in profiling.captures(live=True)
             if r.end_ns <= mark_ns and not r.spans]
    peaks = [p for p in peaks if p is not None]
    return max(peaks) / GIB if peaks else None
