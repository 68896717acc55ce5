"""graphs.setup_s: seconds of the program's graph captures in the run's
set-up: the warm-up and capture ms of every capture that ended before the
set-up mark (``utils.profiling.captures``, the capture log)."""

from raytracebvh_tpu_torch.utils import profiling


def read(run):
    # a program without the capture log (a commit before it) has none
    if run.setup_s is None or not hasattr(profiling, "captures"):
        return None
    mark_ns = (run.t_start + run.setup_s + run.reference_s) * 1e9
    ms = [r.warmup_ms + r.capture_ms for r in profiling.captures()
          if r.end_ns <= mark_ns]
    return sum(ms) / 1e3 if ms else None
