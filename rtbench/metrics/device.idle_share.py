"""device.idle_share: 1 - (union of the device operations' intervals) /
(the traced window's wall time), averaged over the chips: an upper bound
of an untraced window's, since the profiler adds host time."""


def read(run):
    if run.busy_s is None or not run.traced_s:
        return None
    return 1.0 - run.busy_s / run.traced_s
