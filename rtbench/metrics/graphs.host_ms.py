"""graphs.host_ms: host ms a frame or step call spends in the program's
graph layer, ``graphs.key`` + ``graphs.copy_in`` + ``graphs.launch`` +
``graphs.copy_out`` (host spans on ``time.perf_counter_ns``), the median
over the span window's calls."""

from rtbench import spans


def read(run):
    return spans.median_of(spans.window(run), "host_ms")
