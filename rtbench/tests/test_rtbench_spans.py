"""The span window (``rtbench/spans.py``) and the seven readers of the
program's spans and capture log, on ``tiny.py``'s CPU cells: a finite
number in each reader's cells, None where nothing was recorded, and the
window's arithmetic (self time, host ms, idle share, gap attribution) on
records made by hand."""

from __future__ import annotations

import gc
import math

import pytest
import torch

from raytracebvh_tpu_torch.utils import profiling
from rtbench import harness, spans
from rtbench.tests import tiny

SPANS = ("build.frame_ms", "shade.self_ms", "step.backward_ms",
         "graphs.host_ms", "device.span_idle_share")
CAPTURES = ("graphs.setup_s", "graphs.pool_GiB")


@pytest.fixture
def short(monkeypatch):
    monkeypatch.setattr(spans, "WARMUP", 1)
    monkeypatch.setattr(spans, "ITERATIONS", {"frame": 2, "train": 2})


def _window(cell: str):
    """The cell's window at the tiny size, as run.py runs it (the readers
    before the check)."""
    man, conf, tr = tiny.sized(cell)
    run = harness.Run(man, cell, 7, 0.05, False, torch.device("cpu"),
                      config=conf, traffic_=tr)
    harness.entry(tr["entry"]).window(run)
    return run


@pytest.mark.parametrize("cell", ["sphere3k-train", "sphere3k-frame",
                                  "sphere100k-frame_shadows"])
def test_span_readers_on_the_cpu_cells(short, cell):
    run = _window(cell)
    listed = {m["name"] for m in harness.metrics_of(run.manifest, cell,
                                                    "per_layer")}
    got = {name: harness.reader(name)(run) for name in SPANS}
    summary = spans.window(run)
    assert summary["iterations"] == 2 and len(summary["calls"]) == 2
    for name in ("build.frame_ms", "shade.self_ms",
                 "device.span_idle_share"):
        assert name in listed and math.isfinite(got[name]), name
        assert got[name] >= 0
    assert got["build.frame_ms"] > 0 and got["shade.self_ms"] > 0
    assert 0 <= got["device.span_idle_share"] < 1
    if cell == "sphere3k-train":
        assert "step.backward_ms" in listed
        assert got["step.backward_ms"] > 0
    else:
        assert got["step.backward_ms"] is None
    assert got["graphs.host_ms"] is None  # no graph on the CPU
    # no capture on the CPU: nothing in the log before the set-up mark
    for name in CAPTURES:
        assert harness.reader(name)(run) is None


def test_no_records_no_numbers(short, monkeypatch):
    run = _window("sphere3k-frame")
    monkeypatch.setattr(profiling, "records", lambda: [])
    for name in SPANS:
        assert harness.reader(name)(run) is None, name
    run = _window("sphere3k-frame")
    monkeypatch.setattr(run, "traffic", dict(run.traffic, entry="other"))
    assert spans.window(run) is None


class _Owner:
    """Stands for a graph in the capture log."""


def test_capture_readers(monkeypatch):
    run = harness.Run(tiny.manifest(), "sphere3k-frame", 1, 1.0, False,
                      torch.device("cpu"), t_start=100.0)
    run.setup_s = 5.0
    mark = int(105.0 * 1e9)
    monkeypatch.setattr(profiling, "_captures", [])
    for name in CAPTURES:
        assert harness.reader(name)(run) is None
    kept, gone = _Owner(), _Owner()
    # the pool reader takes the largest peak (not the reserved pool) of
    # the live spans-off captures made before the set-up mark
    rows = [(kept, 1200.0, 800.0, 3 << 29, False, mark - 10),
            (kept, 0.0, 0.0, 1 << 29, False, mark - 8),
            (gone, 100.0, 100.0, 1 << 31, False, mark - 5),
            (kept, 50.0, 50.0, 1 << 31, True, mark - 1),  # spans on
            (kept, 999.0, 999.0, 1 << 31, False, mark + 1)]  # after
    for owner, warm, cap, peak, on, end in rows:
        profiling.log_capture(owner, name="frame", warmup_ms=warm,
                              capture_ms=cap, pool_bytes=4 << 30,
                              peak_bytes=peak, spans=on,
                              begin_ns=end - 10, end_ns=end)
    del gone, rows, owner
    gc.collect()
    assert harness.reader("graphs.setup_s")(run) == pytest.approx(2.3)
    assert harness.reader("graphs.pool_GiB")(run) == pytest.approx(1.5)


def _span(name, call, begin, end, parent=None, clock="cuda:0"):
    return profiling.Span(name, call, begin, end, None, parent, clock)


def test_summary_arithmetic():
    """Two replays on the card's clock (offset 1000 ns onto the host's)
    and their host spans: a frame's build and its shading's self time,
    the host ms, the idle share and the gaps' covering spans."""
    ms = 1_000_000
    recs = [
        _span("frame", 1, 0, 10 * ms),
        _span("build", 1, 1 * ms, 3 * ms, 0),
        _span("shade.primary", 1, 4 * ms, 8 * ms, 0),
        _span("gather", 1, 5 * ms, 6 * ms, 2),
        _span("frame", 2, 14 * ms, 20 * ms),
        _span("build", 2, 15 * ms, 16 * ms, 4),
        _span("graphs.key", 1, -1 * ms, 0, clock="host"),
        _span("graphs.copy_out", 1, 10 * ms + 1000, 13 * ms, clock="host"),
        _span("graphs.launch", 2, 13 * ms, 13 * ms + 2000, clock="host"),
    ]
    out = spans.summarize(recs, [11.0, 7.0], (1000, 5.0), (1500, 6.0))
    by = {c["call"]: c for c in out["calls"]}
    assert by[1]["build_ms"] == 2 and by[2]["build_ms"] == 1
    assert by[1]["shade_self_ms"] == 3 and by[2]["shade_self_ms"] == 0
    assert by[1]["host_ms"] == pytest.approx(3.999)
    assert by[2]["host_ms"] == pytest.approx(0.002)
    assert out["idle_share"] == pytest.approx(1 - 16 / 20)
    # the gap [10, 14] ms + 1 us: copy_out and launch cover parts of it
    ((gap, parts),) = out["gaps"]
    assert gap == 4.0 and parts == pytest.approx(
        {"graphs.copy_out": 2.999, "graphs.launch": 0.002,
         "caller": 0.999})
    assert out["gap_ms_by_span"] == parts
    assert by[1]["top_ms"] == 10 and by[1]["top_self_ms"] == 4
    assert out["span_ms"] == {"build": 1.5, "frame": 8, "gather": 0.5,
                              "shade.primary": 2}
    assert out["clock"]["drift_ns"] == 500
    assert spans.median_of(out, "build_ms") == 1.5
    assert spans.median_of(out, "backward_ms") is None
