"""The reader of ``build.pack_ms``: the ``pack`` span's median ms a frame
from the walk window's summary (``walks.summarize``), None where the
program has no such span or the cell no walk window; and on the CPU, in
each walk-window cell at its tiny size, the plain pack's span."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from rtbench import harness, walks
from rtbench.tests import tiny

NAME = "build.pack_ms"
CELLS = ["tetra1m-frame_shadows", "sphere3k-frame",
         "sphere100k-frame_shadows", "sphere3k-frame_onchip"]


def _span(name, call, ms, parent=0):
    return SimpleNamespace(name=name, call=call, begin=0, end=int(ms * 1e6),
                           parent=parent, clock="device")


def _summary(pack_ms):
    """A walk window of len(pack_ms) frames; frame k's ``pack`` span
    lasts pack_ms[k] (None: no such span)."""
    records = []
    for call, ms in enumerate(pack_ms):
        records.append(_span("frame", call, 5.0, parent=None))
        records.append(_span("fit", call, 0.5))
        if ms is not None:
            records.append(_span("pack", call, ms))
    return walks.summarize(records, [], 2)


def _run(summary):
    return SimpleNamespace(state={"walks": summary})


def test_reads_the_median_of_the_pack_span():
    read = harness.reader(NAME)
    assert read(_run(_summary([0.25, 0.5, 0.75]))) == pytest.approx(0.5)
    assert read(_run(_summary([0.3]))) == pytest.approx(0.3)


def test_no_span_no_result():
    """A program without the span (before it was added), and a cell with
    no walk window (a training cell), read None, never 0."""
    read = harness.reader(NAME)
    assert read(_run(_summary([None, None]))) is None
    assert read(_run(None)) is None


def test_listed_in_the_walk_window_cells():
    man = harness.manifest()
    (m,) = [m for m in man["per_layer"] if m["name"] == NAME]
    assert m["workloads"] == CELLS
    assert (m["layer"], m["moves"], m["source"]) == ("build", "mrays_s",
                                                     "program_span")


@pytest.mark.parametrize("cell", CELLS)
def test_reads_the_plain_pack_on_the_cpu(monkeypatch, cell):
    monkeypatch.setattr(walks, "WARMUP", 1)
    monkeypatch.setattr(walks, "ITERATIONS", 2)
    man, conf, tr = tiny.sized(cell)
    run = harness.Run(man, cell, 7, 0.05, False, torch.device("cpu"),
                      config=conf, traffic_=tr)
    harness.entry(tr["entry"]).window(run)
    assert harness.reader(NAME)(run) > 0
