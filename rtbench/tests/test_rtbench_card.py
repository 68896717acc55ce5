"""Each cell of BENCHMARK.json run briefly by its command on the card
(``python3 rtbench/run.py ...``): the result line's keys, its metrics and
``correct``.  Skips without a CUDA device, or without as many as the cell
asks for.  Run on the card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu rtbench/tests
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from rtbench import harness

pytestmark = pytest.mark.gpu
CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.fixture
def devices():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.cuda.device_count()


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(cell, trace, devices):
    man = harness.manifest()
    if devices < harness.cell(man, cell)["chips"]:
        pytest.skip(f"{cell} needs more CUDA devices")
    out = subprocess.run(
        [sys.executable, str(harness.BENCH / "run.py"), "--workload", cell,
         "--seed", str(2 ** 33 + 17), "--seconds", "2", "--trace",
         str(trace)], cwd=harness.ROOT, capture_output=True, text=True,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in harness.metrics_of(man, cell, kind)}
    assert want <= set(line["metrics"])
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == \
        harness.cell(man, cell)["chips"]
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert line["breakdown"]["device_ops"]
