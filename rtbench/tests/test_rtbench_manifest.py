"""BENCHMARK.json against the benchmark's contract, and the harness's
promise that a configuration, a traffic mix, a cell and a per-layer metric
are added as new files only."""

from __future__ import annotations

import hashlib
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

from rtbench import harness

MAN = harness.manifest()
ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_size():
    assert set(MAN) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(MAN["command"]) <= 32
    assert all(_line(w) for w in MAN["command"])
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    for word in MAN["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in MAN["paths"])


def test_run_seconds_fit_a_full_check():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in MAN[group]:
            assert NAME.match(item["name"]), item["name"]
            names.append(item["name"])
    assert len(names) == len(set(names))
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"])
    for c in MAN["configs"]:
        assert _line(c["why"]) and _line(c["source"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in MAN["per_layer"]:
        assert _line(m["layer"])


def test_entry_keys():
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"},
    }
    for group, keys in allowed.items():
        for item in MAN[group]:
            assert set(item) <= keys, (group, item)
            assert set(item) >= keys - {"workloads"}, (group, item)


def test_bounds():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])


def _reports(cell: str, metric: dict) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_cell_reports_enough():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for w in MAN["workloads"]:
        mine = [n for n, m in e2e.items() if _reports(w["name"], m)]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(_reports(w["name"], m) for m in MAN["per_layer"])
    for m in MAN["per_layer"]:
        moved = e2e[m["moves"]]
        for w in MAN["workloads"]:
            if _reports(w["name"], m):
                assert _reports(w["name"], moved), (m["name"], w["name"])


def test_chips_and_cells():
    cells = MAN["workloads"]
    assert 1 <= len(cells) <= 24
    assert all(w["chips"] in (1, 4) for w in cells)
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, math.floor(0.25 * len(cells)))
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in cells}
    assert used == {c["name"] for c in MAN["configs"]}
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert set(layers) <= {"entry", "graphs", "build", "traversal", "gather",
                           "shading and autograd", "parallel", "device"}


def test_files_are_found_by_name():
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert any(c["file"].startswith(p + "/") for p in MAN["paths"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"] and conf["assumed"]
    for w in MAN["workloads"]:
        tr = harness.traffic(w["traffic"])
        assert (harness.BENCH / "entries" / f"{tr['entry']}.py").is_file()
    for m in MAN["per_layer"]:
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").is_file()


NEW_METRIC = '''
"""device.kernels: kernels an iteration of the traced window."""


def read(run):
    tr = run.traced
    return tr.count(lambda name: True) / tr.iterations if tr else None
'''


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_additions_are_new_files_only(tmp_path):
    shutil.copytree(harness.BENCH, tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path / "rtbench")
    bench = tmp_path / "rtbench"
    conf = json.loads((bench / "configs" / "sphere100k.json").read_text())
    conf.update(name="sphere2x2", source="https://example.org/sphere2x2")
    conf["scene"].update(nx=2, ny=2)
    (bench / "configs" / "sphere2x2.json").write_text(json.dumps(conf))
    tr = json.loads((bench / "traffic" / "frame.json").read_text())
    tr["render"] = dict(tr["render"], bounces=0)
    (bench / "traffic" / "frame_direct.json").write_text(json.dumps(tr))
    (bench / "metrics" / "device.kernels.py").write_text(NEW_METRIC)
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "sphere2x2", "source": conf["source"],
                           "file": "rtbench/configs/sphere2x2.json",
                           "reduced": [], "why": "a test configuration"})
    man["workloads"].append({"name": "sphere2x2-frame_direct",
                             "config": "sphere2x2",
                             "traffic": "frame_direct", "chips": 1,
                             "why": "a test cell"})
    man["per_layer"].append({"name": "device.kernels", "unit": "kernels",
                             "better": "lower", "source": "device_trace",
                             "layer": "device", "moves": "mrays_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]\n"
        "from rtbench import harness, tracing\n"
        "from rtbench.tests import tiny\n"
        "assert harness.BENCH.parent.as_posix() == sys.path[0]\n"
        "run = tiny.drive('sphere2x2-frame_direct', 11)\n"
        "run.traced = tracing.Trace([], 1, 1.0)\n"
        "names = [m['name'] for m in harness.metrics_of(\n"
        "    harness.manifest(), run.name, 'per_layer')]\n"
        "print(json.dumps([run.check.correct, run.iterations,\n"
        "                  'device.kernels' in names,\n"
        "                  harness.reader('device.kernels')(run)]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    correct, iterations, listed, value = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert correct and iterations >= 1 and listed and value == 0.0
    after = _digest(tmp_path / "rtbench")
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        "configs/sphere2x2.json", "traffic/frame_direct.json",
        "metrics/device.kernels.py"}
