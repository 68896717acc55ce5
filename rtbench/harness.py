"""What every cell shares: the manifest and the files it names, the closed
loops' clock, the run's record, the import guard, and the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``); the mix names its entry
(``entries/<entry>.py``, which sets up, runs the window and checks the
outputs); a per-layer metric is ``metrics/<name>.py``, whose ``read(run)``
returns a number or None.  Each is found by its name, so a new one is a
new file.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names the benchmark's process may never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracebvh_tpu")
GIB = float(1 << 30)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _named(items, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(man: dict, name: str) -> dict:
    return _named(man["workloads"], name, "workload")


def config_of(man: dict, cell_: dict, root: Path = ROOT) -> dict:
    entry = _named(man["configs"], cell_["config"], "config")
    return load_json(root / entry["file"])


def traffic(name: str) -> dict:
    return load_json(BENCH / "traffic" / f"{name}.json")


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name: str):
    path = BENCH / "entries" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return importlib.import_module(f"rtbench.entries.{name}")


def reader(name: str):
    """The ``read`` function of per-layer metric ``name``."""
    mod = _module(BENCH / "metrics" / f"{name}.py",
                  "rtbench_metric_" + name.replace(".", "_"))
    return mod.read


def metrics_of(man: dict, cell_name: str, kind: str) -> list:
    """The ``kind`` ('end_to_end' or 'per_layer') metrics reported in
    cell ``cell_name``."""
    return [m for m in man[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def p95(values) -> float:
    """The 95th percentile by nearest rank: the smallest value that at
    least 95% of ``values`` do not exceed."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


class Check:
    """The numbers compared with the reference, each with its limit: a
    run is correct when every number is at or below its limit."""

    def __init__(self):
        self.items = []

    def add(self, name: str, value: float, limit: float) -> None:
        self.items.append((name, float(value), float(limit)))

    def worst(self, name: str, value: float, limit: float) -> None:
        """Keep the larger of ``value`` and an earlier reading of ``name``."""
        for k, (n, v, lim) in enumerate(self.items):
            if n == name:
                self.items[k] = (n, max(v, float(value)), lim)
                return
        self.add(name, value, limit)

    @property
    def correct(self) -> bool:
        return bool(self.items) and all(
            math.isfinite(v) and v <= lim for _, v, lim in self.items)

    @property
    def failed(self) -> int:
        return sum(1 for _, v, lim in self.items
                   if not (math.isfinite(v) and v <= lim))

    def as_dict(self) -> dict:
        """name -> value and limit; a value that is not finite (a NaN
        gradient) as its string, which JSON can carry."""
        return {n: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                for n, v, lim in self.items}


class Run:
    """One run of one cell: what was asked, and what it measured."""

    def __init__(self, man: dict, cell_name: str, seed: int, seconds: float,
                 trace: bool, device, rank: int = 0, world: int = 1,
                 t_start: float = None, config: dict = None,
                 traffic_: dict = None, init_method: str = None):
        self.manifest = man
        self.cell = cell(man, cell_name)
        self.name = cell_name
        self.config = config if config is not None else config_of(
            man, self.cell)
        self.traffic = traffic_ if traffic_ is not None else traffic(
            self.cell["traffic"])
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.rank = rank
        self.world = world
        self.init_method = init_method
        self.t_start = time.perf_counter() if t_start is None else t_start
        # filled by the entry
        self.setup_s = None
        # seconds of set-up the benchmark's own reference took (a training
        # target), which setup_s leaves out
        self.reference_s = 0.0
        self.iterations = 0
        self.window_s = None
        self.latencies = []
        self.ends = []  # end times of the window's iterations (or reads)
        self.ends_per = 1
        self.rays_per_iteration = 0
        self.peak_bytes = 0
        self.traced = None
        # the traced window's device busy and wall seconds (averaged over
        # the chips by an entry that runs on several)
        self.busy_s = None
        self.traced_s = None
        self.check = Check()
        self.layer = {}  # what a metric's reader may ask of the entry
        self.state = {}  # what the entry's check needs of its window

    def close_trace(self) -> None:
        """Reads the traced window's busy and wall time, unless the entry
        has (from every chip)."""
        if self.traced is not None and self.busy_s is None:
            self.busy_s = self.traced.busy_s()
            self.traced_s = self.traced.wall_s

    def mark_setup(self) -> None:
        self.setup_s = (time.perf_counter() - self.t_start
                        - self.reference_s)

    def mrays_s(self) -> float:
        return self.rays_per_iteration * self.iterations / self.window_s / 1e6

    def step_ms(self) -> float:
        """The window's whole time over every iteration it completed."""
        return self.window_s / self.iterations * 1e3

    def end_to_end(self) -> dict:
        """Every end-to-end reading of the run; the result keeps those its
        cell reports."""
        out = {"mrays_s": self.mrays_s(), "step_ms": self.step_ms(),
               "setup_s": self.setup_s, "peak_mem_GiB": self.peak_bytes / GIB}
        if self.latencies:
            out["frame_p95_ms"] = p95(self.latencies) * 1e3
        return out

    def per_layer(self) -> dict:
        out = {}
        for m in metrics_of(self.manifest, self.name, "per_layer"):
            value = reader(m["name"])(self)
            if value is not None:
                out[m["name"]] = value
        return out


def closed_frames(render_one, seconds: float, ends: list = None):
    """Frames back to back, each ended by a synchronize, until ``seconds``
    have passed at the end of one -> (latencies s, window s): the window
    runs from the first frame's call to the last frame's synchronize;
    ``ends`` receives each frame's end from the window's start."""
    lat = []
    t0 = time.perf_counter()
    i = 0
    while True:
        ts = time.perf_counter()
        render_one(i)
        te = time.perf_counter()
        lat.append(te - ts)
        if ends is not None:
            ends.append(te - t0)
        i += 1
        if te - t0 >= seconds:
            return lat, te - t0


def closed_steps(step, seconds: float, read_every: int, reads: list = None):
    """Steps back to back, the loss read on the host every ``read_every``
    steps (the train CLI's log line), until ``seconds`` have passed at
    such a read -> (steps, window s); ``reads`` receives the time of each
    read from the window's start."""
    t0 = time.perf_counter()
    i = 0
    while True:
        loss = step(i)
        i += 1
        if i % read_every == 0:
            float(loss)
            t = time.perf_counter()
            if reads is not None:
                reads.append(t - t0)
            if t - t0 >= seconds:
                return i, t - t0


def by_second(ends, per: int = 1) -> list:
    """ms an iteration in each whole second of a window, from the end times
    (s from its start) of its iterations, ``per`` iterations an end."""
    out, start, count, last = [], 0.0, 0, 0.0
    for t in ends:
        count += per
        if t - start >= 1.0:
            out.append(round((t - start) * 1e3 / count, 3))
            start, count = t, 0
        last = t
    return out


def result(run: Run, device_info: dict, metrics: dict,
           breakdown: dict = None) -> dict:
    """The result line: the driver's keys, and the compared numbers
    last."""
    out = {"correct": run.check.correct, "attempted": run.iterations,
           "failed": run.check.failed,
           "metrics": {name: {"value": value, "unit": unit_of(
               run.manifest, name)} for name, value in metrics.items()},
           "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = run.check.as_dict()
    return out


def unit_of(man: dict, name: str) -> str:
    for m in man["end_to_end"] + man["per_layer"]:
        if m["name"] == name:
            return m["unit"]
    raise KeyError(name)
