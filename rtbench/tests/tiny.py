"""A cell of BENCHMARK.json at a tiny size on the CPU, for the tests: the
configuration's scene and frame shrunk, the traffic's warm-up, trace and
check shortened; the program's kernel routes run their plain versions on
CPU tensors."""

from __future__ import annotations

import contextlib
import copy

import torch

from rtbench import faults, harness

WIDTH, HEIGHT = 64, 48
# the scenes' sizes at the tiny size, by scene kind
TINY_SCENE = {"sphere_grid": {"subdiv": 4},
              "uv_sphere": {"stacks": 9, "slices": 12}}
# cells whose entries the tests drive, though BENCHMARK.json does not list
# them yet (PERF.md, Open questions)
PENDING = [{"name": "sphere3k-train4", "config": "sphere3k",
            "traffic": "train_sharded", "chips": 4,
            "why": "the 1080p step across 4 chips, gradients all-reduced"}]


def manifest() -> dict:
    """BENCHMARK.json with the ``PENDING`` cells."""
    man = harness.manifest()
    listed = {w["name"] for w in man["workloads"]}
    man["workloads"] += [w for w in PENDING if w["name"] not in listed]
    return man


def sized(cell_name: str, man: dict = None):
    """(manifest, config, traffic) of ``cell_name`` at the tiny size."""
    man = manifest() if man is None else man
    cell = harness.cell(man, cell_name)
    conf = copy.deepcopy(harness.config_of(man, cell))
    scale = WIDTH / conf["width"]
    conf.update(width=WIDTH, height=HEIGHT,
                ortho_scale=conf["ortho_scale"] * scale)
    conf["scene"].update(TINY_SCENE[conf["scene"]["kind"]])
    tr = copy.deepcopy(harness.traffic(cell["traffic"]))
    tr.update(warmup=1, trace_iterations=2)
    if "pixels" in tr["check"]:
        tr["check"].update(frames=2, pixels=256)
    return man, conf, tr


def drive(cell_name: str, seed: int, variant: str = "sound",
          seconds: float = 0.2, rank: int = 0, world: int = 1,
          init_method: str = None, trace: bool = False):
    """One run of the cell (window and check) under ``variant``: 'sound',
    'bf16' or a fault of ``faults.planted`` -> the Run."""
    man, conf, tr = sized(cell_name)
    plant = contextlib.nullcontext()
    if variant == "bf16":
        tr = faults.bf16_traffic(tr)
    elif variant != "sound":
        plant = faults.planted(variant)
    run = harness.Run(man, cell_name, seed, seconds, trace,
                      torch.device("cpu"), rank=rank, world=world,
                      config=conf, traffic_=tr, init_method=init_method)
    entry = harness.entry(tr["entry"])
    with plant:
        entry.window(run)
        entry.verify(run)
    return run
