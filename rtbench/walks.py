#!/usr/bin/env python3
"""The walk window: the program's walk counts and its build's stage spans
(``raytracebvh_tpu_torch.utils.profiling``: ``counts()``, ``records()``)
over a frame cell's frames, read by the per-layer metrics
``walk.steps_per_ray``, ``walk.ns_per_step``, ``build.topology_ms`` and
``build.fit_ms``.

The window renders the frames the traced window renders, from frame
``warmup`` (the traffic's) on, with ``render_frame_jit`` under
``profiling.spans()``, each ended by a synchronize, with no profiler
attached: ``WARMUP`` frames in a first ``spans()`` (the spans-on graph is
captured in the first), then ``ITERATIONS`` in a second.  On the card it
runs in a process of its own, as ``spans.py``'s window does:
``rtbench/walks.py --workload <cell> --seed <n>`` sets the cell up as its
entry does, with one warm-up frame, and prints the summary as the last
line of its output.

The summary holds, for each frame of the window in order: its node steps
and rays walked in all and by walk span, and the device ms of its
``topology`` and ``fit`` spans; and the median ms a frame of each span
name, which goes to standard error with the steps per ray of each walk
span.  A program without walk counts (a commit before them) gives frames
without steps.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

WARMUP = 2
ITERATIONS = 20
ROOT = Path(__file__).resolve().parent.parent


def window(run):
    """The walk summary of ``run``'s cell (made once, kept in
    ``run.state``); None for a cell whose entry keeps no frame inputs (a
    training cell) or a program without spans."""
    if "walks" not in run.state:
        run.state["walks"] = _make(run)
    return run.state["walks"]


def _make(run):
    from raytracebvh_tpu_torch.utils import profiling

    if "inputs" not in run.state or not hasattr(profiling, "spans"):
        return None
    if run.device.type == "cuda":
        out = _child(run)
    else:
        out = measure(run, run.traffic["warmup"])
    report(out)
    return out


def _child(run) -> dict:
    cmd = [sys.executable, str(Path(__file__).resolve()), "--workload",
           run.name, "--seed", str(run.seed)]
    proc = subprocess.run(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                          stderr=sys.stderr, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"the walk window's process exited with "
                           f"{proc.returncode}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def measure(run, first: int) -> dict:
    """The walk window in this process over frames ``first`` onward of
    ``run``'s set-up cell -> ``summarize``'s summary."""
    import torch

    from raytracebvh_tpu_torch import render_frame_jit
    from raytracebvh_tpu_torch.utils import profiling
    from rtbench import scenes
    from rtbench.entries.frame import render_config, sync

    cfg = render_config(run)
    inputs = run.state["inputs"]

    def one(i):
        scene, cam = inputs(i)
        render_frame_jit(scenes.port_scene(scene), scenes.port_camera(cam),
                         cfg)
        sync(run.device)

    with torch.inference_mode():
        with profiling.spans():
            for _ in range(WARMUP):
                one(first)
        with profiling.spans():
            for i in range(first, first + ITERATIONS):
                one(i)
        records = profiling.records()
        counts = profiling.counts() if hasattr(profiling, "counts") else []
    return summarize(records, counts, run.traffic["trace_iterations"])


def summarize(records, counts, traced: int) -> dict:
    """The window's numbers from ``profiling.records()`` (``records``) and
    ``profiling.counts()`` (``counts``): a row a frame (its top span's
    call) in the order the frames ran; ``traced``, how many of the first
    frames are the traced window's."""
    frames = sorted((s for s in records
                     if s.parent is None and s.name == "frame"),
                    key=lambda s: s.begin)
    rows = {s.call: {"call": s.call, "topology_ms": 0.0, "fit_ms": 0.0,
                     "steps": None, "rays": None, "walks": {}}
            for s in frames}
    by_name = {call: {} for call in rows}
    for s in records:
        row = rows.get(s.call)
        if row is None or s.clock == "host":
            continue
        ms = (s.end - s.begin) / 1e6
        by_name[s.call][s.name] = by_name[s.call].get(s.name, 0.0) + ms
        if s.name in ("topology", "fit"):
            row[f"{s.name}_ms"] += ms
    for c in counts:
        row = rows.get(c.call)
        if row is None:
            continue
        steps, rays = row["walks"].get(c.name, (0, 0))
        row["walks"][c.name] = (steps + c.steps, rays + c.rays)
        row["steps"] = (row["steps"] or 0) + c.steps
        row["rays"] = (row["rays"] or 0) + c.rays
    names = sorted({n for spans in by_name.values() for n in spans})
    return {"frames": [rows[s.call] for s in frames], "traced": traced,
            "span_ms": {n: statistics.median(
                spans.get(n, 0.0) for spans in by_name.values())
                for n in names}}


def report(summary) -> None:
    """The window's steps per ray by walk span and its spans' median ms a
    frame, on standard error."""
    if summary is None or not summary["frames"]:
        return
    walked = {}
    for f in summary["frames"]:
        for name, (steps, rays) in f["walks"].items():
            s, r = walked.get(name, (0, 0))
            walked[name] = (s + steps, r + rays)
    per_ray = {k: round(s / r, 3) for k, (s, r) in walked.items()}
    print(f"rtbench: walk window {len(summary['frames'])} frames, steps a "
          f"ray by walk {per_ray}, steps a frame {traced_steps(summary)}; "
          f"ms a frame by span "
          f"{ {k: round(v, 4) for k, v in summary['span_ms'].items()} }",
          file=sys.stderr, flush=True)


def steps_per_ray(summary):
    """The median over the window's frames of node steps over rays
    walked, or None where no frame was counted."""
    if summary is None:
        return None
    ratios = [f["steps"] / f["rays"] for f in summary["frames"]
              if f["steps"] is not None and f["rays"]]
    return statistics.median(ratios) if ratios else None


def traced_steps(summary):
    """Node steps a frame over the traced window's frames (the window's
    first ``traced``), or None where they were not counted."""
    if summary is None:
        return None
    steps = [f["steps"] for f in summary["frames"][:summary["traced"]]]
    if not steps or None in steps:
        return None
    return sum(steps) / len(steps)


def median_ms(summary, key: str):
    """The median over the window's frames of ``key`` ms."""
    if summary is None or not summary["frames"]:
        return None
    return statistics.median(f[key] for f in summary["frames"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from rtbench import run as runner

    runner.cache_dirs()
    import torch

    from rtbench import harness

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    man = harness.manifest()
    traffic = harness.traffic(harness.cell(man, args.workload)["traffic"])
    run = harness.Run(man, args.workload, args.seed, 0.0, False, device,
                      traffic_=dict(traffic, warmup=1))
    harness.entry(traffic["entry"]).window(run)
    print(json.dumps(measure(run, traffic["warmup"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
