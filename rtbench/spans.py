#!/usr/bin/env python3
"""One span window a run: the program's own spans
(``raytracebvh_tpu_torch.utils.profiling``) over the cell's calls, read by
the per-layer metrics ``build.frame_ms``, ``shade.self_ms``,
``step.backward_ms``, ``graphs.host_ms`` and ``device.span_idle_share``.

The window makes the calls the cell's entry makes (``frame``: the moving
scene's ``render_frame_jit``; ``train``: ``train_step_jit`` on the run's
optimizer), each ended by a synchronize, with no profiler attached:
``WARMUP`` iterations under ``profiling.spans()`` (the spans-on graph is
captured in the first), then ``ITERATIONS[entry]`` in a second
``spans()``, the card's clock calibrated against the host's
(``profiling.clock_offset``) just before and just after.  On the card it
runs in a process of its own: the traced window runs first, and after a
``torch.profiler`` trace the same process's calls read slower, their
host spans most (PERF.md §6).  The child is
``rtbench/spans.py --workload <cell> --seed <n>``, which sets the cell up
as its entry does and prints the summary as the last line of its output.

The summary (``summarize``) holds, for each frame or step call of the
window, its top span's ms and the part of it outside its children, the
device ms of its ``build`` spans, the self time of its
``shade.*`` spans (a step's under ``forward`` only), its ``backward``, and
the host ms of its ``graphs.*`` spans; the median ms a call of each
span name; the share of the window (first
mark to last) outside every call's first-to-last mark; and the host
time of each iteration.  The ten longest gaps between two calls' marks
go to standard error, each split among the host spans that cover it and
the caller's own time.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

WARMUP = 10
ITERATIONS = {"frame": 50, "train": 20}
TOP = 10
HOST = ("graphs.key", "graphs.copy_in", "graphs.launch", "graphs.copy_out")
ROOT = Path(__file__).resolve().parent.parent


def window(run):
    """The span summary of ``run``'s cell (made once, kept in
    ``run.state``); None for an entry the window does not drive."""
    if "spans" not in run.state:
        run.state["spans"] = _make(run)
    return run.state["spans"]


def _make(run):
    from raytracebvh_tpu_torch.utils import profiling

    # a program without spans (a commit before them) has nothing to read
    if run.traffic["entry"] not in ITERATIONS or not hasattr(
            profiling, "spans"):
        return None
    if run.device.type == "cuda":
        out = _child(run)
    else:
        out = measure(run)
    report(out)
    return out


def _child(run) -> dict:
    cmd = [sys.executable, str(Path(__file__).resolve()), "--workload",
           run.name, "--seed", str(run.seed)]
    proc = subprocess.run(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                          stderr=sys.stderr, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"the span window's process exited with "
                           f"{proc.returncode}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _calls(run):
    """(one iteration, the grad mode it runs in) for the run's entry."""
    import contextlib

    import torch

    from rtbench import scenes
    from rtbench.entries.frame import render_config, sync

    dev, tr = run.device, run.traffic
    cfg = render_config(run)
    if tr["entry"] == "frame":
        from raytracebvh_tpu_torch import render_frame_jit

        raw = scenes.make_scene(run.config, run.seed, dev)
        cam = scenes.camera(run.config, dev)
        ring = scenes.pose_ring(raw, tr["poses"], tr["pose_jitter"],
                                run.seed)
        eyes = scenes.orbit_eyes(cam, tr["orbit_yaw"], tr["orbit_frames"])
        base, pcam = scenes.port_scene(raw), scenes.port_camera(cam)

        def one(i):
            render_frame_jit(base.replace(verts=ring[i % len(ring)]),
                             pcam.replace(eye=eyes[i % len(eyes)]), cfg)
            sync(dev)

        return one, torch.inference_mode
    from raytracebvh_tpu_torch.models import inverse

    st = run.state
    scene, pcam = scenes.port_scene(st["raw"]), scenes.port_camera(st["cam"])

    def one(_):
        inverse.train_step_jit(st["params"], st["opt"], scene, pcam,
                               st["target"], cfg, tr["lr"])
        sync(dev)

    return one, contextlib.nullcontext


def measure(run) -> dict:
    """The span window in this process -> ``summarize``'s summary."""
    from raytracebvh_tpu_torch.utils import profiling

    one, mode = _calls(run)
    card = run.device.type == "cuda"
    n = ITERATIONS[run.traffic["entry"]]
    times = []
    with mode():
        with profiling.spans():
            for i in range(WARMUP):
                one(i)
        start = profiling.clock_offset(run.device) if card else None
        with profiling.spans():
            for i in range(WARMUP, WARMUP + n):
                t0 = time.perf_counter_ns()
                one(i)
                times.append((time.perf_counter_ns() - t0) / 1e6)
        end = profiling.clock_offset(run.device) if card else None
        records = profiling.records()
        dropped = profiling.dropped() if card else 0
    return summarize(records, times, start, end, dropped)


def summarize(records, times, start=None, end=None, dropped=0) -> dict:
    """The window's numbers from ``profiling.records()`` (``records``),
    the iterations' host ms (``times``) and the clock offsets at the
    window's start and end (``profiling.ClockOffset`` or None, for marks
    already on the host clock).  A card's marks go onto the host clock by
    the start's offset; the drift to the end's is reported."""
    start = tuple(start) if start is not None else None
    end = tuple(end) if end is not None else None
    offset = (lambda ns: ns + start[0]) if start is not None else \
        (lambda ns: ns)
    marks = [(k, s) for k, s in enumerate(records) if s.clock != "host"]
    host = [s for s in records if s.clock == "host" and s.name in HOST]
    inner = {}  # ns of a span's children
    for s in records:
        if s.parent is not None:
            inner[s.parent] = inner.get(s.parent, 0) + s.end - s.begin
    calls = {}
    for k, s in marks:
        if s.parent is None and s.name in ("frame", "step"):
            calls[s.call] = {"call": s.call, "kind": s.name,
                             "top_ms": (s.end - s.begin) / 1e6,
                             "top_self_ms": (s.end - s.begin
                                             - inner.get(k, 0)) / 1e6}

    def ancestors(s):
        while s.parent is not None:
            s = records[s.parent]
            yield s.name

    for c in calls.values():
        c.update(build_ms=0.0, shade_self_ms=0.0, backward_ms=None,
                 host_ms=None, begin=None, end=None, by_name={})
    for k, s in marks:
        c = calls.get(s.call)
        if c is None:
            continue
        ms = (s.end - s.begin) / 1e6
        c["by_name"][s.name] = c["by_name"].get(s.name, 0.0) + ms
        b, e = offset(s.begin), offset(s.end)
        c["begin"] = b if c["begin"] is None else min(c["begin"], b)
        c["end"] = e if c["end"] is None else max(c["end"], e)
        if s.name == "build":
            c["build_ms"] += ms
        elif s.name == "backward":
            c["backward_ms"] = (c["backward_ms"] or 0.0) + ms
        elif s.name.startswith("shade.") and (
                c["kind"] == "frame" or "forward" in ancestors(s)):
            c["shade_self_ms"] += (s.end - s.begin - inner.get(k, 0)) / 1e6
    for s in host:
        c = calls.get(s.call)
        if c is not None:
            c["host_ms"] = (c["host_ms"] or 0.0) + (s.end - s.begin) / 1e6
    rows = sorted((c for c in calls.values() if c["begin"] is not None),
                  key=lambda c: c["begin"])
    idle = None
    gaps = []
    if rows:
        whole = rows[-1]["end"] - rows[0]["begin"]
        inside = sum(c["end"] - c["begin"] for c in rows)
        idle = 1.0 - inside / whole if whole > 0 else None
        for a, b in zip(rows, rows[1:]):
            gaps.append(_gap(a["end"], b["begin"], host))
    gaps.sort(key=lambda g: -g[0])
    by = {}
    for _, parts in gaps:
        for name, ms in parts.items():
            by[name] = by.get(name, 0.0) + ms
    return {"iterations": len(times), "iter_ms": times,
            "calls": [{k: c[k] for k in ("call", "kind", "top_ms",
                                         "top_self_ms", "build_ms",
                                         "shade_self_ms", "backward_ms",
                                         "host_ms")} for c in rows],
            "span_ms": {name: statistics.median(
                c["by_name"].get(name, 0.0) for c in rows)
                for name in sorted({n for c in rows for n in c["by_name"]})},
            "idle_share": idle, "gaps": gaps[:TOP],
            "gap_ms_by_span": by,
            "clock": None if start is None else {
                "offset_ns": start[0], "error_ns": start[1],
                "drift_ns": end[0] - start[0], "end_error_ns": end[1]},
            "dropped": dropped}


def _gap(lo, hi, host) -> list:
    """[ms, {span: ms}] of a gap between two calls' marks: the part each
    host span of the program covers (``graphs.*``, one after another on
    the host), and the rest as ``caller``, the caller's own time outside
    the program's calls."""
    parts, covered = {}, 0
    for s in host:
        over = min(hi, s.end) - max(lo, s.begin)
        if over > 0:
            parts[s.name] = parts.get(s.name, 0.0) + over / 1e6
            covered += over
    parts["caller"] = (hi - lo - covered) / 1e6
    return [(hi - lo) / 1e6, parts]


def median_of(summary, key: str):
    """The median over the window's calls of ``key``, or None where no
    call has it."""
    if summary is None:
        return None
    values = [c[key] for c in summary["calls"] if c[key] is not None]
    return statistics.median(values) if values else None


def report(summary) -> None:
    """The window's iteration time, clocks and longest gaps, on standard
    error."""
    if summary is None or not summary["iter_ms"]:
        return
    out = sys.stderr
    print(f"rtbench: span window {summary['iterations']} iterations, "
          f"median {statistics.median(summary['iter_ms']):.3f} ms, idle "
          f"share {summary['idle_share']}, marks dropped "
          f"{summary['dropped']}, clock {summary['clock']}; a call's top "
          f"span {median_of(summary, 'top_ms')} ms, of it outside its "
          f"children {median_of(summary, 'top_self_ms')} ms; ms a call by "
          f"span { {k: round(v, 4) for k, v in summary['span_ms'].items()} }",
          file=out)
    total = sum(ms for ms, _ in summary["gaps"])
    print(f"rtbench: span gaps, ms by covering span "
          f"{ {k: round(v, 3) for k, v in summary['gap_ms_by_span'].items()} }"
          f"; the {len(summary['gaps'])} longest ({total:.3f} ms):",
          file=out)
    for ms, parts in summary["gaps"]:
        print(f"rtbench:   {ms:.3f} ms  "
              f"{ {k: round(v, 3) for k, v in parts.items()} }", file=out,
              flush=True)


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
    run = harness.Run(harness.manifest(), args.workload, args.seed, 0.0,
                      False, device)
    harness.entry(run.traffic["entry"]).window(run)
    print(json.dumps(measure(run)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
