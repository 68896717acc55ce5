#!/usr/bin/env python3
"""Runs one cell of BENCHMARK.json once, on the CUDA devices of this machine:

    python3 rtbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up (imports, the kernels from the
checkout's build cache, the inputs from the seed, warm-up and graph
capture) is timed as ``setup_s``; then the cell's loop runs for
``--seconds`` (``--trace 0``: the end-to-end metrics) or a traced window of
a few iterations (``--trace 1``: the per-layer metrics, ``busy_s``,
``window_s`` and a breakdown); then the outputs are checked against the
plain reference.  The last line of standard output is the result, a JSON
object; the numbers compared, each with its limit, are the last lines of
standard error.  It exits non-zero, printing no result, without enough
CUDA devices, on any error, or when the process holds a module of JAX or
of the JAX package.

A cell on several chips runs one process a chip: this process is rank 0
and starts the others (``--rank``), which meet it at a TCP store on a free
localhost port; it prints the result.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
BUILD = ROOT / "build" / "rtbench"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def cache_dirs() -> None:
    """Every kernel cache inside the checkout, at fixed paths (the
    program's own nvcc build goes to build/raytracebvh_tpu_torch)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(BUILD / sub)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_rank(args, rank: int, world: int, traffic: dict = None):
    """Set-up, window, per-layer reading (rank 0) and check of this
    rank -> the Run.  ``traffic`` replaces the cell's traffic file (the
    controls' lower-precision path)."""
    import torch

    from rtbench import harness

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    init = f"tcp://localhost:{args.port}" if world > 1 else None
    run = harness.Run(harness.manifest(), args.workload, args.seed,
                      args.seconds, bool(args.trace), device, rank=rank,
                      world=world, t_start=T_START, init_method=init,
                      traffic_=traffic)
    entry = harness.entry(run.traffic["entry"])
    entry.window(run)
    run.close_trace()
    t0 = time.perf_counter()
    layer = run.per_layer() if run.trace and rank == 0 else {}
    t1 = time.perf_counter()
    entry.verify(run)
    t2 = time.perf_counter()
    print(f"rtbench: rank {rank} setup {run.setup_s:.3f} s (the "
          f"reference's target {run.reference_s:.3f} s left out), "
          f"{run.iterations} iterations, per-layer reading {t1 - t0:.3f} s, "
          f"check {t2 - t1:.3f} s", file=sys.stderr, flush=True)
    if run.ends:
        print(f"rtbench: ms an iteration, second by second: "
              f"{harness.by_second(run.ends, run.ends_per)}",
              file=sys.stderr, flush=True)
    return run, layer


def report(run, layer) -> int:
    import torch

    from rtbench import harness

    declared = {m["name"] for m in harness.metrics_of(
        run.manifest, run.name, "per_layer" if run.trace else "end_to_end")}
    values = layer if run.trace else run.end_to_end()
    metrics = {k: v for k, v in values.items() if k in declared}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": run.world, "memory_peak_bytes": run.peak_bytes}
    breakdown = None
    if run.trace:
        device.update(busy_s=run.busy_s, window_s=run.traced_s)
        breakdown = {"device_ops": run.traced.device_ops(),
                     "idle_gaps": run.traced.idle_gaps()}
    line = harness.result(run, device, metrics, breakdown)
    bad = harness.forbidden_modules()
    if bad:
        print(f"rtbench: the process holds {bad}", file=sys.stderr)
        return 1
    print(json.dumps(line), flush=True)
    for name, item in line["checks"].items():
        ok = ("ok" if isinstance(item["value"], float)
              and item["value"] <= item["limit"] else "OVER")
        print(f"check {name} {item['value']!r} limit {item['limit']!r} {ok}",
              file=sys.stderr, flush=True)
    return 0


def end_group() -> None:
    """Ends the process group of a cell on several chips, if one was made
    (its graphs first: ``parallel.mesh.destroy_distributed``)."""
    if "raytracebvh_tpu_torch.parallel.mesh" in sys.modules:
        from raytracebvh_tpu_torch.parallel import mesh

        mesh.destroy_distributed()


class Workers:
    """The other ranks of a cell on several chips, as child processes whose
    output goes to this one's standard error; a rank that fails ends the
    run."""

    def __init__(self, script, argv, world: int, port: int):
        self.procs = []
        self.done = threading.Event()
        for rank in range(1, world):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(rank))
            self.procs.append(subprocess.Popen(
                [sys.executable, str(script), *argv,
                 "--rank", str(rank), "--port", str(port)],
                env=env, stdout=sys.stderr, stderr=sys.stderr))
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self) -> None:
        while not self.done.is_set():
            for proc in self.procs:
                code = proc.poll()
                if code not in (None, 0) and not self.done.is_set():
                    print(f"rtbench: a rank exited with {code}",
                          file=sys.stderr, flush=True)
                    self.kill()
                    os._exit(1)
            time.sleep(0.5)

    def wait(self, timeout: float) -> bool:
        """Whether every rank ended with 0 within ``timeout``."""
        self.done.set()
        deadline = time.monotonic() + timeout
        ok = True
        for proc in self.procs:
            try:
                ok &= proc.wait(max(0.1, deadline - time.monotonic())) == 0
            except subprocess.TimeoutExpired:
                ok = False
        self.kill()
        return ok

    def kill(self) -> None:
        self.done.set()
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def launch(args, world: int, script: Path, argv, body):
    """Runs ``body()`` as rank 0 of a cell on ``world`` chips: for more
    than one, the kernels are built once, then the other ranks start as
    ``script argv --rank r --port p`` and meet this one at a TCP store on
    a free localhost port.  -> (what ``body`` returned, whether every rank
    ended with 0); no rank outlives the call."""
    workers = None
    try:
        if world > 1:
            from raytracebvh_tpu_torch import _kernels

            _kernels.build()  # once, before the ranks load it
            args.port = free_port()
            os.environ.update(RANK="0", WORLD_SIZE=str(world),
                              LOCAL_RANK="0")
            workers = Workers(script, argv, world, args.port)
        out = body()
        end_group()
        return out, workers is None or workers.wait(120.0)
    finally:
        if workers is not None:
            workers.kill()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    cache_dirs()
    sys.path.insert(0, str(ROOT))
    import torch

    from rtbench import harness

    man = harness.manifest()
    world = harness.cell(man, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        print(f"rtbench: {args.workload} needs {world} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    if args.rank is not None:  # a worker rank of a cell on several chips
        run_rank(args, args.rank, world)
        end_group()
        return 1 if harness.forbidden_modules() else 0
    try:
        (run, layer), ok = launch(args, world, Path(__file__).resolve(),
                                  argv, lambda: run_rank(args, 0, world))
    except Exception:
        traceback.print_exc()
        return 1
    if not ok:
        print("rtbench: a rank did not end cleanly", file=sys.stderr)
        return 1
    return report(run, layer)


if __name__ == "__main__":
    sys.exit(main())
