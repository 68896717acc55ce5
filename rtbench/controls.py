#!/usr/bin/env python3
"""Readings of the check at a cell's own size, from which its limits are
set: the program on many seeds ('sound'), the lower-precision control
('bf16': the program's bfloat16 path) and the planted faults
(``faults.py``), each a short window of the cell's own loop and the check
that a run makes:

    python3 rtbench/controls.py --workload <name> --variants sound,bf16 --seeds 1,2,3 [--seconds 2]

One JSON line a run on standard output: the variant, the seed, whether
the run is correct, and each number compared with its limit.  A cell on
several chips runs one process a chip, as run.py does, each running every
variant and seed in turn in one process group.  The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from rtbench import run as bench  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--variants", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def one(args, variant: str, seed: int, rank: int, world: int):
    from rtbench import faults, harness

    man = harness.manifest()
    traffic = harness.traffic(harness.cell(man, args.workload)["traffic"])
    plant = contextlib.nullcontext()
    if variant == "bf16":
        traffic = faults.bf16_traffic(traffic)
    elif variant != "sound":
        plant = faults.planted(variant)
    run_args = argparse.Namespace(workload=args.workload, seed=seed,
                                  seconds=args.seconds, trace=0,
                                  port=args.port)
    with plant:
        run, _ = bench.run_rank(run_args, rank, world, traffic)
    out = {"workload": args.workload, "variant": variant, "seed": seed,
           "correct": run.check.correct, "iterations": run.iterations,
           "checks": run.check.as_dict()}
    if "want" in run.state:  # every step's loss, the program's and the
        out["losses"] = [run.state["got"]["losses"],  # reference's
                         run.state["want"]["losses"]]
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    bench.cache_dirs()
    import torch

    from rtbench import harness

    world = harness.cell(harness.manifest(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        print(f"controls: {args.workload} needs {world} CUDA device(s)",
              file=sys.stderr)
        return 2
    runs = [(v, int(s)) for v in args.variants.split(",")
            for s in args.seeds.split(",")]
    if args.rank is not None:
        for variant, seed in runs:
            one(args, variant, seed, args.rank, world)
        bench.end_group()
        return 0

    def body():
        for variant, seed in runs:
            print(json.dumps(one(args, variant, seed, 0, world)), flush=True)

    _, ok = bench.launch(args, world, Path(__file__).resolve(), argv, body)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
