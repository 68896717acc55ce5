"""Each fault a cell can have, planted in the program under the timed
path, makes ``correct`` false; a sound run is correct.  The runs skip the
harness's look for a chip and drive the rest (set-up, window, check) at a
tiny size on the CPU; the sharded cell runs on four Gloo ranks."""

from __future__ import annotations

import multiprocessing
import os
import socket

import pytest

from rtbench import faults, harness
from rtbench.tests import tiny

SEED = 3 * 2 ** 31 + 7
CASES = [(w["name"], f) for w in harness.manifest()["workloads"]
         if w["chips"] == 1
         for f in faults.OF_ENTRY[harness.traffic(w["traffic"])["entry"]]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_fails_the_check(cell, fault):
    run = tiny.drive(cell, SEED, variant=fault)
    assert not run.check.correct, run.check.as_dict()


def _rank(rank, port, cell, variant, out):
    os.environ.update(RANK=str(rank), WORLD_SIZE="4", LOCAL_RANK=str(rank))
    import torch

    torch.set_num_threads(1)
    from rtbench.run import end_group

    run = tiny.drive(cell, SEED, variant=variant, rank=rank, world=4,
                     init_method=f"tcp://localhost:{port}")
    end_group()
    if rank == 0:
        out.put((run.check.correct, run.check.as_dict()))


def _sharded(variant: str):
    cell = next(w["name"] for w in tiny.manifest()["workloads"]
                if w["chips"] == 4)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, port, cell, variant, out))
             for r in range(4)]
    for p in procs:
        p.start()
    try:
        result = out.get(timeout=240)
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs)
    return result


@pytest.mark.parametrize("variant", ["sound"] + list(
    faults.OF_ENTRY["train_sharded"]))
def test_sharded_cell(variant):
    correct, numbers = _sharded(variant)
    assert correct == (variant == "sound"), numbers
