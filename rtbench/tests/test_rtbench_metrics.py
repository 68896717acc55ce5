"""The metric arithmetic: a rate is all the work over all the window's
time, a tail is the tail of every frame, and the trace's reductions (busy
union, kernels by name, a replay's kernels, idle gaps) and the gathers'
byte count."""

from __future__ import annotations

import importlib.util
import time

import pytest
import torch

from rtbench import harness, roofline, tracing
from rtbench.tests import tiny


def test_p95_is_nearest_rank_over_all_frames():
    lat = [float(i) for i in range(1, 101)]
    assert harness.p95(lat) == 95.0
    assert harness.p95(lat[::-1]) == 95.0
    assert harness.p95([3.0]) == 3.0
    # one stall in twenty frames is the tail
    assert harness.p95([1.0] * 19 + [9.0]) == 1.0
    assert harness.p95([1.0] * 18 + [9.0, 9.0]) == 9.0


def _run(cell="sphere3k-frame"):
    return harness.Run(tiny.manifest(), cell, 1, 1.0, False,
                       torch.device("cpu"))


def test_rate_is_all_work_over_all_time():
    run = _run()
    run.rays_per_iteration = 2_000_000
    run.iterations = 300
    run.window_s = 4.0
    assert run.mrays_s() == pytest.approx(2e6 * 300 / 4.0 / 1e6)
    assert run.step_ms() == pytest.approx(4.0 / 300 * 1e3)


def test_closed_frames_counts_every_frame_and_all_time():
    calls = []
    lat, window = harness.closed_frames(
        lambda i: (calls.append(i), time.sleep(0.01)), 0.1)
    assert len(lat) == len(calls) >= 5
    assert window >= 0.1
    assert sum(lat) <= window


def test_closed_steps_ends_on_a_read():
    n, window = harness.closed_steps(lambda i: torch.tensor(1.0), 0.05, 7)
    assert n % 7 == 0 and window >= 0.05


def _events():
    k = lambda name, ts, dur, corr: {"cat": "kernel", "name": name, "ts": ts,
                                     "dur": dur, "args": {"correlation": corr}}
    return [
        {"cat": "user_annotation", "name": tracing.WINDOW, "ts": 0.0,
         "dur": 100.0},
        {"cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 1.0,
         "dur": 2.0, "args": {"correlation": 7}},
        {"cat": "cpu_op", "name": "aten::copy_", "ts": 45.0, "dur": 10.0},
        k("void rtbvh::traverse_kernel<false>(...)", 10.0, 10.0, 7),
        k("void rtbvh::gather_f32_kernel(...)", 15.0, 10.0, 7),
        k("elementwise_add", 30.0, 10.0, 7),
        k("ncclKernel_AllReduce", 60.0, 20.0, 9),
        {"cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 85.0, "dur": 5.0},
    ]


def test_trace_reductions():
    tr = tracing.Trace(_events(), iterations=2, wall_s=100e-6)
    # union: [10, 25] + [30, 40] + [60, 80] + [85, 90]
    assert tr.busy_s() == pytest.approx(50e-6)
    assert tr.graph_kernels() == 3
    assert tr.kernel_ms(lambda n: tracing.kernel_of(n) == "K1") == \
        pytest.approx(10e-3 / 2)
    assert tr.count(tracing.is_nccl) == 1
    gaps = tr.idle_gaps()
    # [40, 60] under the copy, [0, 10] beside the graph launch, and three
    # stretches with no host event
    assert gaps[0] == ["aten::copy_", pytest.approx(20e-6)]
    assert gaps[1] == ["cudaGraphLaunch", pytest.approx(10e-6)]
    assert sum(s for _, s in gaps) == pytest.approx(50e-6)
    ops = tr.device_ops()
    assert ops[0] == ["ncclKernel_AllReduce", pytest.approx(20e-6)]


def _reader(name):
    path = harness.BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_readers_on_a_trace():
    run = _run("sphere3k-train4")
    run.traced = tracing.Trace(_events(), iterations=2, wall_s=100e-6)
    run.close_trace()
    assert _reader("walk.device_ms")(run) == pytest.approx(5e-3)
    assert _reader("comm.device_ms")(run) == pytest.approx(10e-3)
    assert _reader("shade.other_ms")(run) == pytest.approx(5e-3)
    assert _reader("graphs.kernels")(run) == 3.0
    assert _reader("device.idle_share")(run) == pytest.approx(0.5)
    # nothing to read: no result, never a 0
    run.traced = tracing.Trace([], iterations=2, wall_s=1.0)
    for name in ("walk.device_ms", "comm.device_ms", "graphs.kernels",
                 "gather_roofline", "shade.other_ms"):
        assert _reader(name)(run) is None


def test_gather_bytes_follow_the_hits_not_a_layout():
    one = roofline.gather_bytes([(1000, 10)], 0, False)
    assert one == 1000 * (8 + 54 * 4) + 10 * 38 * 4
    assert roofline.gather_bytes([(1000, 10), (1000, 10)], 5, False) == \
        2 * one + 10
    assert roofline.gather_bytes([(0, 0)], 0, True) == 0
    assert roofline.gather_bytes([(1, 1)], 0, True) > \
        roofline.gather_bytes([(1, 1)], 0, False)


def test_check_counts_a_nan_as_failed_and_keeps_json_valid():
    import json

    chk = harness.Check()
    chk.add("a", 0.5, 1.0)
    assert chk.correct and chk.failed == 0
    chk.add("b", float("nan"), 1.0)
    assert not chk.correct and chk.failed == 1
    text = json.dumps(chk.as_dict(), allow_nan=False)
    assert json.loads(text)["b"]["value"] == "nan"
    chk.worst("a", 2.0, 1.0)
    assert chk.as_dict()["a"]["value"] == 2.0 and chk.failed == 2
