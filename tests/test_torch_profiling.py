"""The port's profiling and logging tools (``utils/profiling.py``,
``utils/logging.py``, ``cli/profile.py``) against the JAX package's, on
the CPU: the stage keys and their order, the printed table, the Chrome
trace, the JSONL metrics lines.  Times are host-clock numbers of a CPU
run here and are only checked to be finite and positive."""

import io
import json
import math

import numpy as np
import pytest
import torch

import raytracebvh_tpu as J
from raytracebvh_tpu.core.types import scene_to_device
from raytracebvh_tpu.models.procedural import random_triangles as j_random
from raytracebvh_tpu.utils import logging as j_logging
from raytracebvh_tpu.utils import profiling as j_profiling
import raytracebvh_tpu_torch as T
from raytracebvh_tpu_torch.cli import profile as t_profile_cli
from raytracebvh_tpu_torch.io.obj import write_obj
from raytracebvh_tpu_torch.models.procedural import random_triangles as t_random
from raytracebvh_tpu_torch.utils import logging as t_logging
from raytracebvh_tpu_torch.utils import profiling as t_profiling

CFG = dict(width=16, height=16, bounces=1, ortho_scale=0.5)


@pytest.fixture(scope="module")
def jax_times():
    return j_profiling.stage_times(
        scene_to_device(j_random(120, seed=3)), J.Camera.default(),
        J.RenderConfig(**CFG), iters=1)


@pytest.mark.parametrize("sort", ["lax", "bitonic", "radix"])
def test_stage_times_keys_like_jax(jax_times, sort):
    times = t_profiling.stage_times(
        t_random(120, seed=3, device="cpu"), T.Camera.default("cpu"),
        T.RenderConfig(sort_backend=sort, **CFG), iters=1)
    assert list(times) == list(jax_times) == [
        "morton", "sort", "topology", "fit", "links", "build_total",
        "trace_shade", "frame_total"]
    assert all(math.isfinite(v) and v > 0 for v in times.values()), times


def test_stage_timer_takes_the_median_in_rounds():
    """A stage's time is the median of its calls after the warm-up, not
    one fast call (calls of 30, 1 and 30 ms read 30 ms and a few ms of
    sleep overrun), and every round calls every stage in order, so a
    drift in the host's speed hits every stage alike."""
    import time

    calls = []
    waits = iter([0.0, 0.03, 0.001, 0.03])  # warm-up, then three rounds

    def slow():
        calls.append("slow")
        time.sleep(next(waits))

    stages = {"slow": slow, "quick": lambda: calls.append("quick")}
    t = t_profiling._median_times(stages, 3, torch.device("cpu"))
    assert list(t) == ["slow", "quick"]
    assert 0.03 <= t["slow"] < 0.045, t
    assert calls == ["slow", "quick"] * 4


def test_print_stage_times_like_jax(jax_times):
    cfg_j, cfg_t = J.RenderConfig(**CFG), T.RenderConfig(**CFG)
    want, got = io.StringIO(), io.StringIO()
    j_profiling.print_stage_times(jax_times, cfg_j, file=want)
    t_profiling.print_stage_times(jax_times, cfg_t, file=got)
    assert got.getvalue() == want.getvalue()
    assert len(got.getvalue().splitlines()) == 11


def test_trace_writes_chrome_trace(tmp_path):
    scene = t_random(60, seed=1, device="cpu")
    with t_profiling.trace(str(tmp_path / "tr")) as path:
        T.render_frame(scene, T.Camera.default("cpu"), T.RenderConfig(**CFG))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_fps_meter_counts_frames():
    out = io.StringIO()
    meter = t_profiling.FpsMeter(out)
    assert all(meter.tick() > 0 for _ in range(3))


def test_profile_cli_on_the_cpu(tmp_path, capsys):
    obj = write_obj(t_random(120, seed=3, with_texture=True,
                                   device="cpu"), str(tmp_path))
    rc = t_profile_cli.main(["--obj", obj, "--width", "16", "--height", "16",
                             "--iters", "1", "--sort", "bitonic",
                             "--device", "cpu", "--trace",
                             str(tmp_path / "tr")])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["stage", "ms"]
    assert [ln.split()[0] for ln in lines[1:9]] == [
        "morton", "sort", "topology", "fit", "links", "build_total",
        "trace_shade", "frame_total"]
    assert lines[-1].startswith("trace written to ")
    if not torch.cuda.is_available():
        assert t_profile_cli.main(["--obj", obj]) == 1
    assert t_profile_cli.main(["--obj", str(tmp_path / "missing.obj"),
                               "--device", "cpu"]) == 1


def _metrics_lines(writer_cls, path):
    with writer_cls(str(path)) as mw:
        mw.write("frame", frame=0, ms=12.5, mrays_per_sec=3.25)
        mw.write("step", step=7, loss=0.125, tag="x")
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def test_metrics_writer_lines_like_jax(tmp_path):
    want = _metrics_lines(j_logging.MetricsWriter, tmp_path / "j.jsonl")
    got = _metrics_lines(t_logging.MetricsWriter, tmp_path / "t.jsonl")
    assert [list(r) for r in got] == [list(r) for r in want]
    for g, w in zip(got, want):
        assert isinstance(g.pop("ts"), float)
        w.pop("ts")
        assert g == w
    with t_logging.MetricsWriter(None) as mw:  # a None path writes nothing
        mw.write("frame", frame=0)


def test_get_logger_level(monkeypatch):
    monkeypatch.setenv("RTBVH_LOG_LEVEL", "warning")
    log = t_logging.get_logger()
    assert log.name == "rtbvh" and log.level == j_logging.logging.WARNING
    assert t_logging.get_logger(level="debug").level == 10


def test_render_cli_metrics_through_the_writer(tmp_path):
    """cli.render --metrics writes one JSONL line a frame, the JAX
    render CLI's fields."""
    from raytracebvh_tpu_torch.cli import render as cli

    obj = tmp_path / "tri.obj"
    obj.write_text("v -1 -1 5\nv 1 -1 5\nv 0 1 5\nvt 0 0\nvt 1 0\nvt 0 1\n"
                   "vn 0 0 -1\nf 1/1/1 2/2/1 3/3/1\n")
    metrics = tmp_path / "m.jsonl"
    assert cli.main(["--obj", str(obj), "--width", "16", "--height", "16",
                     "--bounces", "0", "--frames", "2", "--out",
                     str(tmp_path / "o.bmp"), "--metrics", str(metrics),
                     "--device", "cpu"]) == 0
    recs = [json.loads(ln) for ln in metrics.read_text().splitlines()]
    assert [list(r) for r in recs] == [
        ["ts", "event", "frame", "ms", "mrays_per_sec"]] * 2
    assert [r["frame"] for r in recs] == [0, 1]
    assert all(np.isfinite(r["ms"]) and r["ms"] > 0 for r in recs)


def test_stage_times_on_the_cpu_stay_eager(monkeypatch):
    """On CPU tensors stage_times runs the eager stages: no capture is
    attempted (the CUDA graphs are the card's, tests/test_torch_cuda.py),
    and the stages are the eager ones, in the JAX function's order."""
    from raytracebvh_tpu_torch import graphs

    def refuse(*a, **k):
        raise AssertionError("stage_times captured on the CPU")

    monkeypatch.setattr(graphs, "Captured", refuse)
    scene = t_random(120, seed=3, device="cpu")
    cfg = T.RenderConfig(**CFG)
    times = t_profiling.stage_times(scene, T.Camera.default("cpu"), cfg,
                                    iters=1)
    stages, (s, bvh, rays) = t_profiling._eager_stages(
        scene, T.Camera.default("cpu"), cfg)
    assert list(times) == list(stages)
    assert s is scene and rays.origin.shape == (16 * 16, 3)
    assert torch.equal(stages["frame_total"](),
                       T.render_frame(scene, T.Camera.default("cpu"), cfg))
