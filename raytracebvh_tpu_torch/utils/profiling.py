"""Tracing / profiling (the JAX package's ``utils/profiling.py``).

The same FPS meter, a per-stage breakdown of the frame pipeline with the
JAX function's stages and keys, and a context manager around
``torch.profiler.profile`` that writes a Chrome trace (in place of
``jax.profiler.trace``).  The JAX function jits each stage on its own;
on CUDA tensors each stage here is its own CUDA graph (``graphs.py``),
replayed between CUDA events, so a stage's time is its kernels' without
the host between them.  On the CPU the stages run eagerly, timed by the
host clock.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Callable, Dict

import torch


class FpsMeter:
    """Once-a-second FPS print (reference: Graphics.cpp:65-92)."""

    def __init__(self, out=None):
        self._t0 = time.perf_counter()
        self._last = self._t0
        self._frames = 0
        self._out = out

    def tick(self) -> float:
        """Count one frame; prints 'FPS: x' once per second. Returns the
        running average FPS."""
        self._frames += 1
        now = time.perf_counter()
        fps = self._frames / (now - self._t0)
        if now - self._last >= 1.0:
            print(f"FPS: {fps:.2f}", file=self._out)
            self._last = now
        return fps


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of the block (CPU activity, and CUDA
    activity where a card is visible), written as a Chrome trace
    ``rtbvh_trace_<time>_<pid>.json`` into ``log_dir``; yields that
    path.  The device is synchronized before the trace ends, so the
    block's kernels are in it."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(
        log_dir,
        f"rtbvh_trace_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}.json")
    with profile(activities=activities) as prof:
        try:
            yield path
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def _call_seconds(fn, device: torch.device) -> float:
    """Seconds of one call of ``fn()``: CUDA events around it on a CUDA
    device, the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _median_times(stages, iters: int,
                  device: torch.device) -> Dict[str, float]:
    """name -> seconds of one call of ``stages[name]()``: the median over
    ``iters`` rounds after one warm-up call each, every round calling
    every stage once in order.  The host's speed moves by tens of percent
    from one call to the next and drifts over seconds (eager stages are
    host-bound, and a replay's launch is the host's too): in rounds the
    drift hits every stage alike, and the median is not one lucky or
    unlucky call."""
    for fn in stages.values():
        fn()  # warm-up
    times = {name: [] for name in stages}
    for _ in range(iters):
        for name, fn in stages.items():
            times[name].append(_call_seconds(fn, device))
    return {name: statistics.median(t) for name, t in times.items()}


def _eager_stages(scene, camera, cfg):
    """(name -> call, (scene, bvh, rays)): the JAX function's stages, in
    its order, as eager calls on the scene's device (morton, sort
    (``cfg.sort_backend``: ``bitonic`` is kernel K8 on CUDA tensors),
    topology, fit, links, build_total, trace_shade and the whole frame),
    and the build and rays that trace_shade shades.  Each stage takes its
    inputs from one eager build made here."""
    from ..camera import camera_matrices, transform_points
    from ..config import resolve_sort_backend
    from ..ops import bvh as bvh_ops
    from ..ops import morton as morton_ops
    from ..pipeline import (build_bvh, make_rays, render_frame, shade_rays,
                            sort_codes)

    dtype = cfg.torch_dtype
    wvp, wv = camera_matrices(camera, cfg.width, cfg.height)
    sort_backend = resolve_sort_backend(cfg, scene.verts.device)

    def f_morton():
        verts_t = transform_points(scene.verts.to(dtype), wvp.to(dtype))
        smin, smax = morton_ops.scene_aabb(verts_t)
        return morton_ops.triangle_leaves(verts_t, scene.indices, smin, smax)

    codes, lmin, lmax, _ = f_morton()
    codes = codes.to(torch.int32)
    sorted_codes, _ = sort_codes(codes, sort_backend)
    topo = bvh_ops.build_topology(sorted_codes)
    bvh = build_bvh(scene, wvp, wv, cfg)
    rays = make_rays(camera, cfg)
    return {
        "morton": f_morton,
        "sort": lambda: sort_codes(codes, sort_backend),
        "topology": lambda: bvh_ops.build_topology(sorted_codes),
        "fit": lambda: bvh_ops.fit_aabbs(topo.node_lo, topo.node_hi,
                                         lmin, lmax),
        "links": lambda: bvh_ops.compute_links(topo, lmin.shape[0]),
        "build_total": lambda: build_bvh(scene, wvp, wv, cfg),
        "trace_shade": lambda: shade_rays(scene, bvh, rays, cfg),
        "frame_total": lambda: render_frame(scene, camera, cfg),
    }, (scene, bvh, rays)


def _graphed_stages(scene, camera, cfg) -> Dict[str, Callable]:
    """``_eager_stages`` with every stage captured alone into its own CUDA
    graph (each with its own memory pool), as the JAX function jits each
    stage alone: a replay a call (a chunk loop's in ``trace_shade`` as
    its WHILE node); ``frame_total`` is ``render_frame_jit``'s capture
    (its cache's).  A stage whose capture fails raises: none runs eagerly
    in its place."""
    from .. import graphs
    from ..pipeline import render_frame_jit

    eager, _ = _eager_stages(scene, camera, cfg)
    stream = graphs.Cache().stream(scene.device)
    stages = {name: graphs.Captured(eager[name], (), stream)
              for name in ("morton", "sort", "topology", "fit", "links",
                           "build_total", "trace_shade")}
    render_frame_jit(scene, camera, cfg)  # the capture, or a cached one
    return {**stages,
            "frame_total": lambda: render_frame_jit(scene, camera, cfg)}


def stage_times(scene, camera, cfg, iters: int = 5) -> Dict[str, float]:
    """Seconds per pipeline stage, each run on its own, on the scene's
    device.

    The JAX function's stages and keys, in its order (``_eager_stages``).
    On CUDA tensors each stage is its own CUDA graph, as the JAX function
    jits each alone (``_graphed_stages``), timed by CUDA events around a
    replay; on CPU tensors the stages run eagerly, timed by the host
    clock.  Each stage is timed alone, the median of ``iters`` rounds of
    all the stages (``_median_times``), so the stages do not add up to
    the build exactly.
    """
    device = scene.verts.device
    with torch.no_grad():
        if device.type == "cuda":
            with torch.inference_mode(False):
                stages = _graphed_stages(scene, camera, cfg)
        else:
            stages, _ = _eager_stages(scene, camera, cfg)
        return _median_times(stages, iters, device)


def print_stage_times(times: Dict[str, float], cfg, file=None) -> None:
    rays = cfg.width * cfg.height * (1 + cfg.bounces)
    print(f"{'stage':<12} {'ms':>10}", file=file)
    for k, v in times.items():
        print(f"{k:<12} {v * 1e3:>10.3f}", file=file)
    ft = times.get("frame_total")
    bt = times.get("build_total")
    if ft:
        print(f"rays/sec     {rays / ft:>10.3e}", file=file)
    if bt:
        print(f"builds/sec   {1.0 / bt:>10.1f}", file=file)
