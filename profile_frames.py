#!/usr/bin/env python3
"""Where a frame's time goes, for the PyTorch + CUDA port on one NVIDIA
GPU: chip_smoke.py's 1920x1080 frames (dense, sparse, large, the three
shadowed ones, refract and dense_onchip), each rendered under
``torch.profiler``, and its four training steps (sparse_train,
dense_train, onchip_train, sparse_train_culled: ``loss_fn`` +
``backward()``).

    python3 profile_frames.py [--frames 3] [--top 10] [--configs a,b]

Per frame it prints: the unprofiled frame time (host clock ended by a
synchronize, median of 5 after a warm-up), the BVH build alone (same
clock), the profiled wall time per frame, the device busy time (the union
of kernel intervals in the trace), the idle share 1 - busy / profiled
wall, kernels per frame, the device time of each of K1-K8, and the
``--top`` kernels by device time; then the same for the frame replayed
as a CUDA graph (``render_frame_jit``) and for the graphed training step
(``train_step_jit``: loss, backward and Adam, where the eager row has no
Adam), with the graph's capture ms and pool bytes and the peak device
memory of an eager and a graphed call.  The profiler adds host time, so
the idle share is an upper bound of the unprofiled frame's; it records a
loop body's kernels once a replay, however many trips ran (CUPTI), so a
chunked config's kernel counts and busy time are a body's, not the
frame's.  A culled chunked frame (sparse, sparse_shadows: 81 ray chunks
of 25 600) is first replayed without the profiler at three shares of its
chunks hit (``culled_replays``).  ``--culled`` times only that, and the
culled training step beside the unculled chunked one (``culled_steps``),
and the dense frame with ``traversal_chunk`` 25 600 beside the unchunked
one (``chunked_walks``), without the profiler: give each config a
process of its own (``--culled --configs sparse``), since a graph
captured after a torch.profiler trace in the same process can replay
slower.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import torch

from chip_smoke import (W, H, dump_routes, frames_on, train_frames,
                        value_and_grad, wall_ms)
from rtbench.tracing import KERNELS, union_us

# K3 is csrc/scatter.cu's three kernels (partials, fixed point, finish),
# one launch of its wrapper each

PASSES = {"K3": 3}
# culled_replays: captures a case, and timed replays a capture
CULLED_CAPTURES, CULLED_REPS = 3, 20
# chunked_walks: the dense frame's traversal_chunk (81 chunks at 1080p)
TRAVERSAL_CHUNK = 25600


def kernel_events(trace_path):
    """(name, start us, duration us) of every device kernel in a chrome
    trace written by torch.profiler."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
            if e.get("cat") == "kernel" and "dur" in e]


def profile_frame(name, scene, cam, cfg, nframes, top, train=False):
    """A forward frame under inference mode, or (``train``) a training
    step: loss_fn + backward() with respect to init_params(scene); then
    the same frame replayed as a CUDA graph (``render_frame_jit``), or
    the graphed step (``train_step_jit``: loss, backward and Adam)."""
    from raytracebvh_tpu_torch import pipeline, render_frame, render_frame_jit
    from raytracebvh_tpu_torch.camera import camera_matrices
    from raytracebvh_tpu_torch.models import inverse
    from raytracebvh_tpu_torch.pipeline import build_bvh

    if train:
        params = inverse.init_params(scene)
        target = torch.zeros((H, W, 4), device=scene.device)
        run = lambda: value_and_grad(params, scene, cam, target, cfg)
        gparams = inverse.init_params(scene)
        opt = inverse.make_optimizer(gparams, 1e-2, capturable=True)
        graphed = lambda: inverse.train_step_jit(gparams, opt, scene, cam,
                                                 target, cfg, lr=1e-2)
        mode = torch.enable_grad
    else:
        opt = None
        run = lambda: render_frame(scene, cam, cfg)
        graphed = lambda: render_frame_jit(scene, cam, cfg)
        mode = torch.inference_mode
    if not train and cfg.ray_chunk and cfg.cull_empty_chunks:
        culled_replays(name, scene, cam, cfg)
    with mode():
        wvp, wv = camera_matrices(cam, cfg.width, cfg.height)
        build_ms = wall_ms(lambda: build_bvh(scene, wvp, wv, cfg))
        profile_run(name, run, nframes, top,
                    f", build alone {build_ms:.2f} ms")
        profile_run(f"{name} graphed", graphed, nframes, top)
        if train:
            (entry,) = inverse.step_graphs(opt).entries.values()
            entry = entry.captured
        else:
            (entry,) = pipeline.FRAME_GRAPHS.entries.values()
        peak = []
        for fn in (run, graphed):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            peak.append(torch.cuda.max_memory_allocated())
        log = capture_of(entry)
        print(f"   {name} graphed: capture {log.capture_ms:.1f} ms, graph "
              f"pool {log.pool_bytes} bytes; peak device memory eager "
              f"{peak[0]} bytes, graphed {peak[1]}", flush=True)
    pipeline.FRAME_GRAPHS.clear()


def replay_ms(fn, reps: int) -> float:
    """Median ms of ``fn`` by CUDA events around a call, over ``reps``
    calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def culled_replays(name, scene, cam, cfg):
    """The culled frame through ``render_frame_jit`` with the config's
    camera, at ortho_scale 2 (fewer chunks hit) and with the camera
    turned away (none): ``CULLED_CAPTURES`` captures each (the cache
    cleared between), each replayed ``CULLED_REPS`` times; per case the
    chunks hit, and per capture the median replay ms (the host's copies
    of the inputs included), its capture ms and its graph pool bytes."""
    from raytracebvh_tpu_torch import pipeline, render_frame_jit

    away = cam.replace(at=cam.at.new_tensor([0.0, 5.0, -200.0]))
    for case, c, run in (("camera", cam, cfg),
                         ("ortho 2", cam, cfg.replace(ortho_scale=2.0)),
                         ("away", away, cfg)):
        rows = []
        for k in range(CULLED_CAPTURES + 1):
            pipeline.FRAME_GRAPHS.clear()
            torch.cuda.empty_cache()
            pipeline.FRAME_GRAPHS.debug = k == CULLED_CAPTURES
            with torch.inference_mode():
                img = render_frame_jit(scene, c, run)
            (entry,) = pipeline.FRAME_GRAPHS.entries.values()
            if pipeline.FRAME_GRAPHS.debug:  # one more, for its nodes
                nodes = kernel_nodes(entry)
                break
            with torch.inference_mode():
                ms = replay_ms(lambda: render_frame_jit(scene, c, run),
                               CULLED_REPS)
            log = capture_of(entry)
            rows.append(f"{ms:.2f} ms (capture {log.capture_ms:.0f} ms, "
                        f"pool {log.pool_bytes} bytes, trips "
                        f"{trips_of(entry)})")
        pipeline.FRAME_GRAPHS.debug = False
        pipeline.FRAME_GRAPHS.clear()
        bg = img.new_tensor(run.background)
        chunks = img.reshape(-1, run.ray_chunk, 4)
        hit = int((chunks - bg).abs().ge(1e-6).any(-1).any(-1).sum())
        print(f"   {name} graphed, {case}: {hit} of {chunks.shape[0]} chunks "
              f"hit; {nodes[0]} kernel nodes in {nodes[1]} graphs; replay by "
              "capture: " + "; ".join(rows), flush=True)


def capture_of(entry):
    """The capture log's record of a ``graphs.Captured``
    (``profiling.captures``: its capture and warm-up ms, its pool bytes)."""
    from raytracebvh_tpu_torch.utils import profiling

    return next(r for r in reversed(profiling.captures(live=True))
                if r.owner() is entry)


def trips_of(entry):
    """The trip counters of a graphs.Captured after its last replay (a
    graph without loops: [])."""
    return [int(t) for t in entry.trips]


def kernel_nodes(entry):
    """(kernel nodes in all, graphs) of a graphs.Captured made with
    ``debug``: the captured graph and each conditional node's body."""
    _, nodes, per, _ = dump_routes(entry.graph)
    return nodes, len(per)


def culled_steps(name, scene, cam, cfg):
    """The culled training step (``cfg``) and the same step unculled (its
    chunk loop over every chunk): graphed (``train_step_jit``)
    ``CULLED_CAPTURES`` captures, each replayed ``CULLED_REPS`` times
    (median ms by CUDA events), with capture ms, pool bytes and trip
    counters; one more capture kept for its kernel nodes; eager
    ``loss_fn`` + ``backward()`` (host clock, median of 5), and the peak
    device memory of an eager and a graphed step."""
    from raytracebvh_tpu_torch.models import inverse

    target = torch.zeros((H, W, 4), device=scene.device)
    for case, run in (("culled", cfg),
                      ("unculled", cfg.replace(cull_empty_chunks=False))):
        rows = []
        for k in range(CULLED_CAPTURES + 1):
            gc.collect()  # the last capture's optimizer and its graph
            torch.cuda.empty_cache()
            params = inverse.init_params(scene)
            opt = inverse.make_optimizer(params, 1e-2, capturable=True)
            debug = k == CULLED_CAPTURES
            inverse.step_graphs(opt).debug = debug

            def step():
                inverse.train_step_jit(params, opt, scene, cam, target, run,
                                       lr=1e-2)

            step()
            (entry,) = inverse.step_graphs(opt).entries.values()
            entry = entry.captured
            if debug:
                nodes = kernel_nodes(entry)
                break
            ms = replay_ms(step, CULLED_REPS)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            step()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            log = capture_of(entry)
            rows.append(f"{ms:.2f} ms (capture {log.capture_ms:.0f} ms, "
                        f"pool {log.pool_bytes} bytes, peak {peak} bytes, "
                        f"trips {trips_of(entry)})")
            del entry, step, params, opt
        eager = lambda: value_and_grad(inverse.init_params(scene), scene,
                                       cam, target, run)
        eager_ms = wall_ms(eager)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eager()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        print(f"   {name} {case} step: eager loss_fn + backward "
              f"{eager_ms:.2f} ms, peak {peak} bytes; graphed "
              f"({nodes[0]} kernel nodes in {nodes[1]} graphs) replay by "
              f"capture: " + "; ".join(rows), flush=True)


def chunked_walks(name, scene, cam, cfg):
    """The frame ``cfg`` with ``traversal_chunk`` TRAVERSAL_CHUNK and
    without: eager ``render_frame`` (host clock, median of 5) and
    ``render_frame_jit`` (``CULLED_CAPTURES`` captures, each replayed
    ``CULLED_REPS`` times, median ms by CUDA events), the graph's kernel
    nodes, and whether the chunked image is the unchunked one's bits."""
    from raytracebvh_tpu_torch import pipeline, render_frame, render_frame_jit

    images = []
    for chunk in (TRAVERSAL_CHUNK, 0):
        run = cfg.replace(traversal_chunk=chunk)
        with torch.inference_mode():
            images.append(render_frame(scene, cam, run))
            eager_ms = wall_ms(lambda: render_frame(scene, cam, run))
        rows = []
        for k in range(CULLED_CAPTURES + 1):
            pipeline.FRAME_GRAPHS.clear()
            torch.cuda.empty_cache()
            pipeline.FRAME_GRAPHS.debug = k == CULLED_CAPTURES
            with torch.inference_mode():
                render_frame_jit(scene, cam, run)
            (entry,) = pipeline.FRAME_GRAPHS.entries.values()
            if pipeline.FRAME_GRAPHS.debug:  # one more, for its nodes
                nodes = kernel_nodes(entry)
                break
            with torch.inference_mode():
                ms = replay_ms(lambda: render_frame_jit(scene, cam, run),
                               CULLED_REPS)
            log = capture_of(entry)
            rows.append(f"{ms:.2f} ms (capture {log.capture_ms:.0f} ms, "
                        f"pool {log.pool_bytes} bytes)")
        pipeline.FRAME_GRAPHS.debug = False
        pipeline.FRAME_GRAPHS.clear()
        print(f"   {name}, traversal_chunk {chunk}: eager {eager_ms:.2f} ms; "
              f"graphed ({nodes[0]} kernel nodes) replay by capture: "
              + "; ".join(rows), flush=True)
    same = torch.equal(images[0], images[1])
    print(f"   {name}: the chunked image is "
          f"{'' if same else 'NOT '}the unchunked one's bits", flush=True)


def profile_run(name, run, nframes, top, extra=""):
    """One row: ``run``'s unprofiled time, then ``nframes`` calls, each
    under a torch.profiler trace of its own (a trace of several replays
    of a graph with conditional nodes misnames the kernels in their
    bodies)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    frame_ms = wall_ms(run)
    kernels, wall, busy = [], 0.0, 0.0
    for _ in range(nframes):
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall += (time.perf_counter() - t0) * 1e3 / nframes
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            one = kernel_events(path)
        busy += union_us((ts, dur) for _, ts, dur in one) / 1e3 / nframes
        kernels += one
    per = defaultdict(lambda: [0.0, 0])
    for kname, _, dur in kernels:
        per[kname][0] += dur / 1e3 / nframes
        per[kname][1] += 1
    ours = []
    for k, names in KERNELS.items():
        mine = [v for kname, v in per.items() if any(g in kname for g in names)]
        launches = sum(v[1] for v in mine) // PASSES.get(k, 1) // nframes
        ours.append(f"{k} {sum(v[0] for v in mine):.3f} ms "
                    f"({launches} launches)")
    print(f"== {name}: frame {frame_ms:.2f} ms unprofiled{extra}, profiled "
          f"wall {wall:.2f} ms/frame, device busy {busy:.2f} ms -> idle "
          f"share {1 - busy / wall:.3f}; {len(kernels) // nframes} "
          f"kernels/frame; {', '.join(ours)}", flush=True)
    ranked = sorted(per.items(), key=lambda kv: -kv[1][0])[:top]
    for kname, (ms, count) in ranked:
        print(f"  {ms:9.3f} ms {count // nframes:7d}x  {kname[:100]}")
    if not kernels:
        raise SystemExit(f"{name}: the trace holds no device kernel")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=3,
                   help="frames rendered under the profiler per config")
    p.add_argument("--top", type=int, default=10,
                   help="kernels listed per frame, by device time")
    p.add_argument("--configs", default="",
                   help="comma-separated frames and steps to profile "
                        "(default: all)")
    p.add_argument("--culled", action="store_true",
                   help="only the culled configs' graphed replays and "
                        "steps and the dense frame's traversal_chunk, "
                        "without the profiler")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_frames: no CUDA device visible", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    print(f"{W}x{H} frames, {args.frames} profiled each", flush=True)
    frames = frames_on(dev)
    train = train_frames(frames)
    only = set(filter(None, args.configs.split(",")))
    unknown = only - set(frames) - set(train)
    if unknown:
        p.error(f"unknown configs {sorted(unknown)}")
    for runs, is_train in ((frames, False), (train, True)):
        for name, (scene, cam, cfg) in runs.items():
            if only and name not in only:
                continue
            if not args.culled:
                profile_frame(name, scene, cam, cfg, args.frames, args.top,
                              train=is_train)
            elif cfg.ray_chunk and cfg.cull_empty_chunks:
                (culled_steps if is_train else culled_replays)(
                    name, scene, cam, cfg)
            elif name == "dense":
                chunked_walks(name, scene, cam, cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
