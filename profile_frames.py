#!/usr/bin/env python3
"""Where a frame's time goes, for the PyTorch + CUDA port on one NVIDIA
GPU: chip_smoke.py's 1920x1080 frames (dense, sparse, large, the three
shadowed ones, refract and dense_onchip), each rendered under
``torch.profiler``, and its three training steps (sparse_train,
dense_train, onchip_train: ``loss_fn`` + ``backward()``).

    python3 profile_frames.py [--frames 3] [--top 10]

Per frame it prints: the unprofiled frame time (host clock ended by a
synchronize, median of 5 after a warm-up), the BVH build alone (same
clock), the profiled wall time per frame, the device busy time (the union
of kernel intervals in the trace), the idle share 1 - busy / profiled
wall, kernels per frame, the device time of each of K1-K8, and the
``--top`` kernels by device time; then the same for the frame replayed
as a CUDA graph (``render_frame_jit``) and for the graphed training step
(``train_step_jit``: loss, backward and Adam, where the eager row has no
Adam).  The profiler adds host time, so the idle share is an upper bound
of the unprofiled frame's.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import torch

from chip_smoke import W, H, frames_on, train_frames, value_and_grad, wall_ms

# csrc/traverse.cu's walk is a template: <false> is K1, <true> is K4, and
# so is csrc/traverse_shared.cu's for K5 and K6; K3 is csrc/scatter.cu's
# three kernels (partials, fixed point, finish), one launch of its wrapper
# each; K7 is one kernel, a template on its vector width; K8 is one kernel
# a sort up to 16 384 codes (csrc/sort.cu), so its count is of kernels
KERNELS = {"K1": ("traverse_kernel<false>",),
           "K2": ("gather_f32_kernel", "gather_u8_kernel"),
           "K3": ("scatter_partials_kernel", "scatter_fixed_kernel",
                  "scatter_finish_kernel"),
           "K4": ("traverse_kernel<true>",),
           "K5": ("traverse_shared_kernel<false",),
           "K6": ("traverse_shared_kernel<true",),
           "K7": ("gather_cols_f32_kernel",),
           "K8": ("::sort_tile_kernel<", "::merge_kernel<")}
PASSES = {"K3": 3}


def kernel_events(trace_path):
    """(name, start us, duration us) of every device kernel in a chrome
    trace written by torch.profiler."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
            if e.get("cat") == "kernel" and "dur" in e]


def busy_us(kernels):
    """Length of the union of the kernels' intervals."""
    total, end = 0.0, float("-inf")
    for _, ts, dur in sorted(kernels, key=lambda k: k[1]):
        lo, hi = max(ts, end), ts + dur
        if hi > lo:
            total += hi - lo
        end = max(end, hi)
    return total


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
        run = lambda: render_frame(scene, cam, cfg)
        graphed = lambda: render_frame_jit(scene, cam, cfg)
        mode = torch.inference_mode
    with mode():
        wvp, wv = camera_matrices(cam, cfg.width, cfg.height)
        build_ms = wall_ms(lambda: build_bvh(scene, wvp, wv, cfg))
        profile_run(name, run, nframes, top,
                    f", build alone {build_ms:.2f} ms")
        profile_run(f"{name} graphed", graphed, nframes, top)
    pipeline.FRAME_GRAPHS.clear()


def profile_run(name, run, nframes, top, extra=""):
    """One row: ``run``'s unprofiled time, then ``nframes`` calls under
    torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    frame_ms = wall_ms(run)
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(nframes):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / nframes
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        kernels = kernel_events(path)
    busy = busy_us(kernels) / 1e3 / nframes
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
    for name, (scene, cam, cfg) in frames.items():
        profile_frame(name, scene, cam, cfg, args.frames, args.top)
    for name, (scene, cam, cfg) in train_frames(frames).items():
        profile_frame(name, scene, cam, cfg, args.frames, args.top,
                      train=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
