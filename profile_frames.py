#!/usr/bin/env python3
"""Where a frame's time goes, for the PyTorch + CUDA port on one NVIDIA
GPU: chip_smoke.py's three 1920x1080 frames (dense, sparse, large), each
rendered under ``torch.profiler``.

    python3 profile_frames.py [--frames 3] [--top 10]

Per frame it prints: the unprofiled frame time (host clock ended by a
synchronize, median of 5 after a warm-up), the BVH build alone (same
clock), the profiled wall time per frame, the device busy time (the union
of kernel intervals in the trace), the idle share 1 - busy / profiled
wall, kernels per frame, K1's and K2's device time, and the ``--top``
kernels by device time.  The profiler adds host time, so the idle share
is an upper bound of the unprofiled frame's.  Exits non-zero without a
CUDA device.
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

from chip_smoke import W, H, frames_on, wall_ms

K1_KERNEL = "traverse_kernel"
K2_KERNELS = ("gather_f32_kernel", "gather_u8_kernel")


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


def profile_frame(name, scene, cam, cfg, nframes, top):
    from raytracebvh_tpu_torch import render_frame
    from raytracebvh_tpu_torch.camera import camera_matrices
    from raytracebvh_tpu_torch.pipeline import build_bvh

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        frame_ms = wall_ms(lambda: render_frame(scene, cam, cfg))
        wvp, wv = camera_matrices(cam, cfg.width, cfg.height)
        build_ms = wall_ms(lambda: build_bvh(scene, wvp, wv, cfg))
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(nframes):
                render_frame(scene, cam, cfg)
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
    k1 = sum(v[0] for k, v in per.items() if K1_KERNEL in k)
    k2 = sum(v[0] for k, v in per.items() if any(g in k for g in K2_KERNELS))
    n1 = sum(v[1] for k, v in per.items() if K1_KERNEL in k) // nframes
    n2 = sum(v[1] for k, v in per.items()
             if any(g in k for g in K2_KERNELS)) // nframes
    print(f"== {name}: frame {frame_ms:.2f} ms unprofiled, build alone "
          f"{build_ms:.2f} ms, profiled wall {wall:.2f} ms/frame, device busy "
          f"{busy:.2f} ms -> idle share {1 - busy / wall:.3f}; "
          f"{len(kernels) // nframes} kernels/frame; K1 {k1:.3f} ms "
          f"({n1} launches), K2 {k2:.3f} ms ({n2} launches)", flush=True)
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
    for name, (scene, cam, cfg) in frames_on(dev).items():
        profile_frame(name, scene, cam, cfg, args.frames, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
