"""A traced window: ``torch.profiler`` over a number of iterations, and the
arithmetic that turns its device trace into numbers.

Busy time is the length of the union of the device operations' intervals
(kernels, copies, memsets), the idle share 1 - busy / traced wall; the
profiler adds host time, so the idle share is an upper bound of an
untraced window's.  The kernel-name map and the union are
``profile_frames.py``'s (``KERNELS``, ``busy_us``).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

import torch

# the program's hand-written kernels by the names their launches carry:
# csrc/traverse.cu's walk is a template, <false> K1 and <true> K4, and so
# is csrc/traverse_shared.cu's for K5 and K6; K3 is csrc/scatter.cu's
# three kernels; K8 csrc/sort.cu's tile and merge kernels
KERNELS = {"K1": ("traverse_kernel<false>",),
           "K2": ("gather_f32_kernel", "gather_u8_kernel"),
           "K3": ("scatter_partials_kernel", "scatter_fixed_kernel",
                  "scatter_finish_kernel"),
           "K4": ("traverse_kernel<true>",),
           "K5": ("traverse_shared_kernel<false",),
           "K6": ("traverse_shared_kernel<true",),
           "K7": ("gather_cols_f32_kernel",),
           "K8": ("::sort_tile_kernel<", "::merge_kernel<")}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
WINDOW = "rtbench.window"
TOP = 10


def kernel_of(name: str):
    """The K-number of a kernel's name, or None."""
    for k, names in KERNELS.items():
        if any(n in name for n in names):
            return k
    return None


def is_nccl(name: str) -> bool:
    return "nccl" in name.lower()


def union_us(intervals) -> float:
    """Length of the union of (start, duration) intervals."""
    total, end = 0.0, float("-inf")
    for ts, dur in sorted(intervals):
        lo, hi = max(ts, end), ts + dur
        if hi > lo:
            total += hi - lo
        end = max(end, hi)
    return total


class Trace:
    """The device and host events of a traced window of ``iterations``
    iterations, and ``wall_s``, the host clock's length of it."""

    def __init__(self, events: list, iterations: int, wall_s: float):
        self.iterations = iterations
        self.wall_s = wall_s
        self.device = [e for e in events
                       if e.get("cat") in DEVICE_CATS and "dur" in e]
        self.kernels = [e for e in self.device if e["cat"] == "kernel"]
        self.host = [e for e in events
                     if e.get("cat") in HOST_CATS and "dur" in e]
        win = [e for e in self.host if e["name"] == WINDOW]
        self.window = (float(win[0]["ts"]), float(win[0]["dur"])) if win \
            else None
        self.graph_launches = {
            e["args"].get("correlation") for e in self.host
            if e["name"].startswith("cudaGraphLaunch")
            and "correlation" in e.get("args", {})}

    def busy_s(self) -> float:
        return union_us((float(e["ts"]), float(e["dur"]))
                        for e in self.device) / 1e6

    def kernel_ms(self, keep) -> float:
        """Device ms an iteration of the kernels whose name ``keep``
        accepts."""
        us = sum(float(e["dur"]) for e in self.kernels if keep(e["name"]))
        return us / 1e3 / self.iterations

    def count(self, keep) -> int:
        return sum(1 for e in self.kernels if keep(e["name"]))

    def graph_kernels(self) -> int:
        """Kernels launched by the graph launches of the window."""
        return sum(1 for e in self.kernels
                   if e.get("args", {}).get("correlation")
                   in self.graph_launches)

    def device_ops(self) -> list:
        """The ``TOP`` device operations by total seconds in the window."""
        per = defaultdict(float)
        for e in self.device:
            per[e["name"][:120]] += float(e["dur"]) / 1e6
        return sorted(([k, v] for k, v in per.items()),
                      key=lambda kv: -kv[1])[:TOP]

    def idle_gaps(self) -> list:
        """The ``TOP`` longest stretches of the window in which no device
        operation ran, each named by the host event that covers it: of
        those overlapping half of it or more, the shortest (the most
        specific), else the one overlapping most."""
        if self.window is None or not self.device:
            return []
        w0, wdur = self.window
        ivs = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in self.device)
        gaps, end = [], w0
        for lo, hi in ivs:
            if lo > end:
                gaps.append((end, lo))
            end = max(end, hi)
        if w0 + wdur > end:
            gaps.append((end, w0 + wdur))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
        host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                 e["name"]) for e in self.host if e["name"] != WINDOW]
        out = []
        for lo, hi in gaps:
            over = [(min(hi, b) - max(lo, a), b - a, name)
                    for a, b, name in host if b > lo and a < hi]
            name = "host: no traced event"
            half = [o for o in over if o[0] >= 0.5 * (hi - lo)]
            if half:
                name = min(half, key=lambda o: o[1])[2]
            elif over:
                name = max(over)[2]
            out.append([name[:120], (hi - lo) / 1e6])
        return out


def traced(step, iterations: int) -> Trace:
    """``step(i)`` for i in range(iterations) under ``torch.profiler``,
    the device synchronized before and after; the chrome trace is read
    back from a temporary file and removed."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW):
            for i in range(iterations):
                step(i)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events, iterations, wall)
