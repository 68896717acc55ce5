#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (raytracebvh_tpu_torch) on one
NVIDIA GPU: builds the hand-written kernels K1-K8, S (the frames'
shading) and P (the build's leaf pack), holds each against its plain
PyTorch version at the main path's shapes, renders nine 1920x1080
frames through ``render_frame`` (forward, shadowed, refractive, the
small-scene on-chip configuration and bfloat16), runs the
inverse-rendering training step at 1920x1080 on three frames, runs
the render, train and profile CLIs (which replay CUDA graphs, as the JAX
CLIs run jitted programs), the depth reference image and the native
asset loader, the multi-device path (parallel/) over NCCL, and the
frame and the step as CUDA graphs (render_frame_jit, train_step_jit).

    python3 chip_smoke.py

Phases (one line of output each, or more):
  1. device: the card's name and power limit (nvidia-smi)
  2. build: nvcc over raytracebvh_tpu_torch/csrc/*.cu (one nvcc a source,
     all at once), with its seconds
  3. kernels: K1 (nearest-hit traversal), K2 (row gather), K4 (any-hit
     traversal), K3 (K2's backward, the scatter-add), K5 and K6 (K1 and K4
     with the tree in shared memory), K7 (column gather from a
     channel-major table) and K8 (stable sort of the build's codes, both
     routes) against their plain versions on the very inputs the main path
     hands them (the walks K1, K4, K5 and K6 exactly, every output and
     step count, with each launch's lane efficiency: K1 on the dense
     frame's primary and bounce launches and the large frame's, K4 on the
     dense and large shadow launches; K3 on dense_train's two calls,
     onchip_train's and the first of sparse_train_culled's (one shaded
     chunk's 25 600 ids), also against a float64 sum, and against itself:
     two launches, 0 differing bits; K7's backward against K3 through K2; K8
     also against torch.sort(stable=True), at the edges of its routes,
     with its kernels counted by torch.profiler); their times beside the
     plain versions' (CUDA events around the wrapper, median of 5), their
     bounds, a library call where one computes the same function; the
     kernels' device time (torch.profiler), beside the library call's for
     K2, K3, K7 and K8, for K3 by kernel, for K7 beside K2 on the
     row-major copy of its table; for K5/K6 K1/K4's time on the same rays
     at three tree sizes and on a sparse chunk, also as device time, and
     the staging alone (K1 beside it: launch and ray I/O); the build's
     topology (ops.bvh.build_topology, the range-min emit) on the dense
     and large frames' sorted codes bit for bit the search
     karras_children, with the kernels a call of each (torch.profiler)
  4. main path: the dense, sparse and large frames, then dense_shadows,
     sparse_shadows, large_shadows, refract, dense_onchip, dense_bf16
     and dense_bf16_onchip (the dense frame in bfloat16 through K1/K2 and
     through K5/K7/K8, held to the plain path given its kernels' float32
     casts); every
     kernel's launch count over each frame (counts set to 0 just before
     it, read just after; a culled frame's one walk for every chunk and a
     loop body's trip a shaded chunk; S two a shading pass in float32,
     none in bfloat16); frame ms and Mrays/s (median of 5
     after one warm-up); each image but sparse's and large's against the
     all-plain-PyTorch render, and dense_onchip's against the same config
     through K1/K4/K2/lax, bit for bit; the dense frame with
     traversal_chunk 25 600 and 1 000 (which does not divide the rays),
     eager and through render_frame_jit, each bit for bit the dense image
     with its launches (K1 2: a kernel route ignores the chunk)
  5. training: models.inverse.loss_fn + backward() and train_step on
     sparse_train (bench.py:319-320's cfg_bwd), dense_train, onchip_train
     and sparse_train_culled (the sparse frame's config: the chunk loop
     over the hit chunks, each shaded chunk's VJP in a second loop over
     them, pipeline._ChunkMap); launch counts (K3 twice a step, twice a
     shaded chunk; the unculled chunked step every chunk's), loss
     bit-equal to the all-plain step (and onchip_train's to
     dense_train's, sparse_train_culled's to the unculled chunked
     step's), gradients within GRAD_TOL of it (and of the unculled
     step's, whether bit for bit logged), 3 Adam steps; step ms (median
     of 5), Mrays/s and peak device memory (also of the unculled chunked
     step)
  6. cli: raytracebvh_tpu_torch.cli.render on an OBJ + MTL + BMP copy of
     the 3 072-triangle scene, plain and with --shadows --refract; its
     default backend runs K5 (and K6) there
  7. train cli: raytracebvh_tpu_torch.cli.train at 1920x1080 on that OBJ
     with --self-target: two uninterrupted 4-step runs with checkpoints
     every 2 steps, and a 2-step run resumed to 4 from its checkpoint;
     K5, K2 and K3 (twice a step) launched, never K1/K4; losses finite and
     falling; the resumed run's final leaves equal the uninterrupted
     run's within the spread of the two uninterrupted runs (bit for bit
     where they agree bit for bit); steps/s, the checkpoint's size, and
     its save and restore ms
  8. profile cli: raytracebvh_tpu_torch.cli.profile at 1920x1080 on that
     OBJ and on an OBJ of the large scene (read by the native loader),
     with --sort lax and --sort bitonic (K8 in the sort stage), each
     stage its own CUDA graph, each stage's replay the median of 40
     rounds: the stage tables, every stage finite and positive, the
     graphed build within the graphed frame; beside the lax tables the
     same stages eager (median of 10 rounds); a Chrome trace (--trace)
     that names K5, K2 and K8; the stages of the sparse frame (culled
     chunks): trace_shade one graph, a replay under sync-debug mode
     "error" shade_rays' bits and its loop's trip counter the hit
     chunks, its eager launches phase 4's sparse walks and bodies (a
     replay's: phase 12)
  9. depth image and loader: ref.refimage.render_depth_bmp at 500x500 on
     the 3 072-triangle scene, a CUDA graph (K5 inside), its capture's
     replay and a second replay byte for byte its eager body's and the
     plain walk's on the card, the graphed and eager ms; io.obj.load_obj's
     native loader bit for bit against the Python one on both OBJs, with
     their seconds
 10. multi-device: parallel.mesh.initialize_distributed (NCCL, world size
     1 on one card) and make_mesh; render_sharded on the dense and sparse
     frames, render_geo_sharded on the large, dense_shadows and
     sparse_shadows frames, each one CUDA graph with its collectives
     inside (a culled frame's chunk loop one WHILE node), its capture's
     replay, a second replay (under sync-debug mode "error") and its
     eager body each bit for bit phase 4's image (K1 2 + K2 4 + S 4; K1
     1 + K2 2 + S 2; K1 1 + K2 2 + K4 1 + S 2; the sparse frames phase 4's in the eager body,
     one loop body in the graph's nodes, its trip counter the hit chunks
     after each replay, a replay's kernels in phase 12);
     train_step_sharded on sparse_train with grad_chunks 1 (loss phase 5's
     bits, gradients within GRAD_TOL, K1 2 + K2 4 + K3 2) and 4 (within
     the same gates of 1, four times the launches), and on
     sparse_train_culled (loss phase 5's bits), graphed and eager; NCCL's
     set-up ms, capture ms, the
     sharded frames' and steps' ms graphed and eager beside the
     single-process ones, the gradient all-reduce's and the frame
     all-gather's ms.
     With two cards or more it also runs the same cases on 2 or 4 ranks
     with geo=2 (this script with --sharded-rank, one process a card)
 11. graphed: render_frame_jit on the dense, sparse, large,
     dense_shadows, sparse_shadows, refract, dense_onchip and dense_bf16
     frames (one capture each, freed before the next; the sparse frames'
     chunk loop one WHILE node of the graph), each bit for bit phase 4's
     eager image, and again at orbit(camera, 0.1, 0), bit for bit the
     eager frame there (inputs are copied in, not baked in), the replays
     under torch.cuda.set_sync_debug_mode("error"); the warm-up's and
     capture's launches (phase 4's twice, S included; a culled frame's
     warm-up shades its hit chunks, its capture one); the hand-written
     kernels counted from the graph's own kernel nodes
     (CUDAGraph.debug_dump: phase 4's launches, for a culled frame the
     primary walks and one loop body, a WHILE node's, no other
     conditional node, its trip counter the hit chunks after each
     replay) and by torch.profiler over a replay (phase 4's
     launches; a culled frame's in phase 12); train_step_jit on
     sparse_train, onchip_train and
     sparse_train_culled, TRAIN_STEPS steps beside as many eager
     train_steps from the same start (bit for bit the eager steps with the
     same capturable Adam; with the default Adam the first loss
     bit-equal, the rest within GRAPHED_STEP1_TOL / GRAPHED_PARAM_TOL /
     GRAPHED_LOSS_RTOL; K3 twice a replayed step, twice a shaded chunk;
     no S in a dense step, S in the culled step's forward loop alone;
     the culled step's two loops' trip counters the hit chunks);
     graphed and eager ms side by side (median of 5 after a warm-up),
     capture ms, graph-pool bytes and peak device memory; then the
     optimizer dropped and the step captured for a second one: the
     device memory reserved with each graph and after each drop (the
     graph goes with its optimizer: both drops leave the same bytes)
 12. culled replays: the seven culled graphs of phases 8, 10 and 11
     (render_frame_jit, render_sharded and render_geo_sharded on the
     sparse frames, train_step_jit and train_step_sharded on
     sparse_train_culled, trace_shade), each captured again in a fresh
     process of this script (--replay-kernels), all started together,
     and one replay of each traced by torch.profiler: its hand-written
     kernels the eager call's launches (the shaded chunks' bodies only;
     K3 twice a shaded chunk in the steps), from the trace and its
     loops' trip counters, the hit chunks
 13. shading kernels: the frames' shading (ops/shade_cuda.py,
     csrc/shade.cu) against the plain shading on the dense, dense_shadows,
     large_shadows, refract and dense_onchip frames, bit for bit, two
     launches a pass (counts set to 0 before each frame); the dense
     frame's primary and bounce passes timed, kernels against plain (CUDA
     events, the profiler's device time), and the kernels' bound: the
     kernel line's row S
 14. leaf pack kernel: the build's pack (ops/pack_cuda.py, csrc/pack.cu)
     on the benchmark's 1 048 576-triangle tetra1m scene, its tables bit
     for bit the plain pack's; the kernel's device ms, the plain tail +
     pack_tables' ms and kernels, and the byte bound: the kernel line's
     row P (P's launches, one a float32 frame's build and none in a step,
     are held in every phase's route checks)

Launch counts include phases 10's and 11's (not phase 12's, whose
processes count their own).  The Python launch counters count a graph's
capture (its eager warm-up, which shades the hit chunks, and one loop
body), not its replays: the CLIs of phases 6-8 replay graphs, so their
counts are the captures'.
The second-to-last line is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}, printed only when every phase passed.
Exits non-zero, printing no result, without a CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

W, H = 1920, 1080
MATCH_MIN = 0.9999  # image pixels within 1e-4 of the all-plain render
# K3 against the float64 sum of the same float32 inputs, per row: |error|
# over the row's largest |value| (csrc/scatter.cu bounds its fixed-point
# error; the float32 output's rounding alone is up to 6e-8)
K3_F64_TOL = 1e-6
# K3 against its plain float32 version, per row likewise, as every kernel
# here is held to its plain version (the plain version's own distance from
# the float64 sum is logged, not checked, so this is not implied by the
# check above): a float32 sum of up to ~2 M terms strays up to 4.5e-4
K3_PLAIN_TOL = 1e-3
# training gradients, kernels against all-plain: |diff| over each tensor's
# largest |grad| (above the float32 sums' 4.5e-4)
GRAD_TOL = 1e-3
TRAIN_STEPS = 3
SPARSE_CHUNK = 25600  # bench.py:76-77's ray_chunk, 81 chunks at 1080p
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# float32 operations of one node step of a walk: the slab test (6 sub,
# 6 mul, 10 min/max) and 4 compares; the Moeller-Trumbore test of the
# steps that reach a leaf's box (~54 more) is not counted, so the bound
# from it is a lower bound
OPS_PER_STEP = 26
# the dense frame aims at the sphere at (12.5, 0, 0): grid column 2, row 1,
# material (2 + 1) % 3 = 0, which the refract frame makes transparent with
# tests/test_refraction.py's values
GLASS_MATERIAL, GLASS_ALPHA, GLASS_DENSITY = 0, 0.4, 0.7


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> int:
    """Report a failed phase on standard output and on standard error
    (where a caller that keeps only the errors still sees the cause);
    returns the exit code 1."""
    log(f"FAILED: {msg}")
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def glass_scene(scene):
    """``scene`` with material GLASS_MATERIAL semi-transparent."""
    m = scene.materials
    alpha, density = m.alpha.clone(), m.optical_density.clone()
    alpha[GLASS_MATERIAL] = GLASS_ALPHA
    density[GLASS_MATERIAL] = GLASS_DENSITY
    return dataclasses.replace(scene, materials=dataclasses.replace(
        m, alpha=alpha, optical_density=density))


def frames_on(device):
    """name -> (scene, camera, cfg): the bench's 1080p configs
    (bench.py:76-77, :104-107, :122, :302, :522) on its procedural scenes,
    and dense_onchip, the small-scene on-chip configuration.

    Traversal backends as the bench names them: the dense, dense_shadows
    and refract frames name K1's ('cuda', the bench's 'hbm',
    bench.py:105); the sparse frames keep 'auto', which takes K5/K6 on the
    3 072-leaf tree, as the TPU's 'auto' took 'pallas'; the large frames'
    102 400 leaves resolve to K1/K4.  dense_onchip is the dense frame with
    shadows through K5/K6, K7 and K8 ('shared', 'shared', 'bitonic').
    dense_bf16 is the dense frame in bfloat16: its wrappers cast rays to
    float32 and gather the bfloat16 leaf table as float32.
    dense_bf16_onchip is dense_bf16 through K5, K7 and K8: the walk that
    'auto' takes on this scene, and K7 on the bfloat16 leaf table.

    The dense frames keep the bench's dense config but frame one sphere:
    its ortho_scale=256 was set for Image_Test.obj, and on the fallback
    sphere grid it looks into the gap between spheres (0% of rays hit:
    tests/test_torch_camera.py::test_dense_frame_window_on_sphere_grid).
    Aimed at the sphere at (12.5, 0, 0) with ortho_scale 27, ~71% hit."""
    from raytracebvh_tpu_torch import Camera, RenderConfig
    from raytracebvh_tpu_torch.models.procedural import sphere_grid

    base = RenderConfig(width=W, height=H, bounces=1)
    small = sphere_grid(nx=4, ny=3, subdiv=8, device=device)  # 3 072 tris
    large = sphere_grid(nx=4, ny=4, subdiv=40, device=device)  # 102 400 tris
    cam = Camera.default(device)
    aimed = cam.replace(eye=torch.tensor([12.5, 5.0, -100.0], device=device),
                        at=torch.tensor([12.5, 0.0, 0.0], device=device))
    dense = base.replace(ortho_scale=27.0, ray_chunk=0, ray_tile=16,
                         texture_dtype="uint8", traversal_backend="cuda")
    sparse = base.replace(ray_chunk=SPARSE_CHUNK)
    large_cfg = base.replace(bounces=0, ray_tile=16, ray_chunk=0)
    return {
        "dense": (small, aimed, dense),
        "sparse": (small, cam, sparse),
        "large": (large, cam, large_cfg),
        "dense_shadows": (small, aimed, dense.replace(
            bounces=0, enable_shadows=True)),
        "sparse_shadows": (small, cam, sparse.replace(
            bounces=0, enable_shadows=True)),
        "large_shadows": (large, cam, large_cfg.replace(enable_shadows=True)),
        "refract": (glass_scene(small), aimed, dense.replace(
            enable_refraction=True)),
        "dense_onchip": (small, aimed, onchip(dense.replace(
            enable_shadows=True))),
        "dense_bf16": (small, aimed, dense.replace(dtype="bfloat16")),
        "dense_bf16_onchip": (small, aimed, onchip(dense.replace(
            dtype="bfloat16"))),
    }


def onchip(cfg):
    """``cfg`` through the on-chip kernels: K5/K6, K7 and K8."""
    return cfg.replace(traversal_backend="shared",
                       shade_gather_backend="shared", sort_backend="bitonic")


def train_frames(frames):
    """name -> (scene, camera, cfg) of the training step at 1080p.
    sparse_train is bench.py:319-320's cfg_bwd (its traversal_backend
    'hbm' names the TPU's K1, the port's 'cuda') on the sparse frame's
    scene and camera; dense_train is the same config on the dense frame,
    aimed with ortho_scale=27 (frames_on says why); onchip_train is
    dense_train through the on-chip kernels K5, K7 and K8;
    sparse_train_culled is the step on the sparse frame itself
    (bench.py:76-77: ray_chunk=25600, culling on, default backends: one K5
    launch for every chunk's primary walk, then K5, K2 and K3 on the
    shaded chunks, in the chunk loop)."""
    small, cam, sparse = frames["sparse"]
    _, aimed, dense = frames["dense"]
    cfg_bwd = sparse.replace(ray_chunk=0, ray_tile=16, texture_dtype="uint8",
                             traversal_backend="cuda")
    check(dense == cfg_bwd.replace(ortho_scale=27.0),
          "dense_train is not cfg_bwd with ortho_scale=27")
    return {"sparse_train": (small, cam, cfg_bwd),
            "dense_train": (small, aimed, dense),
            "onchip_train": (small, aimed, onchip(dense)),
            "sparse_train_culled": (small, cam, sparse)}


def plain(cfg):
    """``cfg`` with every kernel replaced by plain PyTorch: the plain
    walks and gathers, and the reference's radix sort for the build."""
    return cfg.replace(traversal_backend="torch", shade_gather_backend="torch",
                       texture_gather_backend="torch", sort_backend="radix")


def value_and_grad(params, scene, cam, target, cfg):
    """loss_fn + backward(): the loss and the three gradients."""
    from raytracebvh_tpu_torch.models.inverse import loss_fn

    for p in params:
        p.grad = None
    loss = loss_fn(params, scene, cam, target, cfg)
    loss.backward()
    return loss.detach(), [p.grad for p in params]


def cuda_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn`` in ms over ``reps`` runs after one
    warm-up, from CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def back_to_back_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device ms a call of ``fn`` from CUDA events around ``calls`` calls
    queued back to back (the host runs ahead, so the card waits on no
    launch), the median of ``reps`` rounds after one warm-up call; for a
    call whose device time the profiler's records may leave out."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def wall_ms(fn, reps: int = 5) -> float:
    """Median host time of ``fn`` in ms (ended by a synchronize) over
    ``reps`` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the least time the card could take to move
    ``nbytes`` and do ``ops`` float32 operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


class Recorder:
    """Wraps a function of a module, keeping the arguments (and results)
    of every call: the inputs the main path really hands a kernel."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.inner = getattr(module, name)
        self.calls = []
        self.results = []

    def __call__(self, *args, **kw):
        self.calls.append((args, kw))
        out = self.inner(*args, **kw)
        self.results.append(out)
        return out

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)


def plain_walks_like_kernels():
    """The plain walks, for the block, with the kernels' float32 casts:
    the plain path of a bfloat16 frame given the same casts."""
    from raytracebvh_tpu_torch.ops import traverse as plain_ops
    from raytracebvh_tpu_torch.ops.traverse_cuda import float32_walk

    return mock.patch.multiple(
        plain_ops, traverse=float32_walk(plain_ops.traverse),
        traverse_any=float32_walk(plain_ops.traverse_any))


def capture(scene, cam, cfg):
    """One frame, recording the arguments of every kernel's wrapper and
    of the build's stable sort: name -> list of (args, kwargs)."""
    from contextlib import ExitStack

    from raytracebvh_tpu_torch import render_frame
    from raytracebvh_tpu_torch.ops import (gather_cols_cuda, gather_cuda,
                                           sort, sort_cuda, traverse_cuda,
                                           traverse_shared_cuda)

    wrappers = {"K1": (traverse_cuda, "traverse"),
                "K2": (gather_cuda, "gather_rows"),
                "K4": (traverse_cuda, "traverse_any"),
                "K5": (traverse_shared_cuda, "traverse"),
                "K6": (traverse_shared_cuda, "traverse_any"),
                "K7": (gather_cols_cuda, "gather_cols"),
                "K8": (sort_cuda, "bitonic_sort_by_code"),
                "sort": (sort, "sort_by_code")}
    with ExitStack() as stack:
        rec = {k: stack.enter_context(Recorder(*w)) for k, w in wrappers.items()}
        stack.enter_context(torch.inference_mode())
        render_frame(scene, cam, cfg)
    torch.cuda.synchronize()
    return {k: r.calls for k, r in rec.items()}


def lane_efficiency(steps):
    """(lane efficiency, warp-iterations) of one walk launch from its
    per-ray step counts in launch order, 32 rays a warp as K1/K4 take them:
    the node steps over 32 x the sum of each warp's longest walk, which
    counts the warp-iterations.  1 - efficiency bounds what a lane refill
    (a work queue) could win."""
    s = steps.to(torch.int64)
    warps = torch.nn.functional.pad(s, (0, (-s.numel()) % 32)).view(-1, 32)
    its = int(warps.max(1).values.sum())
    return float(s.sum()) / (32 * max(its, 1)), its


def walk_bound(rays, steps, tables, out_bytes_per_ray, in_bytes_per_ray):
    """Bound of one walk kernel launch: each ray's inputs read once, its
    outputs written once, the two tables read once; OPS_PER_STEP float32
    operations per node step the walk really took."""
    nrays = rays.origin.shape[0]
    nbytes = (nrays * (in_bytes_per_ray + out_bytes_per_ray)
              + sum(t.numel() * t.element_size() for t in tables))
    total_steps = int(steps.sum())
    ms, by = bound(nbytes, OPS_PER_STEP * total_steps)
    return ms, by, nbytes, total_steps


def phase_kernels(frames):
    from raytracebvh_tpu_torch.ops import gather_cuda, traverse_cuda
    from raytracebvh_tpu_torch.ops import traverse as plain
    from raytracebvh_tpu_torch.ops.shade import (pack_texture_quads,
                                                 quantize_quads_u8)

    result = {}
    scene_d, cam_d, cfg_d = frames["dense"]
    calls = capture(scene_d, cam_d, cfg_d)
    k1_calls, k2_calls = calls["K1"], calls["K2"]
    check(len(k1_calls) == 2 and len(k2_calls) == 4,
          f"dense frame made {len(k1_calls)} K1 and {len(k2_calls)} K2 calls")
    bvh_d, prim_rays, eps = k1_calls[0][0][:3]
    bvh_d = traverse_cuda.with_tables(bvh_d)
    bounce_rays = k1_calls[1][0][1]
    l_calls = capture(*frames["large"])["K1"]
    bvh_l, rays_l = l_calls[0][0][:2]
    log(f"  K1 large: {bvh_l.n_leaves} leaves")
    errs, steps = [], {}
    for what, bvh, rays in (("dense primary", bvh_d, prim_rays),
                            ("dense bounce launch", bvh_d, bounce_rays),
                            ("large primary", bvh_l, rays_l)):
        err, steps[what], _ = exact_walk(
            f"K1 {what}", traverse_cuda.traverse, plain.traverse, bvh, rays,
            eps)
        errs.append(err)
        ms = cuda_ms(lambda: traverse_cuda.traverse(bvh, rays, eps))
        dev_ms = walk_ms(lambda: traverse_cuda.traverse(bvh, rays, eps))
        log(f"  K1 time, {what}: {ms:.3f} ms, device {dev_ms:.4f} ms")
        if what == "dense primary":
            k1 = dict(ms=ms, device_ms=dev_ms)

    plain_ms = cuda_ms(lambda: plain.traverse(bvh_d, prim_rays, eps))
    b_ms, b_by, nbytes, nsteps = walk_bound(
        prim_rays, steps["dense primary"],
        (bvh_d.node_table, bvh_d.leaf_table), 9, 24)
    log(f"  K1 dense primary: plain {plain_ms:.3f} ms; bound {b_ms:.4f} ms "
        f"({nsteps} node steps, {nsteps / prim_rays.origin.shape[0]:.2f} a "
        f"ray, {nbytes} bytes, by {b_by}); no PyTorch call computes a "
        "traversal")
    result["K1"] = dict(max_abs_err=max(errs), plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=None, **k1)

    # K2: the frame's own indices into its own tables
    leaf_attrs, leaf_ids = k2_calls[0][0]
    quads_u8, texel_ids = k2_calls[1][0]
    quads_f32 = pack_texture_quads(scene_d.textures, scene_d.tex_hw)
    check(quads_u8.dtype == torch.uint8
          and torch.equal(quads_u8, quantize_quads_u8(quads_f32)),
          "the dense frame's quad table is not the u8 pack of its texture")
    k2 = {}
    for what, tbl, idx in (("leaf_attrs f32", leaf_attrs, leaf_ids),
                           ("quads f32", quads_f32, texel_ids),
                           ("quads u8", quads_u8, texel_ids)):
        got = gather_cuda.gather_rows(tbl, idx)
        want = gather_cuda.gather_rows_torch(tbl, idx)
        err = float((got - want).abs().max())
        check(torch.equal(got, want), f"K2 {what}: max |diff| {err}")
        t = cuda_ms(lambda: gather_cuda.gather_rows(tbl, idx))
        tp = cuda_ms(lambda: gather_cuda.gather_rows_torch(tbl, idx))
        # the library yardstick: torch.index_select of the same rows, [R, C]
        # row-major (K2 writes channel-major [C, R]); f32 tables only
        tl = tl_dev = None
        if tbl.dtype == torch.float32:
            tl = cuda_ms(lambda: torch.index_select(tbl, 0, idx))
            tl_dev = profiled(lambda: torch.index_select(tbl, 0, idx))[1]
        kernels, t_dev = profiled(lambda: gather_cuda.gather_rows(tbl, idx),
                                  expect=1)
        check(kernels == 1, f"K2 {what}: {kernels} CUDA kernels a call")
        nbytes = (tbl.numel() * tbl.element_size() + idx.numel() * 4
                  + idx.numel() * tbl.shape[1] * 4)
        ops = idx.numel() * tbl.shape[1] if tbl.dtype == torch.uint8 else 0
        b_ms, b_by = bound(nbytes, ops)
        log(f"  K2 {what} {tuple(tbl.shape)} x {idx.numel()} ids: exact; "
            f"{t:.3f} ms vs plain {tp:.3f} ms, index_select "
            f"{'-' if tl is None else f'{tl:.3f} ms'}; device time "
            f"{t_dev:.4f} ms, index_select "
            f"{'-' if tl_dev is None else f'{tl_dev:.4f} ms'}; bound "
            f"{b_ms:.4f} ms ({nbytes} bytes, by {b_by})")
        k2[what] = (err, t, tp, b_ms, b_by, tl, t_dev, tl_dev)
    _, t, tp, b_ms, b_by, tl, t_dev, tl_dev = k2["leaf_attrs f32"]
    result["K2"] = dict(max_abs_err=max(v[0] for v in k2.values()),
                        ms=t, plain_ms=tp, bound_ms=b_ms, bound_by=b_by,
                        library_ms=tl, device_ms=t_dev,
                        library_device_ms=tl_dev)

    # K4: every shadow ray of the dense shadow frame and of the large one
    k4_calls = capture(*frames["dense_shadows"])["K4"]
    check(len(k4_calls) == 1, f"dense_shadows made {len(k4_calls)} K4 calls")
    bvh_s, shadow_rays, eps, max_t = k4_calls[0][0][:4]
    bvh_s = traverse_cuda.with_tables(bvh_s)
    k4_large = capture(*frames["large_shadows"])["K4"]
    check(len(k4_large) == 1, f"large_shadows made {len(k4_large)} K4 calls")
    bvh_ls, rays_ls, _, max_t_ls = k4_large[0][0][:4]
    errs = []
    for what, bvh, rays, mt in (("dense shadows", bvh_s, shadow_rays, max_t),
                                ("large shadows", bvh_ls, rays_ls, max_t_ls)):
        err, st, occ = exact_walk(f"K4 {what}", traverse_cuda.traverse_any,
                                  plain.traverse_any, bvh, rays, eps, mt)
        errs.append(err)
        live = rays.origin[:, 0] < 1e29  # dead lanes start at 1e30
        share = float(occ[live].float().mean())
        check(0.0 < share < 1.0, f"K4 {what}: occluded share {share} of "
              f"{int(live.sum())} live rays")
        ms = cuda_ms(lambda: traverse_cuda.traverse_any(bvh, rays, eps, mt))
        dev_ms = walk_ms(lambda: traverse_cuda.traverse_any(bvh, rays, eps,
                                                            mt))
        log(f"  K4 time, {what}: {ms:.3f} ms, device {dev_ms:.4f} ms; "
            f"occluded share of {int(live.sum())} live rays {share:.4f}")
        if what == "dense shadows":
            k4, steps = dict(ms=ms, device_ms=dev_ms), st
    plain_ms = cuda_ms(lambda: plain.traverse_any(bvh_s, shadow_rays, eps,
                                                  max_t))
    b_ms, b_by, nbytes, nsteps = walk_bound(
        shadow_rays, steps, (bvh_s.node_table, bvh_s.leaf_table), 1, 28)
    log(f"  K4 dense shadows: plain {plain_ms:.3f} ms; bound {b_ms:.4f} ms "
        f"({nsteps} node steps, {nsteps / shadow_rays.origin.shape[0]:.2f} a "
        f"ray, {nbytes} bytes, by {b_by}); no PyTorch call computes a "
        "traversal")
    result["K4"] = dict(max_abs_err=max(errs), plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=None, **k4)
    return result


def exact_walk(name, kernel, plain_walk, bvh, rays, *args):
    """A walk kernel (K1, K4, K5 or K6) against the plain walk on the same
    rays: every record and step count equal, no ray cut by the step cap;
    logs the launch's lane efficiency.  Returns (max |got - want| over the
    outputs, the kernel's steps, its output)."""
    from raytracebvh_tpu_torch.ops import traverse_cuda

    traverse_cuda.reset_truncated()
    got, steps = kernel(bvh, rays, *args, return_steps=True)
    want, wsteps = plain_walk(bvh, rays, *args, return_steps=True)
    torch.cuda.synchronize()
    trunc = traverse_cuda.truncated_rays()
    if isinstance(got, torch.Tensor):  # any-hit: the occlusion flags
        pairs = [(got, want)]
        what = f"occluded share {float(want.float().mean()):.4f}"
    else:
        pairs = [(got.hit, want.hit), (got.leaf, want.leaf),
                 (got.distance, want.distance)]
        what = f"{int(want.hit.sum())} hits"
    nbad = sum(int((a != b).sum()) for a, b in pairs)
    nsteps = int((steps != wsteps).sum())
    err = max(float((a.double() - b.double()).abs().max()) for a, b in pairs)
    eff, its = lane_efficiency(steps)
    log(f"  {name}: {rays.origin.shape[0]} rays, {what}, {nbad} differing "
        f"outputs, {nsteps} differing step counts, truncated {trunc}; "
        f"{float(steps.float().mean()):.2f} steps a ray, lane efficiency "
        f"{eff:.4f} over {its} warp-iterations")
    check(nbad == 0 and nsteps == 0, f"{name}: {nbad} outputs and {nsteps} "
          "step counts differ from the plain walk")
    check(trunc == 0, f"{name}: {trunc} rays cut by the step cap")
    return err, steps, got


def cat_rays(calls):
    """The rays (and max_t, for any-hit calls) of several captured walk
    calls on one tree, as one batch."""
    from raytracebvh_tpu_torch.core.types import Rays

    rays = [c[0][1] for c in calls]
    out = Rays(torch.cat([r.origin for r in rays]).contiguous(),
               torch.cat([r.direction for r in rays]).contiguous())
    if len(calls[0][0]) > 3 and isinstance(calls[0][0][3], torch.Tensor):
        return out, torch.cat([c[0][3] for c in calls]).contiguous()
    return out, None


# the trees K5/K6 are held to K1/K4 on, besides the dense frame's 3 072
# leaves: sphere grids of 432 and 6 912 triangles (512 and 6 912 leaves)
# under the dense frame's aimed camera; all three have a sphere where the
# camera aims
WALK_TREES = {"512 leaves": (4, 3, 3), "6 912 leaves": (4, 3, 12)}
# K8 beyond the main path's codes: the edges of its routes (one block up
# to 16 384 codes, tiles and merges above), on three orderings
K8_EDGE_SIZES = (1, 2, 1023, 1024, 4097, 16384, 16385, 131073)


def kernel_durations(fn, reps: int):
    """(name, duration in us) of each CUDA kernel in a torch.profiler trace
    of ``reps`` calls of ``fn``, after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["dur"])) for e in events
            if e.get("cat") == "kernel"]


def profile_counts(fn, reps: int = 10, expect=None):
    """(name -> kernels of that name a call of ``fn`` runs, name -> their
    durations in us) from torch.profiler traces.  A trace now and then
    drops kernel records (once, more than half of K7's), and never adds
    one: while some name's records are not a multiple of ``reps``, or the
    count is not ``expect`` (a trace that dropped every record of one
    kernel name), the trace is taken again (five traces at most), and
    each name keeps its records from the trace that held the most of
    them.  It counts round(records / reps) launches
    a call: a dropped record does not change the count."""
    per = {}
    for _ in range(5):
        trace = {}
        for name, d in kernel_durations(fn, reps):
            trace.setdefault(name, []).append(d)
        for name, d in trace.items():
            if len(d) > len(per.get(name, ())):
                per[name] = d
        counts = {k: round(len(v) / reps) for k, v in per.items()}
        whole = per and all(len(d) % reps == 0 for d in per.values())
        if whole and expect in (None, sum(counts.values())):
            break
    if not per:
        raise SmokeFailure("five profiler traces held no kernel")
    return {k: round(len(v) / reps) for k, v in per.items()}, per


def profiled(fn, reps: int = 10, expect=None):
    """(CUDA kernels a call of ``fn`` runs, their device time a call in
    ms): the kernels alone, without the host time between launches that
    CUDA events around a call also count (a memset is not a kernel), from
    ``profile_counts``, each name's launches at its mean duration.
    Callers that know how many kernels a call runs pass ``expect`` and
    check the count."""
    counts, per = profile_counts(fn, reps, expect)
    return (sum(counts.values()),
            sum(n * float(np.mean(per[k])) for k, n in counts.items()) / 1e3)


def replay_routes(call, want, tries: int = 5):
    """(K -> calls, kernels in all, their device ms) of one replay of a
    graph (``call``) by torch.profiler, a trace a replay, the hand-written
    kernels held to ``want`` (or to any of a tuple of them); a trace that
    disagrees (one that dropped records) is logged and taken again,
    ``tries`` at most."""
    wants = want if isinstance(want, tuple) else (want,)
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    for t in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type.name == "CUDA"
                  and not e.key.startswith(("Memcpy", "Memset"))]
        seen = routes({e.key: e.count for e in events})
        total = sum(e.count for e in events)
        if seen in wants:
            return seen, total, sum(e.self_device_time_total
                                    for e in events) / 1e3
        log(f"    profiler trace {t}: {total} kernels, routes {seen}, not "
            f"{want}")
    raise SmokeFailure(f"no trace of {tries} saw a replay's kernels {want}")


def kernel_split(fn, reps: int = 10) -> dict:
    """name -> median device ms of each of the hand-written kernels
    (``..._kernel``) that a call of ``fn`` runs."""
    per = {}
    for name, d in kernel_durations(fn, reps):
        m = re.search(r"(\w+_kernel)\b", name)
        if m:
            per.setdefault(m.group(1), []).append(d)
    return {k: float(np.median(v)) / 1e3 for k, v in per.items()}


def walk_ms(fn, reps: int = 10) -> float:
    """The device time of the one walk kernel (K1, K4, K5 or K6) a call of
    ``fn`` runs, in ms: the median duration of the kernels named
    traverse... over ``reps`` calls (a median, so that a record the trace
    drops does not count as a fast call; the name, so that nothing but
    the walk counts)."""
    for _ in range(5):  # a trace now and then comes back without kernels
        durations = [d for name, d in kernel_durations(fn, reps)
                     if "traverse" in name]
        if durations:
            return float(np.median(durations)) / 1e3
    raise SmokeFailure("five profiler traces held no walk kernel")


def walk_pair(name, bvh, rays, eps, max_t=None):
    """K5 (or K6 where ``max_t`` is given) against the plain walk on
    ``rays``, then its time beside K1's (or K4's) on the same rays: CUDA
    events around the wrapper, and the kernel's device time.  Returns
    (max |err|, steps, ms, K1/K4 ms, device ms, K1/K4 device ms)."""
    from raytracebvh_tpu_torch.ops import traverse as plain
    from raytracebvh_tpu_torch.ops import traverse_cuda, traverse_shared_cuda

    bvh = traverse_cuda.with_tables(bvh)
    if max_t is None:
        kernel, ref, plain_walk = (traverse_shared_cuda.traverse,
                                   traverse_cuda.traverse, plain.traverse)
        args, k = (eps,), "K5"
    else:
        kernel, ref, plain_walk = (traverse_shared_cuda.traverse_any,
                                   traverse_cuda.traverse_any,
                                   plain.traverse_any)
        args, k = (eps, max_t), "K6"
    err, steps, _ = exact_walk(f"{k} {name}", kernel, plain_walk, bvh, rays,
                               *args)
    ms = cuda_ms(lambda: kernel(bvh, rays, *args))
    ref_ms = cuda_ms(lambda: ref(bvh, rays, *args))
    dev_ms = walk_ms(lambda: kernel(bvh, rays, *args))
    ref_dev_ms = walk_ms(lambda: ref(bvh, rays, *args))
    log(f"  {k} time, {name} ({rays.origin.shape[0]} rays, {bvh.n_leaves} "
        f"leaves, {walk_design(bvh, rays)}): {ms:.4f} ms vs "
        f"{'K1' if k == 'K5' else 'K4'} on the same rays {ref_ms:.4f} ms "
        f"({ms / ref_ms:.3f}x); device time {dev_ms:.4f} ms vs "
        f"{ref_dev_ms:.4f} ms ({dev_ms / ref_dev_ms:.3f}x)")
    return err, steps, ms, ref_ms, dev_ms, ref_dev_ms


def walk_design(bvh, rays):
    """What K5/K6 stage and how they share ``rays`` out."""
    from raytracebvh_tpu_torch.ops import traverse_shared_cuda as tsc

    dev = rays.origin.device
    first = tsc.staged_first(bvh.n_leaves, tsc.smem_per_block(dev))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nrays = rays.origin.shape[0]
    grid = tsc.launch_geometry(nrays, sms)
    one_round = -(-nrays // 32) <= grid * tsc.BLOCK // 32
    return (f"{'every node record' if first == 0 else 'the internal nodes'}"
            f" staged, grid {grid} x {tsc.BLOCK}, "
            + ("one round of 32-ray batches" if one_round else "work queue"))


def phase_onchip_kernels(frames):
    """K5, K6, K7 and K8 against their plain versions on the main path's
    inputs; their times, bounds and yardsticks."""
    from raytracebvh_tpu_torch.core.types import Rays
    from raytracebvh_tpu_torch.models.procedural import sphere_grid
    from raytracebvh_tpu_torch.ops import (gather_cols_cuda, gather_cuda,
                                           traverse_cuda, traverse_shared_cuda)
    from raytracebvh_tpu_torch.ops import traverse as plain

    result = {}
    # K5/K6 beside K1/K4 on the same rays: the dense frame's primary and
    # shadow rays, a sparse chunk, sparse_shadows' rays, and the dense
    # frame's rays on two more trees
    bvh_d, prim_rays, eps = capture(*frames["dense"])["K1"][0][0][:3]
    bvh_d = traverse_cuda.with_tables(bvh_d)
    sparse = capture(*frames["sparse"])
    check(len(sparse["K5"]) > 0 and not sparse["K1"],
          f"sparse frame made {len(sparse['K5'])} K5, {len(sparse['K1'])} "
          "K1 calls")
    calls = sparse["K5"][len(sparse["K5"]) // 2:] + sparse["K5"]
    hit_chunk = next((c for c in calls
                      if bool(plain.traverse(*c[0][:3]).hit.any())), None)
    check(hit_chunk is not None, "no sparse chunk hits")
    bvh_s, chunk_rays = hit_chunk[0][:2]
    ss = capture(*frames["sparse_shadows"])
    check(len(ss["K6"]) > 0 and not ss["K4"],
          f"sparse_shadows made {len(ss['K6'])} K6, {len(ss['K4'])} K4 calls")
    bvh_ss = traverse_cuda.with_tables(ss["K6"][0][0][0])
    rays_ss, max_t_ss = cat_rays(ss["K6"])
    bvh_ds, shadow_rays, eps, max_t = capture(
        *frames["dense_shadows"])["K4"][0][0][:4]

    err5, steps5, ms5, k1_ms, dev5, dev1 = walk_pair(
        "dense primary", bvh_d, prim_rays, eps)
    err6, steps6, ms6, k4_ms, dev6, dev4 = walk_pair(
        "dense shadows", bvh_ds, shadow_rays, eps, max_t)
    errs5, errs6 = [err5], [err6]
    errs5.append(walk_pair("sparse chunk", bvh_s, chunk_rays, eps)[0])
    err, steps_ss, ms_ss, k4_ms_ss, dev_ss, dev4_ss = walk_pair(
        f"sparse_shadows ({len(ss['K6'])} chunks in one launch)", bvh_ss,
        rays_ss, eps, max_t_ss)
    errs6.append(err)
    scene_d, aimed, cfg_d = frames["dense_shadows"]
    for what, (nx, ny, subdiv) in WALK_TREES.items():
        scene = sphere_grid(nx=nx, ny=ny, subdiv=subdiv, device=scene_d.device)
        c = capture(scene, aimed, cfg_d)
        bvh_t, rays_t, eps_t = c["K1"][0][0][:3]
        check(f"{bvh_t.n_leaves:,}".replace(",", " ") in what,
              f"{what}: the tree has {bvh_t.n_leaves} leaves")
        errs5.append(walk_pair(f"dense primary, {what}", bvh_t, rays_t,
                               eps_t)[0])
        bvh_t, rays_t, eps_t, max_t_t = c["K4"][0][0][:4]
        errs6.append(walk_pair(f"dense shadows, {what}", bvh_t, rays_t,
                               eps_t, max_t_t)[0])
    # the staging alone: rays that miss the root (dead rays, one step each)
    for nrays in (prim_rays.origin.shape[0], chunk_rays.origin.shape[0]):
        dead = Rays(torch.full((nrays, 3), 1.0e30, device=prim_rays.origin.device),
                    prim_rays.direction[:nrays].contiguous())
        t5 = walk_ms(lambda: traverse_shared_cuda.traverse(bvh_d, dead, eps))
        t1 = walk_ms(lambda: traverse_cuda.traverse(bvh_d, dead, eps))
        log(f"  K5 staging alone, {nrays} rays that miss the root, "
            f"{bvh_d.n_leaves} leaves ({walk_design(bvh_d, dead)}): device "
            f"time {t5:.4f} ms vs K1 {t1:.4f} ms")

    plain_ms = cuda_ms(lambda: plain.traverse(bvh_d, prim_rays, eps))
    b_ms, b_by, nbytes, nsteps = walk_bound(
        prim_rays, steps5, (bvh_d.node_table, bvh_d.leaf_table), 9, 24)
    log(f"  K5 dense primary: plain {plain_ms:.3f} ms; bound {b_ms:.4f} ms "
        f"({nsteps} node steps, {nbytes} bytes, by {b_by}); no PyTorch call "
        "computes a traversal")
    result["K5"] = dict(max_abs_err=max(errs5), ms=ms5, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=None,
                        k1_k4_same_rays_ms=k1_ms, device_ms=dev5,
                        k1_k4_same_rays_device_ms=dev1)
    bvh_ds = traverse_cuda.with_tables(bvh_ds)
    plain_ms = cuda_ms(lambda: plain.traverse_any(bvh_ds, shadow_rays, eps,
                                                  max_t))
    b_ms, b_by, nbytes, nsteps = walk_bound(
        shadow_rays, steps6, (bvh_ds.node_table, bvh_ds.leaf_table), 1, 28)
    b_ss, by_ss, nbytes_ss, nsteps_ss = walk_bound(
        rays_ss, steps_ss, (bvh_ss.node_table, bvh_ss.leaf_table), 1, 28)
    log(f"  K6 dense shadows: plain {plain_ms:.3f} ms; bound {b_ms:.4f} ms "
        f"({nsteps} node steps, {nbytes} bytes, by {b_by}); sparse_shadows "
        f"bound {b_ss:.4f} ms ({nsteps_ss} node steps, {nbytes_ss} bytes, by "
        f"{by_ss})")
    result["K6"] = dict(max_abs_err=max(errs6), ms=ms6, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=None,
                        k1_k4_same_rays_ms=k4_ms, device_ms=dev6,
                        k1_k4_same_rays_device_ms=dev4,
                        sparse_shadows_ms=ms_ss, sparse_shadows_k4_ms=k4_ms_ss,
                        sparse_shadows_device_ms=dev_ss,
                        sparse_shadows_k4_device_ms=dev4_ss,
                        sparse_shadows_bound_ms=b_ss)

    # K7 and K8: dense_onchip's leaf table, leaf ids and codes
    on = capture(*frames["dense_onchip"])
    check(len(on["K7"]) == 2 and len(on["K8"]) == 1 and not on["sort"],
          f"dense_onchip made {len(on['K7'])} K7, {len(on['K8'])} K8 and "
          f"{len(on['sort'])} stable-sort calls")
    tbl, idx = on["K7"][0][0]
    got = gather_cols_cuda.gather_cols(tbl, idx)
    want = gather_cols_cuda.gather_cols_torch(tbl, idx)
    err7 = float((got - want).abs().max())
    check(torch.equal(got, want), f"K7 forward: max |diff| {err7}")
    # backward: K3 through K7 against K3 through K2 on the row-major table
    gen = torch.Generator(device="cpu").manual_seed(7)
    g = torch.randn(tuple(got.shape), generator=gen).to(tbl.device)
    # normal tensors: the captured ones were made under inference_mode
    a = tbl.clone().requires_grad_()
    b = tbl.t().contiguous().requires_grad_()
    ids = idx.clone()
    k3 = gather_cuda.scatter_launches
    gather_cols_cuda.gather_cols(a, ids).backward(g)
    gather_cuda.gather_rows(b, ids).backward(g)
    torch.cuda.synchronize()
    check(gather_cuda.scatter_launches == k3 + 2, "K7's backward is not K3")
    check(torch.equal(a.grad, b.grad.t()),
          "K7's backward differs from K2's (K3 on the same g and ids)")
    ms = cuda_ms(lambda: gather_cols_cuda.gather_cols(tbl, idx))
    plain_ms = cuda_ms(lambda: gather_cols_cuda.gather_cols_torch(tbl, idx))
    lib_ms = cuda_ms(lambda: tbl.index_select(1, idx))
    kernels, dev_ms = profiled(
        lambda: gather_cols_cuda.gather_cols(tbl, idx), expect=1)
    check(kernels == 1, f"K7: {kernels} CUDA kernels a call")
    lib_dev_ms = profiled(lambda: tbl.index_select(1, idx))[1]
    # diagnostic: K2 on the row-major copy of the same table, the same ids
    rows_tbl = tbl.t().contiguous()
    k2_ms = cuda_ms(lambda: gather_cuda.gather_rows(rows_tbl, idx))
    kernels, k2_dev_ms = profiled(
        lambda: gather_cuda.gather_rows(rows_tbl, idx), expect=1)
    check(kernels == 1, f"K2 on K7's table: {kernels} CUDA kernels a call")
    nbytes = tbl.numel() * 4 + idx.numel() * 4 + got.numel() * 4
    b_ms, b_by = bound(nbytes, 0)
    log(f"  K7 {tuple(tbl.shape)} x {idx.numel()} ids: exact, its backward "
        f"is K3 and equals K2's bit for bit; {ms:.3f} ms vs plain "
        f"{plain_ms:.3f} ms, index_select(1, ids) {lib_ms:.3f} ms "
        f"({ms / lib_ms:.3f}x); device time {dev_ms:.4f} ms, "
        f"index_select(1, ids) {lib_dev_ms:.4f} ms ({dev_ms / lib_dev_ms:.3f}x)"
        f"; K2 on the row-major copy {k2_ms:.3f} ms, device {k2_dev_ms:.4f} "
        f"ms (K7 {dev_ms / k2_dev_ms:.3f}x); bound {b_ms:.4f} ms "
        f"({nbytes} bytes, by {b_by})")
    result["K7"] = dict(max_abs_err=err7, ms=ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                        device_ms=dev_ms, library_device_ms=lib_dev_ms,
                        k2_row_major_ms=k2_ms,
                        k2_row_major_device_ms=k2_dev_ms)

    (codes_d,), _ = on["K8"][0]
    large = capture(*frames["large"])
    check(len(large["sort"]) == 1 and not large["K8"],
          "the large frame did not sort once with the stable sort")
    (codes_l,), _ = large["sort"][0]
    result["K8"] = phase_k8(codes_d, codes_l)
    return result


def k8_exact(what, codes):
    """K8 against torch.sort(stable=True) and its plain network: every
    output equal."""
    from raytracebvh_tpu_torch.ops import sort_cuda

    n = codes.shape[0]
    got_c, got_o = sort_cuda.bitonic_sort_by_code(codes)
    want_c, want_o = torch.sort(codes, stable=True)
    plain_c, plain_o = sort_cuda.bitonic_network_torch(*sort_cuda._padded(codes))
    nbad = int((got_c != want_c).sum() + (got_o.long() != want_o).sum())
    check(nbad == 0, f"K8 {what}: {nbad} outputs differ from torch.sort")
    check(torch.equal(got_c, plain_c[:n]) and torch.equal(got_o, plain_o[:n]),
          f"K8 {what}: differs from its plain network")


def phase_k8(codes_d, codes_l):
    """K8 on the dense and large frames' codes and at the edges of its
    routes: exact against torch.sort(stable=True) and its plain network;
    the kernels a call runs (torch.profiler); its time with the wrapper
    (CUDA events) and as the kernels alone (device time), beside
    torch.sort's."""
    from raytracebvh_tpu_torch.ops import sort_cuda

    dev = codes_d.device
    for n in K8_EDGE_SIZES:
        inputs = {"equal": torch.full((n,), 7, dtype=torch.int32, device=dev),
                  "sorted": torch.arange(n, dtype=torch.int32, device=dev),
                  "reversed": torch.arange(n, 0, -1, dtype=torch.int32,
                                           device=dev)}
        for what, codes in inputs.items():
            k8_exact(f"{n} {what} codes", codes)
        log(f"  K8 {n} codes, all equal, sorted and reversed: equal to "
            f"torch.sort(stable=True) and the plain network")
    k8 = {}
    for what, codes in (("dense", codes_d), ("large", codes_l)):
        k8_exact(what, codes)
        n = codes.shape[0]
        kernels, kernel_ms = profiled(
            lambda: sort_cuda.bitonic_sort_by_code(codes), 10,
            expect=sort_cuda.launches_per_call(n))
        check(kernels == sort_cuda.launches_per_call(n),
              f"K8 {what}: {kernels} CUDA kernels a call, not "
              f"{sort_cuda.launches_per_call(n)}")
        if n <= sort_cuda.SMALL_MAX:
            check(kernels == 1, f"K8 {what}: {kernels} kernels a call")
        ms = cuda_ms(lambda: sort_cuda.bitonic_sort_by_code(codes))
        lib_kernels, lib_kernel_ms = profiled(
            lambda: torch.sort(codes, stable=True), 10)
        keys, ids = sort_cuda._padded(codes)
        plain_ms = cuda_ms(lambda: sort_cuda.bitonic_network_torch(keys, ids))
        lib_ms = cuda_ms(lambda: torch.sort(codes, stable=True))
        # the bound whatever the algorithm: n codes read, n codes and n
        # indices written, or n * ceil(log2 n) compares
        nbytes = 12 * n
        compares = n * max(1, (n - 1).bit_length())
        b_ms, b_by = bound(nbytes, compares)
        route = ("one block" if n <= sort_cuda.SMALL_MAX
                 else f"{-(-n // sort_cuda.TILE)} tiles + merges")
        log(f"  K8 {what}: {n} codes ({route}), {kernels:g} CUDA kernel(s) a "
            f"call (torch.profiler), {int((codes == codes.max()).sum())} "
            f"sentinel or top codes: equal to torch.sort(stable=True) and the "
            f"plain network; {ms:.4f} ms with the wrapper, {kernel_ms:.4f} ms "
            f"the kernels alone (device time), torch.sort {lib_ms:.4f} ms "
            f"({ms / lib_ms:.3f}x; its {lib_kernels:g} kernels alone "
            f"{lib_kernel_ms:.4f} ms), plain {plain_ms:.3f} ms; bound "
            f"{b_ms:.6f} ms ({nbytes} bytes, {compares} compares, by {b_by})")
        k8[what] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                        kernel_ms=kernel_ms, kernels_a_call=kernels,
                        library_kernel_ms=lib_kernel_ms)
    out = k8["dense"]
    out.update(large_ms=k8["large"]["ms"],
               large_kernel_ms=k8["large"]["kernel_ms"],
               large_library_ms=k8["large"]["library_ms"],
               large_bound_ms=k8["large"]["bound_ms"],
               large_kernels_a_call=k8["large"]["kernels_a_call"])
    return out


def phase_topology(frames):
    """The build's topology (ops.bvh.build_topology, the range-min emit
    karras_children_rmq) on the dense and large frames' sorted codes:
    bit for bit the search karras_children, its parity oracle; the
    kernels a call of each, counted exactly as the kernel nodes of a CUDA
    graph of one call (a torch.profiler trace now and then drops records:
    profile_frames.py's trace of the graphed large frame held 825 of its
    985), and a replay's time (CUDA events), beside the eager call's (host
    clock)."""
    from raytracebvh_tpu_torch import graphs
    from raytracebvh_tpu_torch.ops import bvh as bvh_ops
    from raytracebvh_tpu_torch.pipeline import build_bvh, build_transforms

    stream = torch.cuda.Stream()
    rows = {}
    for name in ("dense", "large"):
        scene, cam, cfg = frames[name]
        with torch.no_grad():
            codes = build_bvh(scene, *build_transforms(cam, cfg)[1:],
                              cfg).codes
        rmq = bvh_ops.karras_children_rmq(codes)
        search = bvh_ops.karras_children(codes)
        same = all(torch.equal(a, b) for a, b in zip(rmq, search))
        check(same, f"topology {name}: the rmq emit differs from the search")
        row = dict(leaves=codes.shape[0])
        for how, emit in (("rmq", bvh_ops.karras_children_rmq),
                          ("search", bvh_ops.karras_children)):
            with mock.patch.object(bvh_ops, "karras_children_rmq", emit):
                call = lambda: bvh_ops.build_topology(codes)  # noqa: E731
                graph = graphs.Captured(call, (), stream, debug=True)
                _, nodes, _, _ = dump_routes(graph.graph)
                got = graph()
                check(all(torch.equal(a, b) for a, b in zip(got, call())),
                      f"topology {name} {how}: a replay differs")
                row[how] = dict(kernels=nodes, replay_ms=cuda_ms(graph),
                                eager_ms=wall_ms(call))
            del graph
        rows[name] = row
        log(f"  topology {name}: {codes.shape[0]} sorted codes, "
            f"karras_children_rmq bit for bit karras_children; "
            f"build_topology " + "; ".join(
                f"with the {how} {r['kernels']} kernel nodes in a graph of a "
                f"call, {r['replay_ms']:.4f} ms a replay (CUDA events), "
                f"{r['eager_ms']:.3f} ms eager (host clock)"
                for how, r in ((h, row[h]) for h in ("rmq", "search"))))
    log("  topology rows: " + json.dumps(rows))
    return rows


def row_rel_err(got, want):
    """max over rows of max |got - want| / max |want| (rows of want all 0
    count their largest |got|)."""
    err = (got.double() - want.double()).abs().amax(1)
    scale = want.double().abs().amax(1)
    return float(torch.where(scale > 0, err / scale.clamp(min=1e-300),
                             err).max())


def k3_blocks(idx, rows):
    """Distinct rows of each of K3's blocks, whose rays a block and row
    budget (a block of more rows reads its g again) the kernel library
    gives: (mean, max, blocks over the budget, blocks, budget)."""
    import ctypes

    from raytracebvh_tpu_torch import _kernels

    block, budget = ctypes.c_int(), ctypes.c_int()
    _kernels.check(_kernels.load().rtbvh_scatter_blocking(
        ctypes.addressof(block), ctypes.addressof(budget)), "K3 blocking")
    ids = torch.cat([idx, idx.new_full((-idx.numel() % block.value,), -1)])
    ids = ids.view(-1, block.value).long()
    srt = torch.where((ids >= 0) & (ids < rows), ids, -1).sort(1).values
    new = torch.ones_like(srt, dtype=torch.bool)
    new[:, 1:] = srt[:, 1:] != srt[:, :-1]
    distinct = (new & (srt >= 0)).sum(1)
    return (float(distinct.float().mean()), int(distinct.max()),
            int((distinct > budget.value).sum()), distinct.numel(),
            budget.value)


def k3_case(what, g, idx, rows):
    """K3 on one call's (g, idx): against the float64 sum, its plain
    version and its own second launch; its time with the wrapper (CUDA
    events) and its kernels' device time, beside index_add_'s."""
    from raytracebvh_tpu_torch.ops import gather_cuda

    valid = (idx >= 0) & (idx < rows)
    ref = torch.zeros((rows, g.shape[0]), dtype=torch.float64,
                      device=g.device).index_add_(
        0, idx[valid].long(), g.t()[valid].double())
    got = gather_cuda.scatter_add_rows(g, idx, rows)
    again = gather_cuda.scatter_add_rows(g, idx, rows)
    flat = gather_cuda.scatter_add_rows_torch(g, idx, rows)
    torch.cuda.synchronize()
    nbits = int((got.view(torch.int32) != again.view(torch.int32)).sum())
    rel = row_rel_err(got, ref)
    rel_plain = row_rel_err(flat, ref)
    rel_vs_plain = row_rel_err(got, flat)
    err = float((got - flat).abs().max())
    nrows = int(torch.unique(idx[valid]).numel())
    zero = int((g.abs().amax(0) == 0).sum())
    mean, most, over, blocks, budget = k3_blocks(idx, rows)
    log(f"  K3 {what}: g {tuple(g.shape)}, {idx.numel()} ids into {rows} "
        f"rows ({nrows} distinct, {zero} all-zero columns; a block's rows: "
        f"mean {mean:.2f}, max {most}, {over} of {blocks} blocks over "
        f"{budget}); against the float64 sum, per row: K3 {rel:.3g}, "
        f"plain float32 {rel_plain:.3g}; K3 against plain {rel_vs_plain:.3g} "
        f"(max |diff| {err:.3g}); two launches differ in {nbits} cells")
    check(bool(torch.isfinite(got).all()), f"K3 {what}: non-finite")
    check(nbits == 0, f"K3 {what}: {nbits} cells differ between launches")
    check(rel <= K3_F64_TOL, f"K3 {what}: {rel} from the float64 sum")
    check(rel_vs_plain <= K3_PLAIN_TOL,
          f"K3 {what}: {rel_vs_plain} from its plain version")

    def library():
        return torch.zeros((rows, g.shape[0]), device=g.device).index_add_(
            0, idx, g.t())

    ms = cuda_ms(lambda: gather_cuda.scatter_add_rows(g, idx, rows))
    kernels, dev_ms = profiled(lambda: gather_cuda.scatter_add_rows(g, idx,
                                                                    rows),
                               expect=3)
    check(kernels == 3, f"K3 {what}: {kernels} CUDA kernels a call, not 3")
    split = kernel_split(lambda: gather_cuda.scatter_add_rows(g, idx, rows))
    plain_ms = cuda_ms(lambda: gather_cuda.scatter_add_rows_torch(g, idx,
                                                                  rows))
    lib_ms = cuda_ms(library)
    lib_dev_ms = profiled(library)[1]
    nbytes = g.numel() * 4 + idx.numel() * 4 + rows * g.shape[0] * 4
    b_ms, b_by = bound(nbytes, g.numel())
    log(f"  K3 time, {what}: {ms:.3f} ms vs plain {plain_ms:.3f} ms, "
        f"index_add_ {lib_ms:.3f} ms ({ms / lib_ms:.3f}x); device time "
        f"{dev_ms:.4f} ms in {kernels:g} CUDA kernels a call (and a memset: "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items()) + "), "
        f"index_add_ {lib_dev_ms:.4f} ms ({dev_ms / lib_dev_ms:.3f}x); bound "
        f"{b_ms:.4f} ms ({nbytes} bytes, by {b_by}; {dev_ms / b_ms:.2f}x)")
    return dict(max_abs_err=err,
                max_abs_err_f64=float((got.double() - ref).abs().max()),
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, device_ms=dev_ms,
                library_device_ms=lib_dev_ms, kernels_a_call=kernels)


def phase_k3(train):
    """K3 on the (g, idx) that the training steps' backward hands it:
    dense_train's two calls (K2's backward) and onchip_train's (K7's), each
    2 073 600 ids into the 3 072-row leaf-attribute table, and the first
    of sparse_train_culled's (a shaded chunk's primary pass, 25 600 ids,
    in the chunk loop's backward)."""
    from raytracebvh_tpu_torch.models.inverse import init_params
    from raytracebvh_tpu_torch.ops import gather_cuda

    cases = {}
    for name in ("dense_train", "onchip_train", "sparse_train_culled"):
        scene, cam, cfg = train[name]
        target = torch.zeros((H, W, 4), device=scene.device)
        with Recorder(gather_cuda, "scatter_add_rows") as k3:
            value_and_grad(init_params(scene), scene, cam, target, cfg)
        torch.cuda.synchronize()
        calls = k3.calls
        if name in CHUNK_BODY:  # two a shaded chunk
            check(len(calls) > 0 and len(calls) % 2 == 0,
                  f"the {name} step made {len(calls)} K3 calls")
            calls = calls[:1]
        else:
            check(len(calls) == 2,
                  f"the {name} step made {len(calls)} K3 calls")
        for n, ((g, idx, rows), _) in enumerate(calls, 1):
            cases[f"{name} call {n}"] = k3_case(f"{name} call {n}", g, idx,
                                                rows)
    out = dict(cases["dense_train call 2"])
    out.update(max_abs_err=max(c["max_abs_err"] for c in cases.values()),
               max_abs_err_f64=max(c["max_abs_err_f64"]
                                   for c in cases.values()),
               calls={k: {f: c[f] for f in ("ms", "device_ms", "library_ms",
                                            "library_device_ms")}
                      for k, c in cases.items()})
    return out


def hit_mask(img, cfg):
    bg = torch.tensor(cfg.background, device=img.device)
    return ~(img - bg).abs().lt(1e-6).all(-1)


def render_counted(name, scene, cam, cfg):
    """One frame with every launch count set to 0 just before it; the
    image, the counts read just after, and the refraction weights of the
    primary pass."""
    from raytracebvh_tpu_torch import pipeline, render_frame

    with Recorder(pipeline, "_launch_soa") as launch, torch.inference_mode():
        reset_counts()
        img = render_frame(scene, cam, cfg)
        torch.cuda.synchronize()
        counts = read_counts()
    refr = [out[4] for out in launch.results]
    return img, counts, refr


# K1-K8, S, the frames' shading (ops/shade_cuda.py: two kernels a pass),
# and P, the build's leaf pack (ops/pack_cuda.py: one a build that needs
# no gradient, in float32)
KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "S", "P")
# the configs whose walks are K5/K6 (a 3 072-leaf tree through 'auto' or
# 'shared'), and those that also gather with K7 and sort with K8
ONCHIP_WALKS = ("sparse", "sparse_shadows", "dense_onchip",
                "dense_bf16_onchip", "onchip_train", "sparse_train_culled")
# the culled chunk loop's kernels: one K5 launch for every chunk's primary
# walk (pipeline.trace_chunks) and a body a shaded chunk; a step's body is
# its forward's trip and its backward's (pipeline._ChunkMap: the chunk's
# forward recomputed and its VJP).  S, two a shading pass, in the frames'
# bodies and the step's forward trip (grad mode off); the VJP's recompute
# needs gradients and shades on the plain path
CHUNK_BODY = {"sparse": dict(K5=1, K2=4, S=4),
              "sparse_shadows": dict(K6=1, K2=2, S=2),
              "sparse_train_culled": dict(K5=2, K2=8, K3=2, S=4)}


def culled_routes(name, shaded, builds=None):
    """K -> launches of the culled config ``name`` of whose chunks
    ``shaded`` are shaded, with ``builds`` P launches (None: a frame's
    build, 1, a step's, 0; a call that shades a built tree, 0)."""
    want = dict.fromkeys(KERNELS, 0)
    want["K5"] = 1
    want["P"] = (0 if CHUNK_BODY[name].get("K3") else 1) if builds is None \
        else builds
    for k, v in CHUNK_BODY[name].items():
        want[k] += shaded * v
    return want


def loop_trips(name, want):
    """The trip counters that a replay of the culled config ``name`` whose
    call launches ``want`` leaves: its shaded chunks, once for each loop
    (a step's forward and backward)."""
    shaded = want["K2"] // CHUNK_BODY[name]["K2"]
    return [shaded] * (2 if CHUNK_BODY[name].get("K3") else 1)


def check_trips(what, captured, name, want):
    """The trip counters of ``captured`` (a graphs.Captured) after a
    replay, held to ``loop_trips``: a device witness of the trips that
    ran, which needs no profiler.  Returns them."""
    trips = [int(t) for t in captured.trips]
    check(trips == loop_trips(name, want),
          f"{what}: trip counters {trips}, not {loop_trips(name, want)}")
    return trips


def culled_replay_routes(call, captured, name, want, tries=5):
    """(K -> launches, trip counters, kernel records) of one replay of the
    graph of the culled config ``name`` (``call``; ``captured`` its
    graphs.Captured), whose eager call launches ``want``.  torch.profiler
    records a WHILE node's body either at every trip or once a replay
    however many trips run, the latter for a graph captured before the
    process's first profiler trace (CUPTI; PERF.md §6): the
    trace (``replay_routes``) is held to ``want`` or to the graph's kernel
    nodes (a body once for each loop that ran), and the loops' trip
    counters (``check_trips``, a device witness read after the traced
    replay) give the trips; the launches, the trace's and, where it held
    one trip a loop, the further trips' bodies, are held to ``want``."""
    shaded = want["K2"] // CHUNK_BODY[name]["K2"]
    once = culled_routes(name, min(shaded, 1), want["P"])
    seen, total, _ = replay_routes(call, (want, once), tries)
    trips = check_trips(name, captured, name, want)
    ran = seen
    if seen != want:
        ran = {k: seen[k] + (shaded - 1) * CHUNK_BODY[name].get(k, 0)
               for k in KERNELS}
    check(ran == want, f"{name}: a replay ran {ran}, not {want}")
    return ran, trips, total


def capture_routes(name, want, in_graph):
    """K -> launches of a capture of the case ``name`` whose call launches
    ``want``: its eager warm-up's (which shades at least one chunk of a
    culled loop) and the graph's, ``in_graph``."""
    warm = want
    if name in CHUNK_BODY:
        warm = culled_routes(name, max(
            want["K2"] // CHUNK_BODY[name]["K2"], 1), want["P"])
    return {k: warm[k] + in_graph[k] for k in KERNELS}


def shaded_chunks(name, n, nchunks):
    """The shaded chunks that the launch counts ``n`` of the culled config
    ``name`` show; fails unless ``n`` is ``culled_routes`` of them."""
    shaded = n["K2"] // CHUNK_BODY[name]["K2"]
    want = culled_routes(name, shaded)
    check(n == want and 0 < shaded < nchunks,
          f"{name}: launches {n}, not {shaded} shaded of {nchunks} chunks' "
          f"{want}")
    return shaded
ONCHIP_ALL = ("dense_onchip", "dense_bf16_onchip", "onchip_train")


def reset_counts():
    from raytracebvh_tpu_torch.ops import (gather_cols_cuda, gather_cuda,
                                           pack_cuda, shade_cuda, sort_cuda,
                                           traverse_cuda, traverse_shared_cuda)

    traverse_cuda.launches = traverse_cuda.any_launches = 0
    gather_cuda.launches = gather_cuda.scatter_launches = 0
    traverse_shared_cuda.launches = traverse_shared_cuda.any_launches = 0
    gather_cols_cuda.launches = sort_cuda.launches = shade_cuda.launches = 0
    pack_cuda.launches = 0


def read_counts():
    from raytracebvh_tpu_torch.ops import (gather_cols_cuda, gather_cuda,
                                           pack_cuda, shade_cuda, sort_cuda,
                                           traverse_cuda, traverse_shared_cuda)

    return {"K1": traverse_cuda.launches, "K2": gather_cuda.launches,
            "K3": gather_cuda.scatter_launches,
            "K4": traverse_cuda.any_launches,
            "K5": traverse_shared_cuda.launches,
            "K6": traverse_shared_cuda.any_launches,
            "K7": gather_cols_cuda.launches, "K8": sort_cuda.launches,
            "S": shade_cuda.launches, "P": pack_cuda.launches}


def shade_launches(cfg):
    """S's launches in one unchunked frame of ``cfg``: two a shading pass
    (the primary pass, each bounce and each refraction; a shadow walk
    shades nothing) in float32, none in bfloat16 (the plain shading)."""
    from raytracebvh_tpu_torch.config import traversal_passes

    if cfg.dtype != "float32":
        return 0
    return 2 * (traversal_passes(cfg) - int(cfg.enable_shadows))


def pack_launches(cfg):
    """P's launches in one frame of ``cfg``: one a build in float32 (the
    frame needs no gradient), none in bfloat16 (the plain pack)."""
    return int(cfg.dtype == "float32")


def check_routes(name, n, builds=1):
    """The walk, gather and sort kernels ``name``'s config must take over
    ``builds`` frames or steps: K5/K6 and never K1/K4 for the on-chip
    walks, K1/K4 and never K5/K6 for the rest; K7 and K8 only for the
    on-chip configs, once per pass and once per build."""
    walk, other = (("K5", "K6"), ("K1", "K4")) if name in ONCHIP_WALKS else (
        ("K1", "K4"), ("K5", "K6"))
    check(n[walk[0]] > 0, f"{name}: {walk[0]} was not launched")
    check(n[other[0]] == n[other[1]] == 0,
          f"{name}: {other[0]}/{other[1]} launched: {n}")
    if name in ONCHIP_ALL:
        check(n["K7"] == n[walk[0]] and n["K8"] == builds,
              f"{name}: {n['K7']} K7 for {n[walk[0]]} passes, {n['K8']} K8")
    else:
        check(n["K7"] == n["K8"] == 0, f"{name}: K7 or K8 launched: {n}")
    return walk


def phase_main_path(frames):
    """The frames through render_frame; returns the launch counts summed
    over the frames, the images, and each frame's counts."""
    from raytracebvh_tpu_torch import render_frame
    from raytracebvh_tpu_torch.config import traversal_passes
    from raytracebvh_tpu_torch.ops import traverse_cuda

    images, totals, per_frame = {}, dict.fromkeys(KERNELS, 0), {}
    traverse_cuda.reset_truncated()
    for name, (scene, cam, cfg) in frames.items():
        img, n, refr = render_counted(name, scene, cam, cfg)
        images[name], per_frame[name] = img, n
        hits = hit_mask(img, cfg)
        rate = float(hits.float().mean())
        log(f"  {name}: {tuple(img.shape)}, hit rate {rate:.4f}, "
            f"launches {n}")
        check(tuple(img.shape) == (H, W, 4), f"{name}: image shape")
        check(bool(torch.isfinite(img).all()), f"{name}: non-finite pixels")
        check(rate > 0, f"{name}: no ray hit")
        near, anyk = check_routes(name, n)
        check(n["K2"] > 0, f"{name}: K2 was not launched")
        if not cfg.ray_chunk:  # a culled frame's S: culled_routes below
            check(n["S"] == shade_launches(cfg),
                  f"{name}: {n['S']} S launches, not {shade_launches(cfg)}")
        check(n["K3"] == 0, f"{name}: K3 launched in a forward frame")
        check(n["P"] == pack_launches(cfg),
              f"{name}: {n['P']} P launches, not {pack_launches(cfg)}")
        if not cfg.enable_shadows:
            check(n[anyk] == 0, f"{name}: {anyk} launched without shadows")
        elif cfg.ray_chunk:
            # one any-hit launch per shaded chunk; a culled chunk launches
            # none
            shaded = int(hits.reshape(-1, cfg.ray_chunk).any(-1).sum())
            nchunks = W * H // cfg.ray_chunk
            log(f"  {name}: {shaded} of {nchunks} chunks shaded")
            check(n[anyk] == shaded < nchunks,
                  f"{name}: {n[anyk]} {anyk} launches for {shaded} shaded "
                  "chunks")
        else:
            check(n[anyk] == 1, f"{name}: {n[anyk]} {anyk} launches, not 1")
        if cfg.ray_chunk:
            # one primary walk for every chunk, a body a shaded chunk
            shaded = int(hits.reshape(-1, cfg.ray_chunk).any(-1).sum())
            want = culled_routes(name, shaded)
            check(n == want, f"{name}: launches {n}, {shaded} shaded "
                  f"chunks' {want}")
        if cfg.enable_refraction:
            check(n[near] == traversal_passes(cfg),
                  f"{name}: {n[near]} {near} launches")
            w = torch.cat(refr)
            share = float((w != 0).float().mean())
            log(f"  {name}: share of pixels with a non-zero refraction "
                f"weight {share:.4f}")
            check(share > 0, f"{name}: no pixel refracts")
        for k in totals:
            totals[k] += n[k]
    trunc = traverse_cuda.truncated_rays()
    log(f"  main path launches: {totals}, truncated rays {trunc}")
    check(trunc == 0, f"{trunc} rays cut by the step cap on the main path")

    for name, (scene, cam, cfg) in frames.items():
        with torch.inference_mode():
            ms = wall_ms(lambda: render_frame(scene, cam, cfg))
        rays = W * H * traversal_passes(cfg)
        log(f"  {name}: {ms:.2f} ms/frame, {rays / max(ms, 1e-9) / 1e3:.2f} "
            f"Mrays/s ({rays} rays)")

    # dense_onchip against the same config through K1/K4, K2 and lax
    scene, cam, cfg = frames["dense_onchip"]
    with torch.inference_mode():
        ref = render_frame(scene, cam, cfg.replace(
            traversal_backend="cuda", shade_gather_backend="cuda",
            sort_backend="lax"))
        torch.cuda.synchronize()
    ndiff = int((images["dense_onchip"] != ref).any(-1).sum())
    log(f"  dense_onchip vs K1/K4/K2/lax: {ndiff} differing pixels")
    check(ndiff == 0, f"dense_onchip: {ndiff} pixels differ from K1/K4/K2/lax")

    for name in ("dense", "dense_shadows", "sparse_shadows", "large_shadows",
                 "refract", "dense_onchip", "dense_bf16",
                 "dense_bf16_onchip"):
        scene, cam, cfg = frames[name]
        # dense_bf16's plain path takes the casts its kernels' wrappers make
        casts = (plain_walks_like_kernels() if cfg.dtype == "bfloat16"
                 else contextlib.nullcontext())
        with torch.inference_mode(), casts:
            t0 = time.perf_counter()
            ref = render_frame(scene, cam, plain(cfg))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        diff = (images[name] - ref).abs().amax(-1)
        frac = float(diff.le(1e-4).float().mean())
        log(f"  {name} vs plain PyTorch render: max |diff| "
            f"{float(diff.max()):.3g}, {frac:.6f} of pixels within 1e-4; "
            f"plain render {ms:.1f} ms/frame")
        check(frac >= MATCH_MIN, f"{name} image: only {frac} of pixels match")
    return totals, images, per_frame


# traversal_chunk on the dense frame: one that divides the 2 073 600 rays
# and one that does not; a kernel route walks a pass in one launch
# whatever the chunk (pipeline._traverse_ids)
TRAVERSAL_CHUNKS = (25600, 1000)


def phase_traversal_chunk(frames, images, frame_counts):
    """The dense frame with each of TRAVERSAL_CHUNKS, eager and through
    render_frame_jit (captured, then replayed): every image bit for bit
    phase 4's dense image, the eager frame's launches the dense frame's
    (K1 2: a launch a pass) and the capture's twice them (its warm-up
    and its graph).  Returns the launch counts."""
    from raytracebvh_tpu_torch import pipeline, render_frame_jit

    scene, cam, cfg = frames["dense"]
    want = frame_counts["dense"]
    check(want["K1"] == 2, f"dense: K1 {want['K1']}, not a launch a pass")
    totals = dict.fromkeys(KERNELS, 0)
    for chunk in TRAVERSAL_CHUNKS:
        run = cfg.replace(traversal_chunk=chunk)
        img, n, _ = render_counted("dense", scene, cam, run)
        pipeline.FRAME_GRAPHS.clear()
        with torch.inference_mode():
            graphed, n_capture = counted(
                lambda: render_frame_jit(scene, cam, run))
            replayed = render_frame_jit(scene, cam, run)
        torch.cuda.synchronize()
        pipeline.FRAME_GRAPHS.clear()
        ndiff = [int((x != images["dense"]).any(-1).sum())
                 for x in (img, graphed, replayed)]
        log(f"  dense, traversal_chunk {chunk} ({W * H / chunk:g} chunks): "
            f"pixels off phase 4's image {ndiff} (eager, capture, replay); "
            f"launches eager {n}, capture {n_capture}")
        check(ndiff == [0, 0, 0], f"dense, traversal_chunk {chunk}: pixels "
              f"off phase 4's image {ndiff}")
        check(n == want and n_capture == {k: 2 * v for k, v in want.items()},
              f"dense, traversal_chunk {chunk}: launches eager {n}, capture "
              f"{n_capture}, not {want} and twice it")
        for k in totals:
            totals[k] += n[k] + n_capture[k]
    return totals


def phase_train(train, shaded):
    """loss_fn + backward() and train_step at 1080p on each training
    frame (``shaded``: the culled step's shaded chunks, the sparse
    frame's); returns the launch counts summed over the frames, and each
    frame's (loss, gradients) of its first step."""
    from raytracebvh_tpu_torch.config import traversal_passes
    from raytracebvh_tpu_torch.models.inverse import (InverseParams,
                                                      init_params,
                                                      make_optimizer,
                                                      train_step)

    totals = dict.fromkeys(KERNELS, 0)
    steps = {}
    for name, (scene, cam, cfg) in train.items():
        target = torch.zeros((H, W, 4), device=scene.device)
        params = init_params(scene)
        reset_counts()
        loss, grads = value_and_grad(params, scene, cam, target, cfg)
        torch.cuda.synchronize()
        n = read_counts()
        log(f"  {name}: loss {float(loss)!r}, launches {n}")
        want = step_routes(name, shaded)
        check(n == want, f"{name}: launches {n}, not {want}")
        if name in CHUNK_BODY:
            # the same step with every chunk shaded and differentiated:
            # both loops visit every chunk
            unculled = cfg.replace(cull_empty_chunks=False)
            (loss_u, grads_u), n_u = counted(lambda: value_and_grad(
                init_params(scene), scene, cam, target, unculled))
            want_u = culled_routes(name, W * H // cfg.ray_chunk)
            check(n_u == want_u, f"{name} unculled: launches {n_u}, not "
                  f"{want_u}")
            check(torch.equal(loss, loss_u),
                  f"{name}: loss {float(loss)!r}, unculled "
                  f"{float(loss_u)!r}")
            for field, g, gu in zip(InverseParams._fields, grads, grads_u):
                rel = float((g - gu).abs().max()) / max(
                    float(gu.abs().max()), 1e-30)
                log(f"  {name} d{field} against the unculled chunked step: "
                    f"{rel:.3g} of its largest |grad|, "
                    f"{'bit for bit' if torch.equal(g, gu) else 'not bit for bit'}")
                check(rel <= GRAD_TOL, f"{name}: d{field} {rel} off the "
                      "unculled step's")
            ms_u = wall_ms(lambda: value_and_grad(init_params(scene), scene,
                                                  cam, target, unculled))
            torch.cuda.reset_peak_memory_stats()
            value_and_grad(init_params(scene), scene, cam, target, unculled)
            torch.cuda.synchronize()
            log(f"  {name} unculled chunked step: launches {n_u}; loss_fn + "
                f"backward {ms_u:.2f} ms/step, peak device memory "
                f"{torch.cuda.max_memory_allocated()} bytes")
            for k in totals:
                totals[k] += n_u[k]
        for k in totals:
            totals[k] += n[k]
        steps[name] = (loss, grads)
        if name == "onchip_train":
            # the same step as dense_train's through K1, K2 and lax
            loss_d, grads_d = steps["dense_train"]
            check(torch.equal(loss, loss_d),
                  f"onchip_train: loss {float(loss)!r}, dense_train "
                  f"{float(loss_d)!r}")
            for field, g, gd in zip(InverseParams._fields, grads, grads_d):
                rel = float((g - gd).abs().max()) / max(
                    float(gd.abs().max()), 1e-30)
                log(f"  onchip_train d{field} against dense_train: {rel:.3g} "
                    "of its largest |grad|")
                check(rel <= 1e-6, f"onchip_train: d{field} {rel} off "
                      "dense_train's")
        t0 = time.perf_counter()
        loss_p, grads_p = value_and_grad(init_params(scene), scene, cam,
                                         target, plain(cfg))
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        check(bool(torch.isfinite(loss)) and torch.equal(loss, loss_p),
              f"{name}: loss {float(loss)!r}, all-plain {float(loss_p)!r}")
        for field, g, gp in zip(InverseParams._fields, grads, grads_p):
            scale = float(gp.abs().max())
            rel = float((g - gp).abs().max()) / max(scale, 1e-30)
            log(f"  {name} d{field}: max |grad| {scale:.4g}, kernels against "
                f"all-plain {rel:.3g} of it")
            check(bool(torch.isfinite(g).all()) and bool((g != 0).any()),
                  f"{name}: d{field} non-finite or all zero")
            check(rel <= GRAD_TOL, f"{name}: d{field} {rel} off all-plain")
        log(f"  {name}: all-plain loss_fn + backward {plain_s * 1e3:.1f} ms")

        params = init_params(scene)
        start = [p.detach().clone() for p in params]
        opt = make_optimizer(params, 1e-2)
        reset_counts()
        losses = [float(train_step(params, opt, scene, cam, target, cfg))
                  for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        n = read_counts()
        moved = [float((p.detach() - p0).abs().max())
                 for p, p0 in zip(params, start)]
        log(f"  {name}: {TRAIN_STEPS} train_steps, losses {losses}, largest "
            f"parameter moves {moved}, launches {n}")
        check(all(np.isfinite(losses)), f"{name}: train_step losses {losses}")
        check(all(m > 0 for m in moved), f"{name}: a parameter did not move")
        check(n["K3"] == want["K3"] * TRAIN_STEPS,
              f"{name}: {n['K3']} K3 launches")
        check_routes(name, n, builds=TRAIN_STEPS)
        for k in totals:
            totals[k] += n[k]

        ms = wall_ms(lambda: value_and_grad(params, scene, cam, target, cfg))
        torch.cuda.reset_peak_memory_stats()
        value_and_grad(params, scene, cam, target, cfg)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        rays = W * H * traversal_passes(cfg)
        log(f"  {name}: loss_fn + backward {ms:.2f} ms/step, "
            f"{rays / max(ms, 1e-9) / 1e3:.2f} Mrays/s ({rays} rays), peak "
            f"device memory {peak / 2**30:.3f} GiB")
    log(f"  training launches: {totals}")
    return totals, steps


def phase_cli(obj, device):
    from raytracebvh_tpu_torch.cli import render as cli
    from raytracebvh_tpu_torch.io.bmp import read_bmp

    with tempfile.TemporaryDirectory() as tmp:
        for extra in ([], ["--shadows", "--refract"]):
            out = os.path.join(tmp, "out.bmp")
            t0 = time.perf_counter()
            reset_counts()
            rc = cli.main(["--obj", obj, "--width", str(W), "--height",
                           str(H), "--bounces", "1", "--frames", "3",
                           "--out", out, "--device", device, *extra])
            dt = time.perf_counter() - t0
            n = read_counts()
            log(f"  cli {' '.join(extra) or '(plain)'}: launches {n}")
            # --backend auto on a 3 072-triangle scene: K5 (and K6), as
            # the JAX CLI's auto takes pallas on a TPU
            check(n["K5"] > 0 and n["K1"] == n["K4"] == 0,
                  f"cli {extra}: the default backend did not run K5")
            check(("--shadows" in extra) == (n["K6"] > 0),
                  f"cli {extra}: {n['K6']} K6 launches")
            check(rc == 0, f"cli {extra} exited {rc}")
            check(os.path.isfile(out), f"cli {extra} wrote no image")
            img = read_bmp(out)
            os.remove(out)
            log(f"  cli {' '.join(extra) or '(plain)'}: exit {rc}, wrote "
                f"{img.shape[1]}x{img.shape[0]} BMP in {dt:.1f} s, "
                f"{int((img != 128).any(-1).sum())} non-background pixels")
            check(img.shape == (H, W, 3), f"cli image shape {img.shape}")


def run_cli(module, argv):
    """``module.main(argv)`` in this process with every launch count set
    to 0 just before it: (exit code, printed lines, counts read just
    after, seconds)."""
    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    torch.cuda.synchronize()
    return rc, buf.getvalue().splitlines(), read_counts(), \
        time.perf_counter() - t0


def npz_leaves(path):
    with np.load(path) as z:
        return [z[f"leaf_{i}"] for i in range(len(z.files))]


def phase_train_cli(obj, device):
    """cli.train at 1920x1080 on the OBJ, --self-target: two
    uninterrupted 4-step runs (checkpoints every 2 steps), and a 2-step
    run resumed to 4; returns the launch counts summed over the runs."""
    from raytracebvh_tpu_torch.cli import train as cli
    from raytracebvh_tpu_torch.io.obj import load_obj
    from raytracebvh_tpu_torch.models.inverse import (adam_state, init_params,
                                                      make_optimizer,
                                                      optimizer_from_numpy,
                                                      params_from_numpy)
    from raytracebvh_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                        save_checkpoint)

    totals = dict.fromkeys(KERNELS, 0)
    common = ["--obj", obj, "--self-target", "--width", str(W), "--height",
              str(H), "--log-every", "1", "--device", device]
    with tempfile.TemporaryDirectory() as tmp:
        ck = {k: os.path.join(tmp, f"{k}.npz") for k in ("A", "C", "B")}
        runs = [("A", ["--steps", "4", "--ckpt-every", "2"], 4),
                ("C", ["--steps", "4", "--ckpt-every", "2"], 4),
                ("B", ["--steps", "2"], 2),
                ("B", ["--steps", "4"], 2)]
        for i, (name, args, trained) in enumerate(runs):
            argv = common + args + ["--ckpt", ck[name]]
            rc, lines, n, dt = run_cli(cli, argv)
            what = f"train cli {name} {' '.join(args)}"
            for line in lines:
                log(f"  {what}: {line}")
            log(f"  {what}: exit {rc} in {dt:.1f} s, launches {n}")
            check(rc == 0, f"{what} exited {rc}")
            # --backend auto on a 3 072-leaf tree: K5 (a walk a pass, two
            # passes a render), K2, and K3 twice in the step's warm-up and
            # twice in its capture: the counters do not see a graph's
            # replays (phase 11 counts K3 in them, twice a step)
            check(n["K5"] > 0 and n["K1"] == n["K4"] == n["K6"] == 0,
                  f"{what}: launches {n}, not K5 alone among the walks")
            check(n["K2"] > 0, f"{what}: K2 was not launched")
            check(n["K3"] == 4,
                  f"{what}: {n['K3']} K3 launches, not 2 in the step's "
                  "warm-up and 2 in its capture")
            losses = [float(ln.split()[-1]) for ln in lines
                      if ln.startswith("step ")]
            check(len(losses) == trained and all(np.isfinite(losses)),
                  f"{what}: losses {losses}")
            if i == len(runs) - 1:
                check(lines[0] == f"resumed from {ck[name]} at step 2",
                      f"{what}: did not resume ({lines[0]!r})")
            else:
                check(losses[-1] < losses[0], f"{what}: losses {losses} "
                      "did not fall")
            rate = [ln for ln in lines if ln.startswith("trained ")]
            check(len(rate) == 1, f"{what}: no steps/s line")
            for k in totals:
                totals[k] += n[k]
        a, c, b = (npz_leaves(ck[k]) for k in ("A", "C", "B"))
        check(len(a) == len(b) == len(c) == 11, "checkpoints of "
              f"{len(a)}, {len(c)}, {len(b)} leaves, not 11")
        spread = max(float(np.abs(x.astype(np.float64) - y).max())
                     for x, y in zip(a, c))
        resumed = max(float(np.abs(x.astype(np.float64) - y).max())
                      for x, y in zip(a, b))
        log(f"  train cli: two uninterrupted runs differ by at most "
            f"{spread!r} (the tolerance of the resume check); the resumed "
            f"run differs from the first by at most {resumed!r}")
        check(resumed <= spread, f"train cli: resumed run {resumed} off the "
              f"uninterrupted one, beyond the runs' own spread {spread}")
        log(f"  train cli: checkpoint {os.path.getsize(ck['A'])} bytes, "
            f"11 leaves")

        # checkpoint save and restore on their own, the CLI's state tree
        params = init_params(load_obj(obj, device=device))
        like = (params, adam_state(make_optimizer(params), params), 0)
        restore_ms, save_ms = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            p_np, s_np, step = restore_checkpoint(ck["A"], like)
            params = params_from_numpy(p_np, device)
            opt = optimizer_from_numpy(params, s_np, 1e-2, device)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            save_checkpoint(os.path.join(tmp, "S.npz"),
                            (params, adam_state(opt, params), step))
            t2 = time.perf_counter()
            restore_ms.append((t1 - t0) * 1e3)
            save_ms.append((t2 - t1) * 1e3)
        log(f"  train cli: checkpoint restore (to the card) "
            f"{np.median(restore_ms):.3f} ms, save {np.median(save_ms):.3f} "
            "ms (median of 5)")
    log(f"  train cli launches: {totals}")
    return totals


STAGES = ["morton", "sort", "topology", "fit", "links", "build_total",
          "trace_shade", "frame_total"]
# what a Chrome trace of the small OBJ's frame (cli.profile --sort
# bitonic --trace) must name: K5, K2 and K8's one-block route
TRACE_KERNELS = ("traverse_shared_kernel", "gather_f32_kernel",
                 "sort_tile_kernel")


def trace_path(lines):
    """The Chrome trace that cli.profile's printed ``lines`` name."""
    return lines[-1].split("trace written to ", 1)[-1]


def trace_kernels(lines):
    """name -> whether the trace that cli.profile wrote names it, for each
    of TRACE_KERNELS."""
    with open(trace_path(lines)) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    return {k: any(k in x for x in names) for k in TRACE_KERNELS}


def phase_profile_cli(objs, device):
    """cli.profile at 1920x1080 on the small OBJ and the large one (read
    by the native loader), with the lax sort and with K8; the small one
    with --trace.  Returns the launch counts summed over the runs."""
    from raytracebvh_tpu_torch import native
    from raytracebvh_tpu_torch.cli import profile as cli

    check(native.available(), "the native library did not build")
    totals = dict.fromkeys(KERNELS, 0)
    with tempfile.TemporaryDirectory() as tmp:
        for name, obj in objs.items():
            for sort in ("lax", "bitonic"):
                # each stage's median over 40 rounds of all the stages:
                # a host-bound stage's time moves by tens of percent from
                # call to call, and the build must read within the frame
                argv = ["--obj", obj, "--width", str(W), "--height", str(H),
                        "--sort", sort, "--iters", "40", "--device", device]
                traced = name == "small" and sort == "bitonic"
                if traced:
                    argv += ["--trace", os.path.join(tmp, "trace")]
                what = f"profile cli {name} --sort {sort}"
                # a trace now and then drops kernel records (profile_counts):
                # a traced run whose trace lacks a kernel runs again, three
                # runs at most
                for attempt in range(3 if traced else 1):
                    with Recorder(native, "load_obj_native") as loader:
                        rc, lines, n, dt = run_cli(cli, argv)
                    if not traced or rc or all(trace_kernels(lines).values()):
                        break
                    log(f"  {what}: run {attempt + 1}'s trace lacks kernels: "
                        f"{trace_kernels(lines)}")
                for line in lines:
                    log(f"  {what}: {line}")
                log(f"  {what}: exit {rc} in {dt:.1f} s, launches {n}")
                check(rc == 0, f"{what} exited {rc}")
                check(len(loader.results) == 1
                      and loader.results[0] is not None,
                      f"{what}: the OBJ was not read by the native loader")
                ms = {ln.split()[0]: float(ln.split()[1]) for ln in lines[1:9]}
                check(list(ms) == STAGES, f"{what}: stages {list(ms)}")
                check(all(np.isfinite(v) and v > 0 for v in ms.values()),
                      f"{what}: stage times {ms}")
                check(ms["build_total"] <= ms["frame_total"],
                      f"{what}: build {ms['build_total']} ms over the frame's "
                      f"{ms['frame_total']} ms")
                check((n["K8"] > 0) == (sort == "bitonic"),
                      f"{what}: {n['K8']} K8 launches")
                if traced:
                    found = trace_kernels(lines)
                    log(f"  {what}: trace {os.path.getsize(trace_path(lines))}"
                        f" bytes, kernels {found}")
                    check(all(found.values()),
                          f"{what}: the trace lacks kernels: {found}")
                for k in totals:
                    totals[k] += n[k]
                if sort == "lax":
                    eager = eager_stage_times(obj, device)
                    log(f"  {what}: eager stages (the graphs' bodies, median "
                        f"of 10 rounds) " + ", ".join(
                            f"{k} {v * 1e3:.3f}" for k, v in eager.items())
                        + " ms; graphed/eager " + ", ".join(
                            f"{k} {ms[k] / (v * 1e3):.3f}"
                            for k, v in eager.items()))
                    check(list(eager) == STAGES
                          and all(np.isfinite(v) and v > 0
                                  for v in eager.values()),
                          f"{what}: eager stage times {eager}")
    log(f"  profile cli launches: {totals}")
    return totals


def eager_stage_times(obj, device):
    """The stage table of cli.profile's default config on ``obj``, each
    stage eager (utils.profiling's stages before their capture), seconds:
    the table the graphed one replaced."""
    from raytracebvh_tpu_torch import Camera, RenderConfig
    from raytracebvh_tpu_torch.io.obj import load_obj
    from raytracebvh_tpu_torch.utils import profiling

    scene = load_obj(obj, device=device)
    cfg = RenderConfig(width=W, height=H, bounces=1)
    with torch.no_grad():
        stages, _ = profiling._eager_stages(scene, Camera.default(device),
                                            cfg)
        return profiling._median_times(stages, 10, torch.device(device))


def phase_culled_stage(frames):
    """utils.profiling's graphed stages on the sparse frame (culled ray
    chunks): trace_shade is one CUDA graph (a graphs.Captured), whose
    capture launched its warm-up's and one loop body, and whose replay
    under sync-debug mode "error" is shade_rays' bits with its loop's
    trip counter the hit chunks; its replay ms (CUDA events) beside the
    eager stage's; its eager launches, which phase 12 holds a profiled
    replay to.  Returns the launch counts of its captures."""
    from raytracebvh_tpu_torch import graphs, pipeline
    from raytracebvh_tpu_torch.utils import profiling

    scene, cam, cfg = frames["sparse"]
    reset_counts()
    with torch.no_grad():
        stages = profiling._graphed_stages(scene, cam, cfg)
        torch.cuda.synchronize()
        n = read_counts()
        eager, (s, bvh, rays) = profiling._eager_stages(scene, cam, cfg)
        ref = pipeline.shade_rays(s, bvh, rays, cfg)
        _, ne = counted(eager["trace_shade"])
    torch.cuda.synchronize()
    shaded = ne["K2"] // CHUNK_BODY["sparse"]["K2"]
    check(ne == culled_routes("sparse", shaded, 0),
          f"trace_shade: eager launches {ne}")
    # trace_shade's and frame_total's warm-ups and captures; P, the eager
    # build the stages start from, build_total's and frame_total's
    # warm-ups and captures
    each = capture_routes("sparse", ne, culled_routes("sparse", 1, 0))
    want = {k: 2 * v for k, v in each.items()}
    want["P"] = 1 + 2 + 2
    check(n == want, f"trace_shade, build_total and frame_total: captures' "
          f"launches {n}, not {want}")
    trace_shade = stages["trace_shade"]
    check(isinstance(trace_shade, graphs.Captured),
          f"trace_shade is a {type(trace_shade).__name__}, not one graph")
    with no_host_reads("trace_shade"):
        got = trace_shade().clone()
    torch.cuda.synchronize()
    check(torch.equal(got, ref), "trace_shade: a replay off shade_rays' bits")
    trips = check_trips("trace_shade", trace_shade, "sparse", ne)
    CULLED_WANT["trace_shade sparse"] = ne
    times = profiling._median_times(
        {"graphed": trace_shade, "eager": eager["trace_shade"]}, 10,
        scene.device)
    log(f"  trace_shade on the sparse frame (culled chunks): one graph "
        f"(its and frame_total's captures launched {n}), a replay under "
        f"sync-debug mode 'error' shade_rays' bits, trip counter {trips}; "
        f"{times['graphed'] * 1e3:.3f} ms a replay, "
        f"eager {times['eager'] * 1e3:.3f} ms (CUDA events, median of 10 "
        f"rounds); capture {trace_shade.capture_ms:.1f} ms, pool "
        f"{trace_shade.pool_bytes} bytes; eager launches {ne}")
    pipeline.FRAME_GRAPHS.clear()
    return n


def phase_depth_and_loader(objs, small, device):
    """render_depth_bmp at 500x500 on the 3 072-triangle scene, a replayed
    CUDA graph, against its eager body through the traversal dispatch and
    through the plain walk; the native loader against the Python one on
    both OBJs.  Returns the depth image's launch counts (its capture's)."""
    from raytracebvh_tpu_torch import pipeline
    from raytracebvh_tpu_torch.io.obj import load_obj
    from raytracebvh_tpu_torch.ref import refimage
    from raytracebvh_tpu_torch.ref.refimage import MISS_RGB, render_depth_bmp

    def eager():
        with torch.no_grad():
            return refimage._depth_image(
                *refimage._depth_walk(small, 500, 500, 1)(small), 500, 500, 1)

    refimage.DEPTH_GRAPHS.clear()
    t0 = time.perf_counter()
    img, n = counted(lambda: render_depth_bmp(small, 500, 500, 1))
    first_ms = (time.perf_counter() - t0) * 1e3
    img2, n2 = counted(lambda: render_depth_bmp(small, 500, 500, 1))
    (graph,) = refimage.DEPTH_GRAPHS.entries.values()
    ref_eager = eager()
    with mock.patch.object(pipeline, "resolve_traversal_backend",
                           lambda *a: "torch"):
        ref = eager()
    hits = float((img != MISS_RGB).any(-1).mean())
    ndiff = [int((x != y).any(-1).sum())
             for x, y in ((img, ref_eager), (img2, ref_eager), (img, ref))]
    graphed_ms = wall_ms(lambda: render_depth_bmp(small, 500, 500, 1))
    eager_ms = wall_ms(eager)
    log(f"  depth image: {img.shape}, hit share {hits:.4f}; graphed (capture "
        f"{graph.capture_ms:.1f} ms, first call {first_ms:.1f} ms, launches "
        f"{n} in its warm-up and capture, {n2} in a replay): pixels off the "
        f"eager image {ndiff[0]} (capture's replay), {ndiff[1]} (a second "
        f"replay), off the plain walk's {ndiff[2]}; {graphed_ms:.2f} ms "
        f"graphed, {eager_ms:.2f} ms eager (host clock, both with the "
        f"host's byte conversion)")
    check(img.shape == (500, 500, 3) and hits > 0, "depth image: no hit")
    check(n["K5"] + n["K1"] == 2 and n["K2"] == n["K3"] == 0
          and n["P"] == 2,
          f"depth image: launches {n} in the warm-up and capture")
    check(not any(n2.values()), f"depth image: a replay counted {n2}")
    check(ndiff == [0, 0, 0], f"depth image: pixels off {ndiff}")
    for name, obj in objs.items():
        scenes, secs = {}, {}
        for backend in ("native", "python"):
            t0 = time.perf_counter()
            scenes[backend] = load_obj(obj, backend=backend, device="cpu")
            secs[backend] = time.perf_counter() - t0
        a, b = scenes["native"], scenes["python"]
        same = all(torch.equal(getattr(a, f), getattr(b, f)) for f in (
            "verts", "normals", "uv", "indices", "mat_index", "textures",
            "tex_hw")) and all(
            torch.equal(getattr(a.materials, f), getattr(b.materials, f))
            for f in ("ambient", "diffuse", "specular", "shininess",
                      "optical_density", "alpha", "tex_id"))
        log(f"  load_obj {name} ({a.num_faces} triangles): native "
            f"{secs['native']:.3f} s, python {secs['python']:.3f} s, "
            f"{'bit-equal' if same else 'DIFFERENT'}")
        check(same, f"load_obj {name}: native and python scenes differ")
    return n


# phase 10: the sharded entry points on the main path's configs, each held
# to its single-process result
SHARDED_FRAMES = (("render_sharded", "dense"), ("render_geo_sharded", "large"),
                  ("render_geo_sharded", "dense_shadows"),
                  ("render_sharded", "sparse"),
                  ("render_geo_sharded", "sparse_shadows"))
SHARDED_LAUNCHES = {"dense": dict(K1=2, K2=4, S=4, P=1),
                    "large": dict(K1=1, K2=2, S=2, P=1),
                    "dense_shadows": dict(K1=1, K2=2, K4=1, S=2, P=1)}
# the sharded steps: (config, grad_chunks)
SHARDED_STEPS = (("sparse_train", 1), ("sparse_train", 4),
                 ("sparse_train_culled", 1))


def counted(fn):
    """fn() with every launch count set to 0 just before it: its result
    and the counts read just after."""
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, read_counts()


@contextlib.contextmanager
def no_host_reads(what):
    """The block under torch.cuda.set_sync_debug_mode("error"): a read on
    the host (a synchronizing call) raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    except RuntimeError as e:
        raise SmokeFailure(f"{what}: a host read in a replay: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)


def graph_routes(entry, case, name, want, call, nodes_want):
    """The hand-written kernels in the graph of ``case`` on the config
    ``name``: from its own kernel nodes
    (CUDAGraph.debug_dump), held to ``nodes_want`` (a culled chunk loop's
    graph holds one loop body: ``check_culled_nodes``), and by
    torch.profiler over a replay (``call``), held to ``want``
    (``replay_routes``; a culled case's in phase 12, ``CULLED_WANT``, and
    here its trip counters after the last replay, ``check_trips``);
    returns the replay's kernels in all (None for a culled case), the
    graph's kernel nodes and its trip counters."""
    nodes, nk, per, conds = dump_routes(entry.graph)
    check(nodes == nodes_want, f"graph nodes {nodes}, not {nodes_want}")
    if name not in CHUNK_BODY:
        check(not conds, f"{case}: conditional nodes {conds}")
        return replay_routes(call, want)[1], nk, []
    check_culled_nodes(case, name, per, conds)
    CULLED_WANT[case] = want
    return None, nk, check_trips(case, entry, name, want)


def case_routes(name, n_eager, builds=1):
    """(the kernels a call of the case ``name`` launches, those its graph
    holds): ``SHARDED_LAUNCHES`` or ``step_routes`` ``builds`` times, or
    for a culled chunk loop its eager body's, held to ``culled_routes`` (a
    rank's shaded chunks are its own), and in the graph one chunk's loop
    body."""
    if name not in CHUNK_BODY:
        want = dict.fromkeys(KERNELS, 0)
        for k, v in (SHARDED_LAUNCHES.get(name) or step_routes(name)).items():
            want[k] = v * builds
        return want, want
    check(n_eager == culled_routes(
        name, n_eager["K2"] // CHUNK_BODY[name]["K2"]),
        f"{name}: eager launches {n_eager}")
    return n_eager, culled_routes(name, 1)


def sharded_cases(frames, train, mesh, images, steps):
    """SHARDED_FRAMES and SHARDED_STEPS on ``mesh``: each a CUDA graph
    captured at its first call and replayed at its second, beside its
    eager body.  Every frame must equal ``images`` (render_frame's) bit
    for bit; a one-chunk step's loss must equal ``steps``' (loss_fn's) bit
    for bit at world size 1, within 1e-6 above, and its gradients be
    within GRAD_TOL of loss_fn's; the four-chunk step within the same
    gates of the one-chunk step; the replayed steps and the eager bodies'
    within the same gates.  The launch counts: the eager body's the
    case's, the capture's its warm-up's and what its graph holds
    (``capture_routes``), a replay's none; the kernels in the graph (its
    nodes) and in a replay (torch.profiler) the case's (``case_routes``;
    a culled case's graph holds one loop body, and its replay runs it
    once a shaded chunk: its trip counters).  Returns the launch counts
    summed over the cases and a row of capture ms, pool bytes, replay
    kernels and trip counters a case."""
    from raytracebvh_tpu_torch.models.inverse import (InverseParams,
                                                      apply_params,
                                                      init_params)
    from raytracebvh_tpu_torch.parallel import render as prender
    from raytracebvh_tpu_torch.parallel.mesh import mesh_graphs

    world = mesh.size()
    totals = dict.fromkeys(KERNELS, 0)
    rows = {}
    cache = mesh_graphs(mesh)

    def add(n):
        for k in totals:
            totals[k] += n[k]

    def captured(what, name, n, n_replay, n_eager, builds=1):
        """The case's one capture after its two calls, its counts held;
        returns it and the case's (want, nodes_want)."""
        (entry,) = cache.entries.values()
        want, in_graph = case_routes(name, n_eager, builds)
        n_capture = capture_routes(name, want, in_graph)
        check(n_eager == want and n == n_capture
              and not any(n_replay.values()),
              f"{what}: launches eager {n_eager}, capture {n}, replay "
              f"{n_replay}; the case's {want}, its capture's {n_capture}")
        return entry, want, in_graph

    cache.debug = True
    try:
        for fn_name, name in SHARDED_FRAMES:
            scene, cam, cfg = frames[name]
            fn = getattr(prender, fn_name)
            body = getattr(prender, "_" + fn_name)
            cache.clear()
            with torch.no_grad():
                img, n = counted(lambda: fn(scene, cam, cfg, mesh))
                img2, n2 = counted(lambda: fn(scene, cam, cfg, mesh))
                img_e, ne = counted(lambda: body(scene, cam, cfg, mesh))
            entry, want, in_graph = captured(f"{fn_name} {name}", name, n,
                                             n2, ne)
            ndiff = [int((x != images[name]).any(-1).sum())
                     for x in (img, img2, img_e)]

            def replay():
                with torch.no_grad():
                    fn(scene, cam, cfg, mesh)

            with no_host_reads(f"{fn_name} {name}"):
                replay()
            kernels, nodes, trips = graph_routes(
                entry, f"{fn_name} {name}", name, want, replay, in_graph)
            log(f"  {fn_name} {name} (world {world}): pixels off "
                f"render_frame's {ndiff} (capture's replay, a replay, eager "
                f"body); launches eager {ne}, capture {n}; one graph, "
                f"{nodes} kernel nodes ({in_graph}), a replay under "
                f"sync-debug mode 'error' {kernels} kernels ({want}), trip "
                f"counters {trips}, capture {entry.capture_ms:.1f} ms, pool "
                f"{entry.pool_bytes} bytes")
            check(ndiff == [0, 0, 0], f"{fn_name} {name}: pixels off {ndiff}")
            add(n)
            add(ne)
            rows[f"{fn_name} {name}"] = dict(
                capture_ms=entry.capture_ms, pool_bytes=entry.pool_bytes,
                kernels=kernels, kernel_nodes=nodes, trips=trips)

        ref = {}
        for name, chunks in SHARDED_STEPS:
            scene, cam, cfg = train[name]
            target = torch.zeros((H, W, 4), device=scene.device)

            def step(fn=prender.train_step_sharded):
                return fn(init_params(scene), apply_params, scene, cam,
                          target, cfg, mesh, grad_chunks=chunks)

            cache.clear()
            (loss, grads), n = counted(step)
            (loss2, grads2), n2 = counted(step)
            (loss_e, grads_e), ne = counted(
                lambda: step(prender._train_step_sharded))
            what = f"train_step_sharded {name} grad_chunks={chunks}"
            entry, want, in_graph = captured(what, name, n, n2, ne, chunks)
            loss_r, grads_r = steps[name] if chunks == 1 else ref[name]
            against = "loss_fn" if chunks == 1 else "grad_chunks=1"
            log(f"  {what} (world {world}): loss {float(loss)!r} (a replay "
                f"{float(loss2)!r}, eager body {float(loss_e)!r}), {against} "
                f"{float(loss_r)!r}; launches eager {ne}, capture {n}")
            for lo, gr, how in ((loss2, grads2, "replay"),
                                (loss_e, grads_e, "eager body")):
                if chunks == 1 and world == 1:
                    check(torch.equal(lo, loss_r),
                          f"{what} {how}: loss not {against}'s bits")
                else:
                    rel = abs(float(lo) - float(loss_r)) / abs(float(loss_r))
                    check(rel <= 1e-6, f"{what} {how}: loss {rel} off")
                for field, g, g_r in zip(InverseParams._fields, gr, grads_r):
                    err = float((g - g_r).abs().max()) / max(
                        float(g_r.abs().max()), 1e-30)
                    log(f"    {how} d{field}: {err:.3g} of {against}'s "
                        f"largest |grad|")
                    check(bool(torch.isfinite(g).all()) and err <= GRAD_TOL,
                          f"{what} {how}: d{field} {err} off {against}")
            same = torch.equal(loss2, loss_e) and all(
                torch.equal(a, b) for a, b in zip(grads2, grads_e))
            with no_host_reads(what):
                step()
            kernels, nodes, trips = graph_routes(
                entry, f"train_step_sharded {name}", name, want, step,
                in_graph)
            check(torch.equal(step()[0], loss2),
                  f"{what}: a later replay's loss off the first replays'")
            if name in CHUNK_BODY:
                trips = check_trips(what, entry, name, want)
            log(f"    replay vs eager body: "
                f"{'bit for bit' if same else 'DIFFERENT bits'}; one graph, "
                f"{nodes} kernel nodes ({in_graph}), a replay {kernels} "
                f"kernels ({want}), trip counters {trips}, capture "
                f"{entry.capture_ms:.1f} ms, pool {entry.pool_bytes} bytes")
            if chunks == 1:
                ref[name] = (loss_e, grads_e)
            add(n)
            add(ne)
            rows[what] = dict(capture_ms=entry.capture_ms,
                              pool_bytes=entry.pool_bytes, kernels=kernels,
                              kernel_nodes=nodes, trips=trips,
                              replay_equals_eager=same)
    finally:
        cache.debug = False
        cache.clear()
    return totals, rows


def phase_sharded(frames, train, images, steps, smi):
    """The multi-device path at world size 1 over NCCL (one card): the
    cases of sharded_cases against phase 4's images and phase 5's step;
    NCCL's set-up, the frames' and steps' times graphed and eager beside
    the single-process ones, the collectives' times.  With two cards or
    more, the same cases at 2 or 4 ranks with geo=2 (sharded_rank).
    Returns the launch counts of the cases."""
    import torch.distributed as dist

    from raytracebvh_tpu_torch import pipeline, render_frame, render_frame_jit
    from raytracebvh_tpu_torch.models.inverse import apply_params, init_params
    from raytracebvh_tpu_torch.parallel import mesh as pmesh
    from raytracebvh_tpu_torch.parallel import render as prender

    t0 = time.perf_counter()
    pmesh.initialize_distributed()
    init_ms = (time.perf_counter() - t0) * 1e3
    try:
        check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
        mesh = pmesh.make_mesh()
        probe = torch.ones(1, device="cuda")
        t0 = time.perf_counter()
        dist.all_reduce(probe, group=mesh.get_group(pmesh.GEO_AXIS))
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        log(f"  NCCL world {dist.get_world_size()}, mesh {mesh}: "
            f"init_process_group {init_ms:.3f} ms, first all_reduce "
            f"(communicator set-up) {first_ms:.3f} ms; {smi}")
        totals, rows = sharded_cases(frames, train, mesh, images, steps)

        # eager body, graphed, then the single-process frame eager and
        # graphed, in turns
        for fn_name, name in SHARDED_FRAMES:
            scene, cam, cfg = frames[name]
            fn = getattr(prender, fn_name)
            body = getattr(prender, "_" + fn_name)
            with torch.no_grad():
                times = [wall_ms(lambda: body(scene, cam, cfg, mesh)),
                         wall_ms(lambda: fn(scene, cam, cfg, mesh)),
                         wall_ms(lambda: render_frame(scene, cam, cfg)),
                         wall_ms(lambda: render_frame_jit(scene, cam, cfg)),
                         wall_ms(lambda: fn(scene, cam, cfg, mesh)),
                         wall_ms(lambda: body(scene, cam, cfg, mesh))]
            pmesh.mesh_graphs(mesh).clear()
            pipeline.FRAME_GRAPHS.clear()
            rows[f"{fn_name} {name}"].update(
                eager_ms=[times[0], times[5]], graphed_ms=[times[1], times[4]],
                frame_ms=times[2], frame_jit_ms=times[3])
            log(f"  {fn_name} {name}: graphed {times[1]:.2f} / "
                f"{times[4]:.2f} ms/frame, eager body {times[0]:.2f} / "
                f"{times[5]:.2f}; render_frame_jit {times[3]:.2f}, "
                f"render_frame {times[2]:.2f} ms/frame (median of 5 each, in "
                f"turns); {smi}")
        for name, chunks in SHARDED_STEPS:
            scene, cam, cfg = train[name]
            target = torch.zeros((H, W, 4), device=scene.device)

            def sharded_step(fn=prender.train_step_sharded):
                return lambda: fn(init_params(scene), apply_params, scene,
                                  cam, target, cfg, mesh, grad_chunks=chunks)

            single = lambda: value_and_grad(init_params(scene), scene, cam,
                                            target, cfg)
            body, graphed = (sharded_step(prender._train_step_sharded),
                             sharded_step())
            times = [wall_ms(body), wall_ms(graphed), wall_ms(single),
                     wall_ms(graphed), wall_ms(body)]
            pmesh.mesh_graphs(mesh).clear()
            what = f"train_step_sharded {name} grad_chunks={chunks}"
            rows[what].update(
                eager_ms=[times[0], times[4]], graphed_ms=[times[1], times[3]],
                single_eager_ms=times[2])
            log(f"  {what}: graphed {times[1]:.2f} / {times[3]:.2f} ms/step, "
                f"eager body {times[0]:.2f} / {times[4]:.2f}; loss_fn + "
                f"backward {times[2]:.2f} ms/step (median of 5 each, in "
                f"turns); {smi}")
        log("  sharded rows: " + json.dumps(rows))

        nparams = 1 + sum(p.numel() for p in init_params(scene))
        buf = torch.zeros(nparams, device="cuda")
        img = torch.zeros(H * W, 4, device="cuda")
        out = torch.empty_like(img)
        ar = cuda_ms(lambda: dist.all_reduce(
            buf, group=mesh.get_group(pmesh.GEO_AXIS)), reps=20)
        ag = cuda_ms(lambda: dist.all_gather_into_tensor(
            out, img, group=mesh.get_group(pmesh.RAYS_AXIS)), reps=20)
        log(f"  gradient all_reduce ({nparams} float32) {ar:.4f} ms, frame "
            f"all_gather ({H * W} x 4 float32) {ag:.4f} ms (CUDA events, "
            f"median of 20); {smi}")
    finally:
        pmesh.destroy_distributed()

    cards = torch.cuda.device_count() // 2 * 2
    if cards >= 2:
        run_sharded_ranks(min(cards, 4))
    else:
        log(f"  {torch.cuda.device_count()} card: world size 1 was the "
            "largest run")
    return totals


# phase 11: render_frame_jit and train_step_jit, the port's counterparts
# of the JAX package's jitted frame and step (CUDA graphs, graphs.py)
GRAPHED_FRAMES = ("dense", "sparse", "large", "dense_shadows",
                  "sparse_shadows", "refract", "dense_onchip", "dense_bf16")
GRAPHED_TRAIN = ("sparse_train", "onchip_train", "sparse_train_culled")
# the graphed steps' parameters against the eager steps' with
# make_optimizer's default Adam, largest |difference|.  The capturable Adam
# takes its learning rate as a float32 tensor and computes its bias
# corrections on the device in float32, where the default one uses Python
# floats, so after one step (same gradient) an update (~lr = 1e-2) differs
# by a few of its ulps (~1e-9) and a parameter (|p| <= ~1) by a few of its
# own (<= 1.2e-7 each)
GRAPHED_STEP1_TOL = 1e-6
# after TRAIN_STEPS steps: from step 2 on the two runs' gradients differ
# (those ulps move rays across triangle edges and change every float sum),
# and Adam's update is at most 1.0036 lr for steps 1-3 (Cauchy-Schwarz over
# m-hat and v-hat with b1 0.9, b2 0.999), so a parameter may part by up to
# 2 x 1.0036 lr a step after the first
GRAPHED_PARAM_TOL = 2 * 1.0036 * 1e-2 * (TRAIN_STEPS - 1)
# the graphed steps' losses against the default Adam's eager steps':
# whole-frame means, moved by the parted parameters only in their 7th
# digit
GRAPHED_LOSS_RTOL = 1e-5


def kernel_of(name):
    """The K of a hand-written kernel's name, demangled (the profiler's)
    or mangled (a graph's dump), counting each wrapper's call once (K3 by
    its last kernel, K8 by its tile kernel) and S by each of its two
    kernels, as its counter does; None for any other kernel."""
    false = "<false>" in name or "ILb0E" in name
    if "traverse_shared_kernel" in name:
        return "K5" if false else "K6"
    if "traverse_kernel" in name:
        return "K1" if false else "K4"
    if "gather_cols_f32_kernel" in name:
        return "K7"
    if "gather_f32_kernel" in name or "gather_u8_kernel" in name:
        return "K2"
    if "scatter_finish_kernel" in name:
        return "K3"
    if "sort_tile_kernel" in name:
        return "K8"
    if "shade_surface_kernel" in name or "shade_finish_kernel" in name:
        return "S"
    if "leaf_pack_kernel" in name:
        return "P"
    return None


def routes(counts):
    """K -> calls, from kernel name -> kernels of that name."""
    out = dict.fromkeys(KERNELS, 0)
    for name, n in counts.items():
        k = kernel_of(name)
        if k is not None:
            out[k] += n
    return out


def dump_routes(graph):
    """(K -> calls, kernel nodes in all, graph -> K -> calls, the types of
    its conditional nodes) of a kept CUDA graph, from its own nodes: ``CUDAGraph.debug_dump``'s DOT gives
    each node as a record ``"graph_G_node_N"[... label="{KERNEL | {ID | N
    | <mangled name><<<grid, block, smem>>>} ...}"];`` over several lines,
    a conditional node's body as a graph G of its own.  A witness of the
    graph's kernels that needs no profiler."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.dot")
        graph.debug_dump(path)
        with open(path) as f:
            dot = f.read()
    nodes = re.findall(r'"graph_\d+_node_\d+"\[.*?\];', dot, re.DOTALL)
    kernels = [n for n in nodes if 'label="{KERNEL' in n]
    check(kernels, f"a graph's dump holds no kernel node: {dot[:300]!r}")
    per = {}
    for n in kernels:
        counts = per.setdefault(int(re.match(r'"graph_(\d+)_', n).group(1)),
                                dict.fromkeys(KERNELS, 0))
        k = kernel_of(n)
        if k is not None:
            counts[k] += 1
    conds = re.findall(r"Conditional Type\|\s*(\w+)", dot)
    return routes({n: 1 for n in kernels}), len(kernels), per, conds


def check_culled_nodes(what, name, per_graph, conds):
    """The graph of the culled config ``name`` from its own nodes
    (``dump_routes``): the captured graph holds the primary walks alone,
    its loop bodies (WHILE nodes' body graphs: a frame's one, a step's
    two, the forward's and the VJP's) one chunk's shading, and its
    conditional nodes (``conds``) are those WHILE nodes alone.  What a
    replay runs of them, torch.profiler counts in phase 12."""
    top = min(per_graph)
    bodies = dict.fromkeys(KERNELS, 0)
    for g, r in per_graph.items():
        if g != top:
            for k in KERNELS:
                bodies[k] += r[k]
    front = culled_routes(name, 0)
    one = {k: v - front[k] for k, v in culled_routes(name, 1).items()}
    loops = len(loop_trips(name, culled_routes(name, 1)))
    check(per_graph[top] == front and bodies == one
          and len(per_graph) == 1 + loops and conds == ["WHILE"] * loops,
          f"{what}: graph {per_graph[top]} and {len(per_graph) - 1} loop "
          f"bodies {bodies} ({conds} nodes), not {front} and {loops} WHILE "
          f"bodies holding {one}")


def step_routes(name, shaded=None):
    """K -> calls of one training step of ``name``: a walk and a leaf
    gather a pass (2), K2 for the texture quads (2), K3 twice (the two
    leaf gathers' backward), K8 once a build where the config sorts with
    it, no S and no P (every pass and the build are differentiated); for
    the culled step, ``culled_routes`` with ``shaded`` of its chunks
    shaded."""
    if name in CHUNK_BODY:
        return culled_routes(name, shaded)
    want = dict.fromkeys(KERNELS, 0)
    if name in ONCHIP_ALL:
        want.update(K5=2, K7=2, K2=2, K3=2, K8=1)
    else:
        want.update(K1=2, K2=4, K3=2)
    return want


def graphed_frame(name, frame_args, image, want):
    """render_frame_jit on one frame: its image and an orbited one bit for
    bit the eager frames', its kernels in the graphs and in the replays
    equal to phase 4's routes ``want``; returns its row of the table and
    the launch counts of its warm-up and capture."""
    from raytracebvh_tpu_torch import pipeline, render_frame, render_frame_jit
    from raytracebvh_tpu_torch.camera import orbit

    scene, cam, cfg = frame_args
    cache = pipeline.FRAME_GRAPHS
    cache.clear()
    torch.cuda.empty_cache()
    reset_counts()
    with torch.inference_mode():
        img = render_frame_jit(scene, cam, cfg)
        torch.cuda.synchronize()
    n = read_counts()
    (frame,) = cache.entries.values()
    ndiff = int((img != image).any(-1).sum())
    check(img.dtype == image.dtype and ndiff == 0,
          f"graphed {name}: {ndiff} pixels off phase 4's eager image")
    cam2 = orbit(cam, 0.1, 0.0)
    with torch.inference_mode():
        with no_host_reads(f"graphed {name}"):
            img2 = render_frame_jit(scene, cam2, cfg)
        ref2 = render_frame(scene, cam2, cfg)
        torch.cuda.synchronize()
    ndiff2 = int((img2 != ref2).any(-1).sum())
    check(ndiff2 == 0 and not torch.equal(img2, img)
          and len(cache.entries) == 1,
          f"graphed {name}: orbited frame {ndiff2} pixels off the eager one "
          f"({len(cache.entries)} captures)")
    with torch.inference_mode(), no_host_reads(f"graphed {name}"):
        img3 = render_frame_jit(scene, cam, cfg)  # phase 4's camera again
    torch.cuda.synchronize()
    check(torch.equal(img3, image),
          f"graphed {name}: a replay off phase 4's eager image")

    # the kernels in the graph, from its own nodes (a culled frame's
    # graph holds one loop body), and from torch.profiler over a replay
    # (phase 4's launches; a culled frame's in phase 12, and here its
    # loop's trip counter, the shaded chunks)
    in_graph, trips = want, []
    if cfg.ray_chunk:
        in_graph = culled_routes(name, 1)
        trips = check_trips(f"graphed {name}", frame, name, want)
    check(n == capture_routes(name, want, in_graph),
          f"graphed {name}: warm-up and capture launches {n}, not "
          f"{capture_routes(name, want, in_graph)}")

    def call():
        with torch.inference_mode():
            render_frame_jit(scene, cam, cfg)

    nodes, nk, per, conds = dump_routes(frame.graph)
    check(nodes == in_graph,
          f"graphed {name}: graph nodes {nodes}, not {in_graph}")
    if cfg.ray_chunk:
        check_culled_nodes(f"graphed {name}", name, per, conds)
        CULLED_WANT[f"render_frame_jit {name}"] = want
        seen, kernels, device_ms = "in phase 12", None, cuda_ms(call)
        check_trips(f"graphed {name}", frame, name, want)
    else:
        seen, kernels, device_ms = replay_routes(call, want)

    with torch.inference_mode():
        eager_ms = wall_ms(lambda: render_frame(scene, cam, cfg))
        graphed_ms = wall_ms(lambda: render_frame_jit(scene, cam, cfg))
    row = dict(eager_ms=eager_ms, graphed_ms=graphed_ms,
               capture_ms=frame.capture_ms, pool_bytes=frame.pool_bytes,
               kernels=kernels, device_ms=device_ms, kernel_nodes=nk,
               trips=trips)
    log(f"  graphed {name}: one graph, bit for bit phase 4's image and the "
        f"eager frame at an orbited camera; {nk} kernel nodes, routes "
        f"{nodes}; a replay under sync-debug mode 'error' raised nothing, "
        f"{kernels} kernels, routes {seen} (phase 4's), trip counters "
        f"{trips}, {device_ms:.3f} ms (CUDA events for a culled frame, else "
        f"device time); eager {eager_ms:.2f} ms, graphed "
        f"{graphed_ms:.2f} ms; capture {frame.capture_ms:.1f} ms, graph "
        f"pool {frame.pool_bytes} bytes")
    cache.clear()
    return row, n


def graphed_step(name, step_args, shaded):
    """train_step_jit on ``name``, TRAIN_STEPS steps, against as many
    eager train_steps from the same start: with the same capturable Adam,
    every loss and parameter bit for bit (the graph replays the eager
    step); with make_optimizer's default Adam, the first loss bit for bit,
    the losses within GRAPHED_LOSS_RTOL, the parameters after one step
    within GRAPHED_STEP1_TOL (the update's ulps) and after TRAIN_STEPS
    steps within GRAPHED_PARAM_TOL; the step's kernels in a replay (K3
    twice; the culled step's, ``shaded`` chunks' trips of its two loops,
    their trip counters, and one body each in the graph), a replay under
    sync-debug mode "error"; peak device memory of a graphed and an eager
    step.  Returns its row and
    the launch counts of its warm-up and capture."""
    from raytracebvh_tpu_torch.models import inverse

    scene, cam, cfg = step_args
    target = torch.zeros((H, W, 4), device=scene.device)

    def eager_run(capturable):
        params = inverse.init_params(scene)
        opt = inverse.make_optimizer(params, 1e-2, capturable)
        snaps, losses = [], []
        for _ in range(TRAIN_STEPS):
            losses.append(inverse.train_step(params, opt, scene, cam, target,
                                             cfg))
            snaps.append([p.detach().clone() for p in params])
        return params, opt, losses, snaps

    pe, oe, le, se = eager_run(False)
    _, _, lc, sc = eager_run(True)
    pg = inverse.init_params(scene)
    og = inverse.make_optimizer(pg, 1e-2, capturable=True)
    # keep the step's graph for its dump (CUDAGraph.debug_dump)
    inverse.step_graphs(og).debug = True
    reset_counts()
    lg, sg = [], []
    for _ in range(TRAIN_STEPS):
        lg.append(inverse.train_step_jit(pg, og, scene, cam, target, cfg,
                                         lr=1e-2))
        sg.append([p.detach().clone() for p in pg])
    torch.cuda.synchronize()
    n = read_counts()
    start = [p.detach() for p in inverse.init_params(scene)]
    moved = max(float((p - p0).abs().max()) for p, p0 in zip(se[-1], start))
    same_c = all(torch.equal(a, b) for a, b in zip(lg, lc)) and all(
        torch.equal(a, b) for x, y in zip(sg, sc) for a, b in zip(x, y))
    off = [max(float((a - b).abs().max()) for a, b in zip(x, y))
           for x, y in zip(sg, se)]
    within = [sum(int((a - b).abs().le(GRAPHED_STEP1_TOL).sum())
                  for a, b in zip(x, y)) / sum(a.numel() for a in x)
              for x, y in zip(sg, se)]
    log(f"  graphed {name}: {TRAIN_STEPS} steps, losses graphed "
        f"{[float(x) for x in lg]}, eager {[float(x) for x in le]}; "
        f"graphed vs eager with the capturable Adam: "
        f"{'bit for bit' if same_c else 'DIFFERENT'}; vs the default Adam: "
        f"parameters off by at most {off} after each step, share within "
        f"{GRAPHED_STEP1_TOL} {within} (largest move {moved:.4g})")
    check(same_c, f"graphed {name}: not the eager step's bits with the same "
          "capturable Adam")
    check(torch.equal(lg[0], le[0]),
          f"graphed {name}: first loss off the default Adam's eager loss")
    check(off[0] <= GRAPHED_STEP1_TOL and moved > 0,
          f"graphed {name}: parameters {off[0]} off after one step")
    check(off[-1] <= GRAPHED_PARAM_TOL,
          f"graphed {name}: parameters {off[-1]} off after {TRAIN_STEPS} "
          "steps")
    check(all(abs(float(a) - float(b)) <= GRAPHED_LOSS_RTOL * abs(float(b))
              for a, b in zip(lg, le)),
          f"graphed {name}: losses off the default Adam's eager losses")
    (entry,) = inverse.step_graphs(og).entries.values()
    want = step_routes(name, shaded)
    in_graph, trips = want, []
    if name in CHUNK_BODY:
        in_graph = culled_routes(name, 1)
        trips = check_trips(f"graphed {name}", entry.captured, name, want)
    n_capture = capture_routes(name, want, in_graph)
    check(n == n_capture, f"graphed {name}: warm-up and capture launches "
          f"{n}, not {n_capture}")
    nodes, nk, per, conds = dump_routes(entry.captured.graph)
    check(nodes == in_graph,
          f"graphed {name}: graph nodes {nodes}, not {in_graph}")
    if name in CHUNK_BODY:
        check_culled_nodes(f"graphed {name}", name, per, conds)
        CULLED_WANT[f"train_step_jit {name}"] = want
        seen = "in phase 12"

    def call():
        inverse.train_step_jit(pg, og, scene, cam, target, cfg, lr=1e-2)

    with no_host_reads(f"graphed {name}"):
        call()
    if name in CHUNK_BODY:
        kernels, device_ms = None, cuda_ms(call)
        check_trips(f"graphed {name}", entry.captured, name, want)
    else:
        seen, kernels, device_ms = replay_routes(call, want)
    eager_ms = wall_ms(lambda: inverse.train_step(pe, oe, scene, cam, target,
                                                  cfg))
    graphed_ms = wall_ms(call)
    peak = {}
    for how, fn in (("eager", lambda: inverse.train_step(
            pe, oe, scene, cam, target, cfg)), ("graphed", call)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak[how] = torch.cuda.max_memory_allocated()
    cap = entry.captured
    row = dict(eager_ms=eager_ms, graphed_ms=graphed_ms,
               capture_ms=cap.capture_ms, pool_bytes=cap.pool_bytes,
               kernels=kernels, device_ms=device_ms, param_off=off,
               peak_bytes=peak, kernel_nodes=nk, trips=trips)
    log(f"  graphed {name}: one graph; routes {seen} a replay under "
        f"sync-debug mode 'error' (K3 {want['K3']}); eager train_step "
        f"{eager_ms:.2f} ms, graphed {graphed_ms:.2f} ms; capture "
        f"{cap.capture_ms:.1f} ms, graph pool {cap.pool_bytes} bytes; peak "
        f"device memory eager {peak['eager']} bytes, graphed "
        f"{peak['graphed']}; {nk} kernel nodes, trip counters {trips}; a "
        f"replay {kernels} kernels, {device_ms:.3f} ms (CUDA events for the "
        f"culled step, else device time)")
    # the caller drops the optimizer: its graph goes with it
    held = released()
    del entry, cap, call, fn, pg, og
    row["reserved_bytes"] = optimizer_lifetime(name, step_args, lg[0], held)
    return row, n


def released() -> int:
    """The device memory reserved once unreachable objects are collected
    (an optimizer and its step graphs are a reference cycle) and the
    allocator's free blocks given back."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def optimizer_lifetime(name, step_args, loss0, held):
    """train_step_jit for a second optimizer on ``name``, after the
    caller (graphed_step) dropped the first, which held ``held`` bytes
    reserved with its graph: the bytes reserved once the first is
    collected, with the second's graph, and once that is dropped.  Each
    graph goes with its optimizer, so the first drop gives bytes back and
    the two drops leave the same bytes; the second step's loss is the
    first optimizer's first loss (``loss0``) bit for bit."""
    from raytracebvh_tpu_torch.models import inverse

    scene, cam, cfg = step_args
    target = torch.zeros((H, W, 4), device=scene.device)
    reserved = [held, released()]
    params = inverse.init_params(scene)
    opt = inverse.make_optimizer(params, 1e-2, capturable=True)
    loss = inverse.train_step_jit(params, opt, scene, cam, target, cfg,
                                  lr=1e-2)
    same = torch.equal(loss, loss0)
    reserved.append(released())
    del loss, params, opt
    reserved.append(released())
    log(f"  graphed {name}, a second optimizer: reserved bytes with the "
        f"first's graph {reserved[0]}, after it was dropped {reserved[1]}, "
        f"with "
        f"the second's graph {reserved[2]}, after it was dropped "
        f"{reserved[3]}; its first loss "
        f"{'the first optimizer' if same else 'NOT the first optimizer'}'s "
        "bits")
    check(same, f"graphed {name}: a second optimizer's first loss off")
    check(reserved[0] > reserved[1] == reserved[3] < reserved[2],
          f"graphed {name}: reserved bytes {reserved} (first held, dropped, "
          "second held, dropped): a dropped optimizer's graph kept")
    return reserved


def phase_graphed(frames, train, images, frame_counts, shaded):
    """Phase 11: render_frame_jit on GRAPHED_FRAMES and train_step_jit on
    GRAPHED_TRAIN, one capture each, freed before the next; returns the
    launch counts of their warm-ups and captures (the counters do not see
    replays)."""
    from raytracebvh_tpu_torch import pipeline

    totals, rows = dict.fromkeys(KERNELS, 0), {}
    pipeline.FRAME_GRAPHS.debug = True
    try:
        for name in GRAPHED_FRAMES:
            rows[name], n = graphed_frame(name, frames[name], images[name],
                                          frame_counts[name])
            for k in totals:
                totals[k] += n[k]
    finally:
        pipeline.FRAME_GRAPHS.debug = False
    for name in GRAPHED_TRAIN:
        rows[name], n = graphed_step(name, train[name], shaded)
        for k in totals:
            totals[k] += n[k]
    log("  graphed rows: " + json.dumps(rows))
    log(f"  graphed launches (warm-ups and captures): {totals}")
    return totals


# phase 12: each culled graph of phases 8, 10 and 11 (case "<entry point>
# <config>") -> the launches of its eager call, which a replay must run
CULLED_WANT: dict = {}


def culled_call(case: str, frames, train, mesh):
    """(a call that replays the graph of the culled ``case`` of
    ``CULLED_WANT``, captured here at its first call, the graph's
    graphs.Captured)."""
    from raytracebvh_tpu_torch import pipeline, render_frame_jit
    from raytracebvh_tpu_torch.models import inverse
    from raytracebvh_tpu_torch.parallel import mesh as pmesh
    from raytracebvh_tpu_torch.parallel import render as prender
    from raytracebvh_tpu_torch.utils import profiling

    fn_name, name = case.split()
    scene, cam, cfg = {**frames, **train}[name]
    target = torch.zeros((H, W, 4), device=scene.device)
    if fn_name == "trace_shade":
        with torch.no_grad():
            call = profiling._graphed_stages(scene, cam, cfg)[fn_name]
        return call, call
    caches = lambda: pmesh.mesh_graphs(mesh)  # noqa: E731
    if fn_name == "render_frame_jit":
        caches = lambda: pipeline.FRAME_GRAPHS  # noqa: E731

        def call():
            with torch.inference_mode():
                render_frame_jit(scene, cam, cfg)
    elif fn_name == "train_step_jit":
        params = inverse.init_params(scene)
        opt = inverse.make_optimizer(params, 1e-2, capturable=True)
        caches = lambda: inverse.step_graphs(opt)  # noqa: E731

        def call():
            inverse.train_step_jit(params, opt, scene, cam, target, cfg,
                                   lr=1e-2)
    elif fn_name == "train_step_sharded":
        def call():
            prender.train_step_sharded(inverse.init_params(scene),
                                       inverse.apply_params, scene, cam,
                                       target, cfg, mesh)
    else:
        def call():
            with torch.no_grad():
                getattr(prender, fn_name)(scene, cam, cfg, mesh)
    call()
    (entry,) = caches().entries.values()
    return call, getattr(entry, "captured", entry)


def replay_kernels(case: str, want: dict) -> int:
    """One case of phase 12 in a process of its own: the culled graph of
    ``case`` captured, then torch.profiler over one replay, its
    hand-written kernels held to ``want`` (``culled_replay_routes``); the
    last line is {"routes", "trips", "kernels", "ms"}."""
    import torch.distributed as dist

    from raytracebvh_tpu_torch import _kernels
    from raytracebvh_tpu_torch.parallel import mesh as pmesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _kernels.load()
    dev = torch.device("cuda", 0)
    try:
        frames = frames_on(dev)
        mesh = None
        if "sharded" in case:
            pmesh.initialize_distributed()
            mesh = pmesh.make_mesh()
        call, captured = culled_call(case, frames, train_frames(frames), mesh)
        ran, trips, records = culled_replay_routes(
            call, captured, case.split()[1], want)
        ms = cuda_ms(call)
    except SmokeFailure as e:
        return fail(str(e))
    finally:
        if dist.is_initialized():
            pmesh.destroy_distributed()
    print(json.dumps(dict(routes=ran, trips=trips, kernels=records, ms=ms)))
    return 0


def phase_culled_replays(wants: dict) -> None:
    """Phase 12: torch.profiler over one replay of each culled graph of
    phases 8, 10 and 11, each graph captured and traced in a fresh process
    of this script (--replay-kernels), all started together: a replay's
    hand-written kernels must be the launches of the eager call that its
    phase held it to (the shaded chunks' bodies, K3 in the steps'), from
    the trace and its loops' trip counters (``culled_replay_routes``).  A
    fresh process, since in a process that has taken many traces the
    profiler misnames kernels in a loop's body (PERF.md §7)."""
    procs = {case: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--replay-kernels", case,
         json.dumps(want)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for case, want in wants.items()}
    try:
        outs = {case: p.communicate(timeout=600)[0]
                for case, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
    for case, out in outs.items():
        lines = out.strip().splitlines() or [""]
        if procs[case].returncode != 0:
            for line in lines[-12:]:
                log(f"  {case}: {line}")
        check(procs[case].returncode == 0, f"{case}: its process failed")
        got = json.loads(lines[-1])
        check(got["routes"] == wants[case],
              f"{case}: a replay ran {got['routes']}, not {wants[case]}")
        log(f"  {case}: one replay under torch.profiler in a process of its "
            f"own: {got['kernels']} kernel records, trip counters "
            f"{got['trips']}, so routes {got['routes']} (the eager call's); "
            f"{got['ms']:.3f} ms a replay (CUDA events)")
    check(len(wants) == 7, f"phase 12 had {len(wants)} culled graphs, not 7")


def run_sharded_ranks(world: int) -> None:
    """Starts ``world`` ranks of this script (--sharded-rank), one card
    each, and fails unless every rank passes."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    try:
        for r in range(world):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--sharded-rank"],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines()[-12:]:
            log(f"  rank {r}: {line}")
        check(p.returncode == 0, f"rank {r} of {world} failed")
    log(f"  {world} ranks, geo=2: every case passed")


# the shading kernels' phase: the dense frames of frames_on
SHADE_FRAMES = ("dense", "dense_shadows", "large_shadows", "refract",
                "dense_onchip")


def shade_bytes(kind: str, nrays: int, vis: bool) -> int:
    """Bytes the two shading kernels of one pass must move, each read and
    write once: shade_surface reads 25 of the leaf block's 40 channels,
    the ray (24 B) and the hit flag, and writes the position, normal,
    quad row and fractions (9 x 4 B); shade_finish reads the 16 quad
    channels, 16 leaf channels, the first kernel's 8 floats, the ray, the
    flag, the shadow factor where given and a bounce's colour and
    intensity, and writes the colour, spawns and intensities (18 floats
    a launch, 11 a bounce)."""
    surface = 25 * 4 + 24 + 1 + 9 * 4
    finish = (16 + 16 + 8) * 4 + 24 + 1 + 4 * int(vis)
    finish += 18 * 4 if kind == "launch" else (5 + 11) * 4
    return nrays * (surface + finish)


def phase_shade(frames) -> dict:
    """The frames' shading kernels (ops/shade_cuda.py) against the plain
    shading: each SHADE_FRAMES frame at 1080p bit for bit the frame with
    every pass on the plain path (max |diff| 0, NaN nowhere), S's
    launches (counts set to 0 just before the frame) two a pass; then the
    dense frame's primary and bounce passes timed, kernels against plain
    on the same inputs: CUDA events around the pass (median of 5) and the
    profiler's device time of the pass's kernels (median of 10), beside
    the kernels' bound.  A pass is its gathers and shading, and a
    bounce's dead-ray select and ray stack too; its walk is walked once
    beforehand and left out.  Returns the kernel line's row S: the
    primary pass's numbers, the bounce pass's under "bounce"."""
    from raytracebvh_tpu_torch import pipeline, render_frame
    from raytracebvh_tpu_torch.ops import shade_cuda

    plain_shading = mock.patch.object(shade_cuda, "engages",
                                      return_value=False)
    worst = 0.0
    for name in SHADE_FRAMES:
        scene, cam, cfg = frames[name]
        with torch.inference_mode():
            with plain_shading:
                want = render_frame(scene, cam, cfg)
            got, n = counted(lambda: render_frame(scene, cam, cfg))
        diff = float((got - want).abs().max())
        worst = max(worst, diff)
        check(not bool(torch.isnan(got).any() or torch.isnan(want).any()),
              f"shade {name}: NaN in the frame")
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"shade {name}: kernel frame off the plain shading's, max "
              f"|diff| {diff}")
        check(n["S"] == shade_launches(cfg),
              f"shade {name}: {n['S']} launches, want {shade_launches(cfg)}")
        log(f"  shade {name}: max |diff| {diff} against the plain "
            f"shading, {n['S']} launches ({n['S'] // 2} passes)")

    scene, cam, cfg = frames["dense"]
    out = {}
    with torch.inference_mode():
        bvh, rays, _ = pipeline.frame_inputs(scene, cam, cfg)
        rays = pipeline.tile_frame_rays(rays, cfg, W, H)
        bvh, tq = pipeline.shade_setup(scene, bvh, cfg)
        rec = pipeline._traverse_ids(bvh, rays, cfg)
        o3, d3 = pipeline._split_rays(rays)
        color, (ro, rd), inten, _, _ = pipeline._launch_soa(
            scene, bvh, o3, d3, cfg, tq, None, rec)
        # the bounce's walk, once: the timed bounce passes reuse it
        live = inten > cfg.intensity_min
        rec_b = pipeline._traverse_ids(bvh, pipeline._rays_of(
            tuple(torch.where(live, x, 1.0e30) for x in ro), rd), cfg)
        walked = mock.patch.object(pipeline, "_traverse_ids",
                                   lambda *a, **k: rec_b)
        calls = {"launch": lambda: pipeline._launch_soa(
                     scene, bvh, o3, d3, cfg, tq, None, rec),
                 "bounce": lambda: pipeline._bounce_soa(
                     scene, bvh, color, ro, rd, inten, cfg, tq)}
        for kind, pass_call in calls.items():
            def call(pass_call=pass_call):
                with walked:
                    pass_call()

            def plain(call=call):
                with plain_shading:
                    call()
            row = {"ms": cuda_ms(call), "plain_ms": cuda_ms(plain)}
            split = kernel_split(call)
            row["device_ms"] = sum(v for k, v in split.items()
                                   if k.startswith("shade_"))
            row["device_split"] = split
            row["plain_kernels"], row["plain_device_ms"] = profiled(plain)
            row["kernels"], row["pass_device_ms"] = profiled(call)
            nbytes = shade_bytes(kind, W * H, False)
            row["bound_ms"], row["bound_by"] = bound(nbytes, 0)
            row["bytes"] = nbytes
            out[kind] = row
            log(f"  shade {kind} pass, {W * H} rays: kernels {row['ms']:.3f}"
                f" ms (device: shading kernels {row['device_ms']:.4f}, the "
                f"pass's {row['kernels']} kernels {row['pass_device_ms']:.4f})"
                f"; plain {row['plain_ms']:.3f} ms ({row['plain_kernels']} "
                f"kernels, device {row['plain_device_ms']:.4f}); bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}: "
                f"{nbytes / 1e6:.1f} MB); split {split}")
    log(json.dumps({"shade": out}))
    return dict(max_abs_err=worst, library_ms=None, **out["launch"],
                bounce=out["bounce"])


def pack_bytes(n: int) -> int:
    """Bytes the leaf pack must move at ``n`` leaves, each read and write
    once: a leaf reads its prim (4 B), its face's 3 indices (12 B), 3
    corners of 32 B (position, normal, uv) and material index (4 B), and
    two node rows' boxes (2 x 24 B) and links (2 x 8 B); it writes its
    160-byte attribute row, tri_mat (4 B), two 32-byte node rows and the
    48-byte K1 leaf row.  The material table is a few hundred bytes."""
    return n * (4 + 12 + 3 * 32 + 4 + 2 * 24 + 2 * 8
                + 160 + 4 + 2 * 32 + 48)


def phase_pack(dev) -> dict:
    """The build's leaf pack (ops/pack_cuda.py, csrc/pack.cu) on the
    benchmark's tetra1m scene, 1 048 576 triangles (rtbench's SPD tetra
    at size factor 9, seed 1), built by build_bvh: the kernel's tables
    bit for bit the plain pack's (pipeline._pack_leaves, then
    traverse_cuda.pack_tables) on the same inputs; the kernel's device
    ms (``back_to_back_ms``) and CUDA-event ms around one call (median of
    5), the plain tail + pack_tables' of both and its kernels
    (torch.profiler), beside the byte bound.  Returns the kernel line's
    row P."""
    from raytracebvh_tpu_torch import pipeline
    from raytracebvh_tpu_torch.config import RenderConfig
    from raytracebvh_tpu_torch.ops import pack_cuda, traverse_cuda
    from rtbench import harness, scenes, scenes_spd

    man = harness.manifest()
    conf = harness.config_of(man, harness.cell(man, "tetra1m-frame_shadows"))
    raw = scenes_spd.make_scene(conf, 1, dev)
    scene = scenes.port_scene(raw)
    cam = scenes.port_camera(scenes.camera(conf, dev))
    cfg = RenderConfig(width=W, height=H, ortho_scale=conf["ortho_scale"],
                       traversal_backend="cuda")
    with torch.inference_mode(), Recorder(pack_cuda, "pack") as rec:
        bvh = pipeline.build_bvh(
            scene, *pipeline.build_transforms(cam, cfg)[1:], cfg)
        torch.cuda.synchronize()
    check(len(rec.calls) == 1, f"pack: {len(rec.calls)} launches a build")
    (tensors,), _ = rec.calls[0]
    n = bvh.n_leaves
    f32 = torch.float32

    def kernel():
        return pack_cuda.pack(tensors)

    def plain():
        leaves = pipeline._pack_leaves(scene, tensors["verts"],
                                       tensors["normals"], tensors["prim"],
                                       f32)
        nodes, k1 = traverse_cuda.pack_tables(bvh.replace(**leaves))
        return dict(leaves, node_table=nodes, leaf_table=k1)

    with torch.inference_mode():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        for name, w in want.items():
            g = got[name]
            same = g.dtype == w.dtype and g.shape == w.shape and (
                torch.equal(g.view(torch.int32), w.view(torch.int32))
                if w.dtype == f32 else torch.equal(g, w))
            check(same, f"pack {name}: the kernel's differs from the plain "
                  f"pack's ({g.dtype} {tuple(g.shape)}, {w.dtype} "
                  f"{tuple(w.shape)})")
        row = {"leaves": n, "ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
               "device_ms": back_to_back_ms(kernel),
               "plain_device_ms": back_to_back_ms(plain)}
        names = {name for name, _ in kernel_durations(kernel, 10)}
        log(f"  pack: a traced launch's kernels {sorted(names)}")
        row["plain_kernels"] = profiled(plain)[0]
    nbytes = pack_bytes(n)
    row["bound_ms"], row["bound_by"] = bound(nbytes, 0)
    row["bytes"] = nbytes
    row["bound_share"] = row["bound_ms"] / row["device_ms"]
    log(f"  pack, {n} leaves: bit for bit the plain pack's on every table; "
        f"kernel {row['device_ms']:.4f} ms device ({row['ms']:.4f} ms CUDA "
        f"events), plain tail + pack_tables {row['plain_ms']:.4f} ms "
        f"({row['plain_kernels']} kernels, device "
        f"{row['plain_device_ms']:.4f} ms); bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}: {nbytes / 1e6:.1f} MB), "
        f"{100 * row['bound_share']:.1f}% of it")
    return dict(max_abs_err=0.0, library_ms=None, **row)


def sharded_rank() -> int:
    """One rank of run_sharded_ranks: the cases of sharded_cases on a
    geo=2 mesh over all ranks, against this card's own render_frame and
    loss_fn."""
    import torch.distributed as dist

    from raytracebvh_tpu_torch import _kernels, render_frame
    from raytracebvh_tpu_torch.models.inverse import init_params
    from raytracebvh_tpu_torch.parallel import mesh as pmesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _kernels.load()
    pmesh.initialize_distributed()
    dev = torch.device("cuda", torch.cuda.current_device())
    try:
        mesh = pmesh.make_mesh(geo=2)
        frames = frames_on(dev)
        train = train_frames(frames)
        with torch.no_grad():
            images = {name: render_frame(*frames[name])
                      for _, name in SHARDED_FRAMES}
        steps = {}
        for name, _ in SHARDED_STEPS:
            scene, cam, cfg = train[name]
            steps[name] = value_and_grad(init_params(scene), scene, cam,
                                         torch.zeros((H, W, 4), device=dev),
                                         cfg)
        sharded_cases(frames, train, mesh, images, steps)
    except SmokeFailure as e:
        return fail(str(e))
    finally:
        pmesh.destroy_distributed()
    return 0


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi unavailable ({e})"
    log(f"phase 1 device: {kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    log(smi)

    from raytracebvh_tpu_torch import _kernels

    t0 = time.perf_counter()
    lib = _kernels.build()
    _kernels.load()
    log(f"phase 2 build: {time.perf_counter() - t0:.1f} s -> "
        f"{os.path.relpath(lib)}")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "entry function" in line or "registers" in line:
            log(f"  ptxas: {line.strip()}")

    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()

    def phase_done(k):
        nonlocal t_phase
        now = time.perf_counter()
        log(f"phase {k} took {now - t_phase:.1f} s")
        t_phase = now

    try:
        frames = frames_on(dev)
        train = train_frames(frames)
        log("phase 3 kernels against their plain versions:")
        kern = phase_kernels(frames)
        kern["K3"] = phase_k3(train)
        kern.update(phase_onchip_kernels(frames))
        phase_topology(frames)
        phase_done(3)
        log("phase 4 main path:")
        launches, images, frame_counts = phase_main_path(frames)
        shaded = shaded_chunks("sparse", frame_counts["sparse"],
                               W * H // SPARSE_CHUNK)
        for k, v in phase_traversal_chunk(frames, images,
                                          frame_counts).items():
            launches[k] += v
        phase_done(4)
        log("phase 5 training:")
        counts, steps = phase_train(train, shaded)
        for k, v in counts.items():
            launches[k] += v
        phase_done(5)
        from raytracebvh_tpu_torch.io.obj import write_obj

        with tempfile.TemporaryDirectory() as assets:
            objs = {}
            for which, scene in (("small", frames["refract"][0]),
                                 ("large", frames["large"][0])):
                os.mkdir(os.path.join(assets, which))
                objs[which] = write_obj(scene, os.path.join(assets, which))
            log("phase 6 cli:")
            phase_cli(objs["small"], dev.type)
            phase_done(6)
            log("phase 7 train cli:")
            for k, v in phase_train_cli(objs["small"], dev.type).items():
                launches[k] += v
            phase_done(7)
            log("phase 8 profile cli:")
            for k, v in phase_profile_cli(objs, dev.type).items():
                launches[k] += v
            for k, v in phase_culled_stage(frames).items():
                launches[k] += v
            phase_done(8)
            log("phase 9 depth image and native loader:")
            for k, v in phase_depth_and_loader(
                    objs, frames["dense"][0], dev.type).items():
                launches[k] += v
            phase_done(9)
        log("phase 10 multi-device:")
        for k, v in phase_sharded(frames, train, images, steps, smi).items():
            launches[k] += v
        phase_done(10)
        log("phase 11 graphed:")
        for k, v in phase_graphed(frames, train, images, frame_counts,
                                  shaded).items():
            launches[k] += v
        phase_done(11)
        log("phase 12 culled replays' kernels:")
        phase_culled_replays(CULLED_WANT)
        phase_done(12)
        log("phase 13 shading kernels:")
        kern["S"] = phase_shade(frames)
        phase_done(13)
        log("phase 14 leaf pack kernel:")
        kern["P"] = phase_pack(dev)
        phase_done(14)
    except SmokeFailure as e:
        return fail(str(e))
    sources = {"K1": ("raytracebvh_tpu_torch/csrc/traverse.cu",
                      "raytracebvh_tpu/ops/traverse_hbm.py:652"),
               "K2": ("raytracebvh_tpu_torch/csrc/gather.cu",
                      "raytracebvh_tpu/ops/gather_hbm.py:180"),
               "K3": ("raytracebvh_tpu_torch/csrc/scatter.cu",
                      "raytracebvh_tpu/ops/gather_pallas.py:155"),
               "K4": ("raytracebvh_tpu_torch/csrc/traverse.cu",
                      "raytracebvh_tpu/ops/traverse_hbm.py:652"),
               "K5": ("raytracebvh_tpu_torch/csrc/traverse_shared.cu",
                      "raytracebvh_tpu/ops/traverse_pallas.py:476"),
               "K6": ("raytracebvh_tpu_torch/csrc/traverse_shared.cu",
                      "raytracebvh_tpu/ops/traverse_pallas.py:364"),
               "K7": ("raytracebvh_tpu_torch/csrc/gather_cols.cu",
                      "raytracebvh_tpu/ops/gather_pallas.py:130"),
               "K8": ("raytracebvh_tpu_torch/csrc/sort.cu",
                      "raytracebvh_tpu/ops/sort_pallas.py:139"),
               # no TPU kernel: the JAX package leaves the shading to XLA
               "S": ("raytracebvh_tpu_torch/csrc/shade.cu", None),
               # no TPU kernel: the JAX package leaves the pack to XLA
               "P": ("raytracebvh_tpu_torch/csrc/pack.cu", None)}
    missing = [k for k in KERNELS if launches[k] == 0]
    if missing:
        return fail(f"{missing} never launched on the main path")
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=sources[k][0],
             replaces=sources[k][1], launches=launches[k], **kern[k])
        for k in KERNELS]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--sharded-rank"]:
        sys.exit(sharded_rank())
    if sys.argv[1:2] == ["--replay-kernels"] and len(sys.argv) == 4:
        sys.exit(replay_kernels(sys.argv[2], json.loads(sys.argv[3])))
    sys.exit(main())
