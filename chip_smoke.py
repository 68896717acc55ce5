#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (raytracebvh_tpu_torch) on one
NVIDIA GPU: builds the hand-written kernels, holds each against its plain
PyTorch version at the main path's shapes, renders three 1920x1080 frames
through ``render_frame``, and runs the render CLI.

    python3 chip_smoke.py

Phases (one line of output each, or more):
  1. device: the card's name and power limit (nvidia-smi)
  2. build: nvcc over raytracebvh_tpu_torch/csrc/*.cu, with its seconds
  3. kernels: K1 (traversal) and K2 (row gather) against their plain
     versions on the very inputs the main path hands them, and their
     times beside the plain versions' (CUDA events, median of 5)
  4. main path: the dense, sparse and large frames; every kernel's launch
     count over that run; frame ms and Mrays/s (median of 5 after one
     warm-up); the dense image against the all-plain-PyTorch render
  5. cli: raytracebvh_tpu_torch.cli.render on an OBJ + MTL + BMP copy of
     the 3 072-triangle scene

The second-to-last line is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}, printed only when every phase passed.
Exits non-zero, printing no result, without a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

W, H = 1920, 1080
K1_SAMPLE_BOUNCE = 65536  # first-bounce rays held against the plain walk
K1_SAMPLE_LARGE = 262144  # large-tree primary rays held against it
MATCH_MIN = 0.9999  # K1 hit/leaf agreement, and dense-image pixels


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def frames_on(device):
    """name -> (scene, camera, cfg): the bench's 1080p configs
    (bench.py:76-77, :104-107, :522) on its procedural scenes.

    The dense frame keeps the bench's dense config but frames one sphere:
    its ortho_scale=256 was set for Image_Test.obj, and on the fallback
    sphere grid it looks into the gap between spheres (0% of rays hit:
    tests/test_torch_camera.py::test_dense_frame_window_on_sphere_grid).
    Aimed at the sphere at (12.5, 0, 0) with ortho_scale 27, ~71% hit."""
    from raytracebvh_tpu_torch import Camera, RenderConfig
    from raytracebvh_tpu_torch.models.procedural import sphere_grid

    base = RenderConfig(width=W, height=H, bounces=1)
    small = sphere_grid(nx=4, ny=3, subdiv=8).to(device)  # 3 072 tris
    large = sphere_grid(nx=4, ny=4, subdiv=40).to(device)  # 102 400 tris
    cam = Camera.default(device)
    aimed = cam.replace(eye=torch.tensor([12.5, 5.0, -100.0], device=device),
                        at=torch.tensor([12.5, 0.0, 0.0], device=device))
    return {
        "dense": (small, aimed, base.replace(
            ortho_scale=27.0, ray_chunk=0, ray_tile=16,
            texture_dtype="uint8")),
        "sparse": (small, cam, base.replace(ray_chunk=25600)),
        "large": (large, cam, base.replace(bounces=0, ray_tile=16,
                                           ray_chunk=0)),
    }


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


class Recorder:
    """Wraps a kernel wrapper, keeping the arguments of every call: the
    inputs the main path really hands the kernel."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.inner = getattr(module, name)
        self.calls = []

    def __call__(self, *args, **kw):
        self.calls.append((args, kw))
        return self.inner(*args, **kw)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)


def capture(scene, cam, cfg):
    """One frame, recording K1's and K2's arguments."""
    from raytracebvh_tpu_torch import render_frame
    from raytracebvh_tpu_torch.ops import gather_cuda, traverse_cuda

    with Recorder(traverse_cuda, "traverse") as k1, \
            Recorder(gather_cuda, "gather_rows") as k2, \
            torch.inference_mode():
        render_frame(scene, cam, cfg)
    torch.cuda.synchronize()
    return k1.calls, k2.calls


def k1_parity(name, bvh, rays, eps):
    """K1 against the plain walk on the same rays: hit and leaf on
    >= 99.99% of rays (each mismatch a tie or an edge hit), distance
    within rtol 1e-6 where both hit, no ray cut by the step cap."""
    from raytracebvh_tpu_torch.ops import traverse as plain
    from raytracebvh_tpu_torch.ops import traverse_cuda

    traverse_cuda.reset_truncated()
    got = traverse_cuda.traverse(bvh, rays, eps)
    want = plain.traverse(bvh, rays, eps)
    torch.cuda.synchronize()
    trunc = traverse_cuda.truncated_rays()
    bad = (got.hit != want.hit) | (got.leaf != want.leaf)
    nbad = int(bad.sum())
    both = got.hit & want.hit
    err = rel = 0.0
    if both.any():
        dp = want.distance[both]
        diff = (got.distance[both] - dp).abs()
        err = float(diff.max())
        rel = float((diff / dp.abs().clamp(min=1e-30)).max())
    unexplained = 0
    if nbad:
        unexplained = int((~_tie_or_edge(bvh, rays, got, want, bad)).sum())
    nrays = rays.origin.shape[0]
    log(f"  K1 {name}: {nrays} rays, {int(want.hit.sum())} hits, "
        f"{nbad} hit/leaf mismatches ({unexplained} neither tie nor edge), "
        f"max |d distance| {err:.3g} (rel {rel:.3g}), "
        f"truncated {trunc}")
    check(nbad <= (1 - MATCH_MIN) * nrays and unexplained == 0,
          f"K1 {name}: {nbad} mismatches, {unexplained} unexplained")
    check(rel <= 1e-6, f"K1 {name}: distance rel error {rel}")
    check(trunc == 0, f"K1 {name}: {trunc} rays cut by the step cap")
    return err


def _tie_or_edge(bvh, rays, got, want, bad):
    """Mismatched rays explained by a tie (equal distances) or a hit
    within 1e-4 of a triangle edge in barycentric terms."""
    from raytracebvh_tpu_torch.ops.traverse_cuda import pack_tables

    idx = bad.nonzero().squeeze(1)
    tie = got.hit[idx] & want.hit[idx] & (
        (got.distance[idx] - want.distance[idx]).abs()
        <= 1e-6 * want.distance[idx].abs())
    _, leaves = pack_tables(bvh)
    o, d = rays.origin[idx], rays.direction[idx]
    edge = torch.zeros_like(tie)
    for rec in (got, want):
        lt = leaves[rec.leaf[idx].long()]
        v0, e1, e2 = lt[:, 0:3], lt[:, 3:6], lt[:, 6:9]
        p = torch.cross(d, e2, dim=1)
        det = (e1 * p).sum(1)
        tv = o - v0
        u = (tv * p).sum(1) / det
        v = (d * torch.cross(tv, e1, dim=1)).sum(1) / det
        near = torch.stack([u.abs(), v.abs(), (1 - u - v).abs()]).amin(0)
        edge |= rec.hit[idx] & (near <= 1e-4)
    return tie | edge


def phase_kernels(frames):
    from raytracebvh_tpu_torch.core.types import Rays
    from raytracebvh_tpu_torch.ops import gather_cuda, traverse_cuda
    from raytracebvh_tpu_torch.ops import traverse as plain
    from raytracebvh_tpu_torch.ops.shade import (pack_texture_quads,
                                                 quantize_quads_u8)

    result = {}
    scene_d, cam_d, cfg_d = frames["dense"]
    k1_calls, k2_calls = capture(scene_d, cam_d, cfg_d)
    check(len(k1_calls) == 2 and len(k2_calls) == 4,
          f"dense frame made {len(k1_calls)} K1 and {len(k2_calls)} K2 calls")
    bvh_d, prim_rays, eps = k1_calls[0][0][:3]
    bounce_rays = k1_calls[1][0][1]
    gen = torch.Generator(device="cpu").manual_seed(0)
    live = (bounce_rays.origin[:, 0] < 1e29).nonzero().squeeze(1).cpu()
    pick = live[torch.randperm(live.numel(), generator=gen)[:K1_SAMPLE_BOUNCE]]
    pick = pick.to(prim_rays.origin.device)
    bounce_sample = Rays(bounce_rays.origin[pick].contiguous(),
                         bounce_rays.direction[pick].contiguous())
    log(f"  K1 dense bounce sample: {pick.numel()} of {live.numel()} live "
        f"first-bounce rays")
    errs = [k1_parity("dense primary", bvh_d, prim_rays, eps),
            k1_parity("dense bounce", bvh_d, bounce_sample, eps)]

    l_calls, _ = capture(*frames["large"])
    bvh_l, rays_l = l_calls[0][0][:2]
    pick = torch.randperm(rays_l.origin.shape[0], generator=gen)[
        :K1_SAMPLE_LARGE].to(rays_l.origin.device)
    large_sample = Rays(rays_l.origin[pick].contiguous(),
                        rays_l.direction[pick].contiguous())
    log(f"  K1 large sample: {K1_SAMPLE_LARGE} of {rays_l.origin.shape[0]} "
        f"primary rays, {bvh_l.n_leaves} leaves")
    errs.append(k1_parity("large primary", bvh_l, large_sample, eps))

    ms = cuda_ms(lambda: traverse_cuda.traverse(bvh_d, prim_rays, eps))
    plain_ms = cuda_ms(lambda: plain.traverse(bvh_d, prim_rays, eps))
    ms_l = cuda_ms(lambda: traverse_cuda.traverse(bvh_l, large_sample, eps))
    plain_ms_l = cuda_ms(lambda: plain.traverse(bvh_l, large_sample, eps))
    log(f"  K1 time, dense primary ({prim_rays.origin.shape[0]} rays): "
        f"{ms:.3f} ms vs plain {plain_ms:.3f} ms; large sample: "
        f"{ms_l:.3f} ms vs plain {plain_ms_l:.3f} ms")
    result["K1"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms)

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
        log(f"  K2 {what} {tuple(tbl.shape)} x {idx.numel()} ids: exact; "
            f"{t:.3f} ms vs plain {tp:.3f} ms")
        k2[what] = (err, t, tp)
    _, t, tp = k2["leaf_attrs f32"]
    result["K2"] = dict(max_abs_err=max(v[0] for v in k2.values()),
                        ms=t, plain_ms=tp)
    return result


def hit_rate(img, cfg):
    bg = torch.tensor(cfg.background, device=img.device)
    return 1.0 - float((img - bg).abs().lt(1e-6).all(-1).float().mean())


def phase_main_path(frames):
    """The frames through render_frame; returns the launch counts."""
    from raytracebvh_tpu_torch import render_frame
    from raytracebvh_tpu_torch.ops import gather_cuda, traverse_cuda

    images = {}
    traverse_cuda.launches = gather_cuda.launches = 0
    traverse_cuda.reset_truncated()
    for name, (scene, cam, cfg) in frames.items():
        k1_0, k2_0 = traverse_cuda.launches, gather_cuda.launches
        with torch.inference_mode():
            img = render_frame(scene, cam, cfg)
        torch.cuda.synchronize()
        images[name] = img
        d1 = traverse_cuda.launches - k1_0
        d2 = gather_cuda.launches - k2_0
        rate = hit_rate(img, cfg)
        log(f"  {name}: {tuple(img.shape)}, hit rate {rate:.4f}, "
            f"K1 launches {d1}, K2 launches {d2}")
        check(tuple(img.shape) == (H, W, 4), f"{name}: image shape")
        check(bool(torch.isfinite(img).all()), f"{name}: non-finite pixels")
        check(rate > 0, f"{name}: no ray hit")
        check(d1 > 0 and d2 > 0, f"{name}: a kernel was not launched")
    launches = {"K1": traverse_cuda.launches, "K2": gather_cuda.launches}
    trunc = traverse_cuda.truncated_rays()
    log(f"  main path launches: {launches}, truncated rays {trunc}")
    check(trunc == 0, f"{trunc} rays cut by the step cap on the main path")

    for name, (scene, cam, cfg) in frames.items():
        with torch.inference_mode():
            ms = wall_ms(lambda: render_frame(scene, cam, cfg))
        rays = W * H * (1 + cfg.bounces)
        log(f"  {name}: {ms:.2f} ms/frame, {rays / max(ms, 1e-9) / 1e3:.2f} Mrays/s "
            f"({rays} rays)")

    scene, cam, cfg = frames["dense"]
    plain_cfg = cfg.replace(traversal_backend="torch",
                            shade_gather_backend="torch",
                            texture_gather_backend="torch")
    with torch.inference_mode():
        ref = render_frame(scene, cam, plain_cfg)
        ms = wall_ms(lambda: render_frame(scene, cam, plain_cfg), reps=1)
    diff = (images["dense"] - ref).abs().amax(-1)
    frac = float(diff.le(1e-4).float().mean())
    log(f"  dense vs plain PyTorch render: max |diff| {float(diff.max()):.3g}, "
        f"{frac:.6f} of pixels within 1e-4; plain render {ms:.1f} ms/frame")
    check(frac >= MATCH_MIN, f"dense image: only {frac} of pixels match")
    return launches


def write_obj_scene(scene, directory):
    """The scene as OBJ + MTL + a BMP texture (one material per scene
    material, textured by texture 0)."""
    from raytracebvh_tpu_torch.io.bmp import write_bmp

    verts = scene.verts.cpu().numpy()
    normals = scene.normals.cpu().numpy()
    uv = scene.uv.cpu().numpy()
    faces = scene.indices.cpu().numpy().reshape(-1, 3) + 1
    mat = scene.mat_index.cpu().numpy()
    m = scene.materials
    hw = scene.tex_hw[0].tolist()
    write_bmp(os.path.join(directory, "checker.bmp"),
              scene.textures[0, :hw[0], :hw[1], :3].cpu().numpy())
    with open(os.path.join(directory, "scene.mtl"), "w") as f:
        for k in range(m.count):
            f.write(f"newmtl m{k}\n")
            for key, arr in (("Ka", m.ambient), ("Kd", m.diffuse),
                             ("Ks", m.specular)):
                f.write(f"{key} " + " ".join(
                    repr(float(x)) for x in arr[k, :3]) + "\n")
            f.write(f"Ns {float(m.shininess[k])!r}\nmap_Kd checker.bmp\n")
    lines = ["mtllib scene.mtl"]
    lines += [f"v {x!r} {y!r} {z!r}" for x, y, z in verts.tolist()]
    lines += [f"vt {u!r} {1.0 - v!r}" for u, v in uv.tolist()]
    lines += [f"vn {x!r} {y!r} {z!r}" for x, y, z in normals.tolist()]
    cur = None
    for f_, k in zip(faces.tolist(), mat.tolist()):
        if k != cur:
            lines.append(f"usemtl m{k}")
            cur = k
        lines.append("f " + " ".join(f"{i}/{i}/{i}" for i in f_))
    path = os.path.join(directory, "scene.obj")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def phase_cli(scene, device):
    from raytracebvh_tpu_torch.cli import render as cli
    from raytracebvh_tpu_torch.io.bmp import read_bmp

    with tempfile.TemporaryDirectory() as tmp:
        obj = write_obj_scene(scene, tmp)
        out = os.path.join(tmp, "out.bmp")
        t0 = time.perf_counter()
        rc = cli.main(["--obj", obj, "--width", str(W), "--height", str(H),
                       "--bounces", "1", "--frames", "3", "--out", out,
                       "--device", device])
        dt = time.perf_counter() - t0
        check(rc == 0, f"cli exited {rc}")
        check(os.path.isfile(out), "cli wrote no image")
        img = read_bmp(out)
        log(f"  cli: exit {rc}, wrote {img.shape[1]}x{img.shape[0]} BMP in "
            f"{dt:.1f} s, {int((img != 128).any(-1).sum())} non-background "
            f"pixels")
        check(img.shape == (H, W, 3), f"cli image shape {img.shape}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi unavailable ({e})"
    log(f"phase 1 device: {name}; torch {torch.__version__}, CUDA "
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
    frames = frames_on(dev)
    try:
        log("phase 3 kernels against their plain versions:")
        kern = phase_kernels(frames)
        log("phase 4 main path:")
        launches = phase_main_path(frames)
        log("phase 5 cli:")
        phase_cli(frames["dense"][0], dev.type)
    except SmokeFailure as e:
        log(f"FAILED: {e}")
        return 1
    sources = {"K1": ("raytracebvh_tpu_torch/csrc/traverse.cu",
                      "raytracebvh_tpu/ops/traverse_hbm.py:652"),
               "K2": ("raytracebvh_tpu_torch/csrc/gather.cu",
                      "raytracebvh_tpu/ops/gather_hbm.py:180")}
    log(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=sources[k][0],
             replaces=sources[k][1], launches=launches[k], **kern[k])
        for k in ("K1", "K2")]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
