"""Entry 'frame': the render CLI's interactive loop (``cli/render.py
--sync``).  One frame in flight: each call to ``render_frame_jit`` is
followed by a synchronize that presents the frame.  The camera orbits its
look-at point by ``orbit_yaw`` a frame, and the scene moves every frame:
frame i takes pose i of a ring of seeded rigid offsets of the spheres
(``scenes.pose_ring``), copied in as the caller's scene, so the program
rebuilds its tree from new geometry each frame, as it exists to.

Checked: a sample of the window's frames (a reservoir drawn from the
seed), a sample of each one's pixels, against the reference."""

from __future__ import annotations

import gc
import random

import torch

from rtbench import compare, scenes, tracing
from rtbench.harness import closed_frames
from rtbench.reference import render as ref_render


class Reservoir:
    """``k`` items drawn uniformly from all items offered (algorithm R)."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = item


def render_config(run):
    from raytracebvh_tpu_torch import RenderConfig

    conf = run.config
    return RenderConfig(width=conf["width"], height=conf["height"],
                        ortho_scale=conf["ortho_scale"],
                        **run.traffic["render"])


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def window(run) -> None:
    from raytracebvh_tpu_torch import render_frame_jit
    from raytracebvh_tpu_torch.config import traversal_passes

    dev, tr = run.device, run.traffic
    cfg = render_config(run)
    raw = scenes.make_scene(run.config, run.seed, dev)
    cam = scenes.camera(run.config, dev)
    ring = scenes.pose_ring(raw, tr["poses"], tr["pose_jitter"], run.seed)
    eyes = scenes.orbit_eyes(cam, tr["orbit_yaw"], tr["orbit_frames"])
    base, pcam = scenes.port_scene(raw), scenes.port_camera(cam)
    run.rays_per_iteration = cfg.width * cfg.height * traversal_passes(cfg)
    kept = Reservoir(tr["check"]["frames"],
                     random.Random(scenes.sub_seed(run.seed, "frames")))
    count = [0]

    def frame(_):
        i = count[0]
        count[0] += 1
        img = render_frame_jit(base.replace(verts=ring[i % len(ring)]),
                               pcam.replace(eye=eyes[i % len(eyes)]), cfg)
        sync(dev)
        kept.offer((i, img))

    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode():
        for _ in range(tr["warmup"]):
            frame(0)
        kept.items.clear()
        kept.seen = 0
        first = count[0]
        run.mark_setup()
        if run.trace:
            run.iterations = tr["trace_iterations"]
            run.traced = tracing.traced(frame, run.iterations)
        else:
            run.latencies, run.window_s = closed_frames(frame, run.seconds,
                                                        run.ends)
            run.iterations = len(run.latencies)
    if dev.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated(dev)
    rcfg = compare.ref_cfg(cfg)

    def inputs(i):
        return (dict(raw, verts=ring[i % len(ring)]),
                dict(cam, eye=eyes[i % len(eyes)]))

    def gather_passes():
        out = []
        for i in range(first, count[0]):
            stats = []
            with torch.no_grad():
                ref_render.render_pixels(*inputs(i), rcfg, stats=stats,
                                         shadows=False)
            out.append(stats)
        return out

    run.state.update(kept=kept, inputs=inputs, rcfg=rcfg)
    run.layer.update(
        gather_passes=gather_passes,
        texture_bytes=(raw["textures"].numel()
                       * (1 if cfg.texture_dtype == "uint8" else 4)),
        refraction=cfg.enable_refraction,
        stage_times=lambda: stage_times(base, pcam, cfg))


def stage_times(scene, camera, cfg) -> dict:
    from raytracebvh_tpu_torch.utils.profiling import stage_times as times

    return times(scene, camera, cfg)


def verify(run) -> None:
    """Frees the program's graphs, then holds the kept frames to the
    reference."""
    from raytracebvh_tpu_torch import pipeline

    pipeline.FRAME_GRAPHS.clear()
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    chk = run.traffic["check"]
    gen = torch.Generator().manual_seed(scenes.sub_seed(run.seed, "pixels"))
    rcfg = run.state["rcfg"]
    total = rcfg["width"] * rcfg["height"]
    bad = seen = 0
    with torch.no_grad():
        for i, img in run.state["kept"].items:
            scene, cam = run.state["inputs"](i)
            pix = compare.sample_pixels(gen, chk["pixels"], total,
                                        run.device)
            b, n = compare.bad_pixels(img, scene, cam, rcfg, pix,
                                      chk["pixel_tol"])
            bad, seen = bad + b, seen + n
    share = bad / seen if seen else float("nan")
    run.check.add("px_bad_share", share, chk["limits"]["px_bad_share"])
