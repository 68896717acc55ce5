"""Entry 'spd_frame': the loop of entry 'frame' (the render CLI's ``--sync``
loop: one frame in flight, the camera orbiting, the objects moved every
frame so the tree is rebuilt from new geometry) on a scene of Haines'
Standard Procedural Databases (``scenes_spd.make_scene``).  Only the
scene's maker differs from 'frame', whose ``window`` makes its scene with
``scenes.make_scene``; the rest is 'frame''s, by import.

Checked as 'frame' checks (``frame.verify``): a sample of the window's
frames, a sample of each one's pixels, against the reference."""

from __future__ import annotations

import random

import torch

from rtbench import compare, scenes, scenes_spd, tracing
from rtbench.entries.frame import (Reservoir, render_config, stage_times,
                                   sync, verify)
from rtbench.harness import closed_frames
from rtbench.reference import render as ref_render

__all__ = ["window", "verify"]


def window(run) -> None:
    from raytracebvh_tpu_torch import render_frame_jit
    from raytracebvh_tpu_torch.config import traversal_passes

    dev, tr = run.device, run.traffic
    cfg = render_config(run)
    raw = scenes_spd.make_scene(run.config, run.seed, dev)
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
        """The passes' (hits, distinct faces hit) of the traced frames,
        from the reference's primary raster (no bounce: the shadow rays
        gather nothing)."""
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
