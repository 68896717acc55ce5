"""Entry 'train': the train CLI's loop (``cli/train.py``): steps of
``models.inverse.train_step_jit`` (loss, backward, Adam) back to back on one
optimizer, the loss read on the host every ``read_every`` steps, as the
CLI's log line reads it.

The target is the reference's frame of the scene with seeded perturbed
parameters (``scenes.perturbed``), made once in set-up, so the loss has a
real optimum.  Set-up drives the step through its first three steps (the
first captures its graph); they are what is checked: each step's loss,
the first gradient (from Adam's first moment after one step) and the
parameters' change after three, against the reference's three steps from
the same start."""

from __future__ import annotations

import gc
import time

import torch

from rtbench import compare, scenes, tracing
from rtbench.entries.frame import render_config, stage_times, sync
from rtbench.harness import closed_steps
from rtbench.reference import render as ref_render

LEAVES = compare.LEAVES
CHECK_STEPS = 3


def make_target(run, raw: dict, cam: dict, rcfg: dict):
    """The target frame: the reference's render of the scene under the
    seeded perturbed parameters.  Its seconds are the reference's, and
    are left out of ``setup_s``."""
    t0 = time.perf_counter()
    params = scenes.perturbed(raw, run.traffic["target"], run.seed)
    with torch.no_grad():
        img = ref_render.render(raw, cam, rcfg, offsets=params["vert_offsets"],
                                materials={"diffuse": params["diffuse"],
                                           "specular": params["specular"]})
    sync(run.device)
    run.reference_s += time.perf_counter() - t0
    return img


def leaves(params) -> dict:
    return {k: getattr(params, k) for k in LEAVES}


def first_steps(step, params, opt) -> dict:
    """Runs ``step()`` ``CHECK_STEPS`` times: each step's loss, the first
    gradient as Adam holds it after one step, and the parameters' change
    after the last."""
    start = {k: v.detach().clone() for k, v in leaves(params).items()}
    got = {"losses": []}
    for s in range(CHECK_STEPS):
        got["losses"].append(float(step()))
        if s == 0:
            b1 = opt.param_groups[0]["betas"][0]
            # an optimizer that made no state holds zero moments
            got["grads"] = {
                k: opt.state[p].get("exp_avg", torch.zeros_like(p)).detach()
                / (1 - b1) for k, p in leaves(params).items()}
    got["change"] = {k: v.detach() - start[k]
                     for k, v in leaves(params).items()}
    return got, start


def traced_steps(run, step, params):
    """The traced window, with the parameters each traced step starts from
    (three small copies a step, inside the window)."""
    snaps = []

    def one(_):
        snaps.append({k: v.detach().clone()
                      for k, v in leaves(params).items()})
        step()

    run.iterations = run.traffic["trace_iterations"]
    run.traced = tracing.traced(one, run.iterations)
    return snaps


def gather_passes_of(raw, cam, rcfg, snaps, pixels=None):
    def passes():
        out = []
        for p in snaps:
            stats = []
            with torch.no_grad():
                ref_render.render_pixels(
                    raw, cam, rcfg, pixels=pixels,
                    offsets=p["vert_offsets"],
                    materials={"diffuse": p["diffuse"],
                               "specular": p["specular"]},
                    stats=stats, shadows=False)
            out.append(stats)
        return out
    return passes


def window(run) -> None:
    from raytracebvh_tpu_torch.config import traversal_passes
    from raytracebvh_tpu_torch.models import inverse

    dev, tr = run.device, run.traffic
    cfg = render_config(run)
    rcfg = compare.ref_cfg(cfg)
    raw = scenes.make_scene(run.config, run.seed, dev)
    cam = scenes.camera(run.config, dev)
    target = make_target(run, raw, cam, rcfg)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    scene, pcam = scenes.port_scene(raw), scenes.port_camera(cam)
    params = inverse.init_params(scene)
    lr = tr["lr"]
    opt = inverse.make_optimizer(params, lr, capturable=dev.type == "cuda")
    run.rays_per_iteration = cfg.width * cfg.height * traversal_passes(cfg)

    def step(_=None):
        return inverse.train_step_jit(params, opt, scene, pcam, target, cfg,
                                      lr)

    got, start = first_steps(step, params, opt)
    run.mark_setup()
    if run.trace:
        snaps = traced_steps(run, step, params)
    else:
        snaps = []
        run.iterations, run.window_s = closed_steps(
            step, run.seconds, tr["read_every"], run.ends)
        run.ends_per = tr["read_every"]
    sync(dev)
    if dev.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated(dev)
    run.state.update(got=got, start=start, raw=raw, cam=cam, rcfg=rcfg,
                     target=target, opt=opt, params=params)
    run.layer.update(
        gather_passes=gather_passes_of(raw, cam, rcfg, snaps),
        texture_bytes=(raw["textures"].numel()
                       * (1 if cfg.texture_dtype == "uint8" else 4)),
        refraction=cfg.enable_refraction,
        stage_times=lambda: stage_times(scene, pcam, cfg))


def free_program(run) -> None:
    """Drops the optimizer, with the step graphs it holds, and any frame
    graph a reader captured."""
    from raytracebvh_tpu_torch import pipeline

    pipeline.FRAME_GRAPHS.clear()
    for k in ("opt", "params"):
        run.state.pop(k, None)
    run.layer.clear()
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def verify(run) -> None:
    free_program(run)
    st = run.state
    want = compare.reference_steps(st["raw"], st["cam"], st["rcfg"],
                                   st["target"], st["start"],
                                   run.traffic["lr"], CHECK_STEPS)
    st["want"] = want
    numbers = compare.train_numbers(st["got"], want)
    limits = run.traffic["check"]["limits"]
    for name, value in numbers.items():
        run.check.add(name, value, limits[name])
