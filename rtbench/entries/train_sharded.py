"""Entry 'train_sharded': the inverse-rendering step across chips, one
process a chip: ``parallel.render.train_step_sharded`` on a ('rays', 'geo')
mesh (each rank builds the whole tree, traces its block of image rows,
and the loss and gradients are all-reduced over the mesh), then the same
Adam update on every rank; the loss read on the host every
``read_every`` steps.  The target and the check are the 'train' entry's;
every rank checks its own all-reduced gradients and update, and the worst
rank's numbers are the run's.  The process group outlives the run
(``run.py`` ends it)."""

from __future__ import annotations

import statistics

import torch
import torch.distributed as dist

from rtbench import compare, scenes
from rtbench.entries import train
from rtbench.entries.frame import render_config, sync
from rtbench.harness import closed_steps


def window(run) -> None:
    from raytracebvh_tpu_torch.config import traversal_passes
    from raytracebvh_tpu_torch.models import inverse
    from raytracebvh_tpu_torch.parallel import mesh as pmesh
    from raytracebvh_tpu_torch.parallel.render import train_step_sharded

    dev, tr = run.device, run.traffic
    pmesh.initialize_distributed(device=dev.type,
                                 init_method=run.init_method,
                                 timeout_s=tr["collective_timeout_s"])
    mesh = pmesh.make_mesh(geo=tr["mesh"]["geo"], device=dev.type)
    cfg = render_config(run)
    rcfg = compare.ref_cfg(cfg)
    raw = scenes.make_scene(run.config, run.seed, dev)
    cam = scenes.camera(run.config, dev)
    target = train.make_target(run, raw, cam, rcfg)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    scene, pcam = scenes.port_scene(raw), scenes.port_camera(cam)
    params = inverse.init_params(scene)
    lr = tr["lr"]
    opt = inverse.make_optimizer(params, lr, capturable=dev.type == "cuda")
    # every chip's rays count: the whole frame's passes a step
    run.rays_per_iteration = cfg.width * cfg.height * traversal_passes(cfg)

    def step(_=None):
        loss, grads = train_step_sharded(params, inverse.apply_params, scene,
                                         pcam, target, cfg, mesh)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        return loss

    got, start = train.first_steps(step, params, opt)
    run.mark_setup()
    if run.trace:
        snaps = train.traced_steps(run, step, params)
    else:
        snaps = []
        run.iterations, run.window_s = closed_steps(
            step, run.seconds, tr["read_every"], run.ends)
        run.ends_per = tr["read_every"]
    sync(dev)
    if dev.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated(dev)
    shards = run.world // tr["mesh"]["geo"]
    rows = cfg.height // shards
    block = run.rank // tr["mesh"]["geo"]
    mine = torch.arange(block * rows * cfg.width,
                        (block + 1) * rows * cfg.width, device=dev)
    # every rank's peak, and its traced busy and wall time
    mine_info = {"peak": run.peak_bytes,
                 "busy": run.traced.busy_s() if run.trace else None,
                 "wall": run.traced.wall_s if run.trace else None}
    every = [None] * run.world
    dist.all_gather_object(every, mine_info)
    run.peak_bytes = max(i["peak"] for i in every)
    if run.trace:
        run.busy_s = statistics.fmean(i["busy"] for i in every)
        run.traced_s = statistics.fmean(i["wall"] for i in every)
    run.state.update(got=got, start=start, raw=raw, cam=cam, rcfg=rcfg,
                     target=target, opt=opt, params=params, mesh=mesh)
    run.layer.update(
        gather_passes=train.gather_passes_of(raw, cam, rcfg, snaps, mine),
        texture_bytes=(raw["textures"].numel()
                       * (1 if cfg.texture_dtype == "uint8" else 4)),
        refraction=cfg.enable_refraction)


def verify(run) -> None:
    from raytracebvh_tpu_torch.parallel import mesh as pmesh

    pmesh.mesh_graphs(run.state.pop("mesh")).clear()
    train.free_program(run)
    st = run.state
    want = compare.reference_steps(st["raw"], st["cam"], st["rcfg"],
                                   st["target"], st["start"],
                                   run.traffic["lr"], train.CHECK_STEPS)
    st["want"] = want
    numbers = compare.train_numbers(st["got"], want)
    every = [None] * run.world
    dist.all_gather_object(every, numbers)
    limits = run.traffic["check"]["limits"]
    for rank_numbers in every:
        for name, value in rank_numbers.items():
            run.check.worst(name, value, limits[name])
