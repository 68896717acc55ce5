"""CLI: inverse-rendering training loop with checkpoint/resume, on the
PyTorch + CUDA port (the JAX package's ``cli/train.py``: the same flags,
the same printed lines, checkpoints either package can resume).

Optimizes vertex offsets + material colors so the render matches a
target image.

Usage:
    python -m raytracebvh_tpu_torch.cli.train [--obj Test.obj]
        [--target target.bmp | --self-target] [--steps 200] [--lr 1e-2]
        [--width 128 --height 128] [--ckpt ckpt.npz] [--ckpt-every 50]
        [--out recon.bmp] [--device cuda|cpu]

--self-target renders the unmodified scene as the target, then perturbs
the start params (the JAX CLI's perturbation, from the same numpy seed) —
a self-contained convergence demo needing no files.  It trains on the
CUDA device unless ``--device cpu`` asks for the CPU; without a CUDA
device it exits 1.  The target and final renders go through
``render_frame_jit`` and the steps through ``train_step_jit``, as the
JAX CLI's go through ``jax.jit``: on the card each is a CUDA graph,
captured once and replayed (Adam is made ``capturable`` there, and
``--lr`` is written into its device learning rate).
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--obj", default="Test.obj")
    p.add_argument("--target", default=None, help="target image (BMP/PNG)")
    p.add_argument("--self-target", action="store_true")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--height", type=int, default=128)
    p.add_argument("--bounces", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt", default=None, help="checkpoint path (.npz)")
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--out", default=None, help="write final render here")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to train (default cuda; exits 1 when no "
                        "CUDA device is visible)")
    args = p.parse_args(argv)

    import os

    import numpy as np
    import torch

    from raytracebvh_tpu_torch import Camera, RenderConfig, render_frame_jit
    from raytracebvh_tpu_torch.io.obj import load_obj
    from raytracebvh_tpu_torch.models.inverse import (
        InverseParams,
        adam_state,
        init_params,
        make_optimizer,
        optimizer_from_numpy,
        params_from_numpy,
        train_step_jit,
    )
    from raytracebvh_tpu_torch.utils.assets import find_asset
    from raytracebvh_tpu_torch.utils.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )

    device = args.device
    if device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device is visible (pass --device cpu to "
              "train on the CPU)", file=sys.stderr)
        return 1
    path = args.obj if os.path.isfile(args.obj) else find_asset(args.obj)
    if path is None:
        print(f"error: cannot find {args.obj}", file=sys.stderr)
        return 1
    scene = load_obj(path, device=device)
    cfg = RenderConfig(width=args.width, height=args.height,
                       bounces=args.bounces)
    cam = Camera.default(device)

    if args.self_target or args.target is None:
        with torch.no_grad():
            target = render_frame_jit(scene, cam, cfg)
    else:
        from raytracebvh_tpu_torch.io.image import load_texture

        img = load_texture(args.target)  # [H, W, 4] in [0,1]
        if img.shape[:2] != (args.height, args.width):
            print(
                f"error: target is {img.shape[1]}x{img.shape[0]}, "
                f"expected {args.width}x{args.height}",
                file=sys.stderr,
            )
            return 1
        target = torch.as_tensor(img, device=device)

    params = init_params(scene)
    if args.self_target:
        # perturb the start so there is something to recover
        rng = np.random.default_rng(args.seed)
        params = params_from_numpy(InverseParams(
            vert_offsets=rng.normal(
                0, 0.5, tuple(params.vert_offsets.shape)).astype(np.float32),
            diffuse=params.diffuse.detach().cpu().numpy() * 0.5,
            specular=params.specular.detach().cpu().numpy(),
        ), device)
    capturable = device == "cuda"
    opt = make_optimizer(params, args.lr, capturable)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    step0 = 0
    if args.ckpt:
        restored = restore_checkpoint(
            args.ckpt, (params, adam_state(opt, params), step0)
        )
        if restored is not None:
            p_np, s_np, step0 = restored
            params = params_from_numpy(p_np, device)
            opt = optimizer_from_numpy(params, s_np, args.lr, device,
                                       capturable)
            print(f"resumed from {args.ckpt} at step {step0}")

    sync()
    t0 = time.perf_counter()
    loss = None
    for step in range(step0, args.steps):
        loss = train_step_jit(params, opt, scene, cam, target, cfg, args.lr)
        if (step + 1) % args.log_every == 0:
            print(f"step {step + 1}/{args.steps}  loss {float(loss):.6e}")
        if args.ckpt and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt,
                            (params, adam_state(opt, params), step + 1))
    if loss is not None:
        sync()
        dt = time.perf_counter() - t0
        n = args.steps - step0
        print(f"trained {n} steps in {dt:.2f}s "
              f"({n / max(dt, 1e-9):.2f} steps/s), final loss {float(loss):.6e}")
    if args.ckpt:
        save_checkpoint(args.ckpt,
                        (params, adam_state(opt, params), args.steps))

    if args.out:
        from raytracebvh_tpu_torch.io.bmp import write_bmp
        from raytracebvh_tpu_torch.models.inverse import apply_params

        with torch.no_grad():
            img = render_frame_jit(apply_params(params, scene), cam, cfg)
        write_bmp(args.out, img.float().cpu().numpy())
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
