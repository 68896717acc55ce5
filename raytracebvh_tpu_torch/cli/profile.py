"""CLI: per-stage pipeline timing breakdown on the PyTorch + CUDA port
(the JAX package's ``cli/profile.py``).

Usage:
    python -m raytracebvh_tpu_torch.cli.profile [--obj Test.obj]
        [--width 512] [--height 512] [--bounces 1]
        [--backend auto|torch|cuda|shared] [--sort lax|bitonic|radix]
        [--ray-chunk 0] [--iters 5] [--trace DIR] [--device cuda|cpu]

It profiles on the CUDA device unless ``--device cpu`` asks for the CPU;
without a CUDA device it exits 1.  ``--backend`` is the traversal
backend (``cli.render``'s names); ``--sort bitonic`` times kernel K8 in
the sort stage.  ``--trace DIR`` also writes a Chrome trace of one frame
(``torch.profiler``) into DIR: a replay of ``render_frame_jit``'s graph
on the card (captured before the trace), as the JAX CLI traces its
jitted frame.  On the card each stage of the table is its own CUDA graph,
timed over its replays, as the JAX CLI jits each stage alone
(``utils.profiling.stage_times``); on the CPU the stages run eagerly.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--obj", default="Test.obj")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--bounces", type=int, default=1)
    p.add_argument("--backend", choices=["auto", "torch", "cuda", "shared"],
                   default="auto",
                   help="traversal backend (same choices as cli.render)")
    p.add_argument("--sort", choices=["lax", "bitonic", "radix"],
                   default="lax")
    p.add_argument("--ray-chunk", type=int, default=0)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--trace", default=None,
                   help="also write a torch.profiler Chrome trace of one "
                        "frame into this dir")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to profile (default cuda; exits 1 when no "
                        "CUDA device is visible)")
    args = p.parse_args(argv)

    import os

    import torch

    from raytracebvh_tpu_torch import Camera, RenderConfig, render_frame_jit
    from raytracebvh_tpu_torch.io.obj import load_obj
    from raytracebvh_tpu_torch.utils.assets import find_asset
    from raytracebvh_tpu_torch.utils.profiling import (
        print_stage_times,
        stage_times,
        trace,
    )

    device = args.device
    if device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device is visible (pass --device cpu to "
              "profile on the CPU)", file=sys.stderr)
        return 1
    path = args.obj if os.path.isfile(args.obj) else find_asset(args.obj)
    if path is None:
        print(f"error: cannot find {args.obj}", file=sys.stderr)
        return 1
    scene = load_obj(path, device=device)
    cfg = RenderConfig(
        width=args.width, height=args.height, bounces=args.bounces,
        traversal_backend=args.backend, sort_backend=args.sort,
        ray_chunk=args.ray_chunk,
    )
    cam = Camera.default(device)
    times = stage_times(scene, cam, cfg, iters=args.iters)
    print_stage_times(times, cfg)
    if args.trace:
        with torch.no_grad():
            render_frame_jit(scene, cam, cfg)  # the capture, untraced
            with trace(args.trace) as trace_path:
                render_frame_jit(scene, cam, cfg)
        print(f"trace written to {trace_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
