"""CLI: render a scene to a BMP/PNG with the PyTorch + CUDA port.

Usage:
    python -m raytracebvh_tpu_torch.cli.render [--obj Obj/Test.obj]
        [--out out.bmp] [--width 800] [--height 800] [--bounces 3]
        [--frames 1] [--orbit-yaw 0.1] [--device cuda|cpu]
        [--backend auto|torch|cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _auto_ray_chunk(width: int, height: int) -> int:
    """The largest frame divisor <= 32768 that keeps >= 4 chunks, or 0
    when that is under 1024 rays (too fine to pay for the culling)."""
    r = width * height
    for c in range(min(32768, r // 4), 1023, -1):
        if r % c == 0:
            return c
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--obj", default="Test.obj",
                   help="OBJ file path or asset name")
    p.add_argument("--out", default="out.bmp")
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--bounces", type=int, default=3)
    p.add_argument("--frames", type=int, default=1,
                   help="render N frames, orbiting the camera (FPS meter)")
    p.add_argument("--orbit-yaw", type=float, default=0.1,
                   help="per-frame yaw in radians")
    p.add_argument("--chunk", type=int, default=0,
                   help="traversal chunk size (torch traversal only)")
    p.add_argument("--ray-chunk", type=int, default=-1,
                   help="shade-pipeline chunk size (enables chunk-level "
                        "empty culling; -1 = auto: the largest frame "
                        "divisor <= 32768 keeping >= 4 chunks, else 0)")
    p.add_argument("--camera", choices=["reference", "perspective"],
                   default="reference")
    p.add_argument("--backend", choices=["auto", "torch", "cuda"],
                   default="auto",
                   help="traversal and gather backend (auto: the CUDA "
                        "kernels on a GPU, plain PyTorch on the CPU)")
    p.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="where to render (default: cuda when a GPU is "
                        "visible, else cpu)")
    p.add_argument("--refract", action="store_true",
                   help="enable the refraction pass (not ported yet)")
    p.add_argument("--shadows", action="store_true",
                   help="fire shadow rays at --light (not ported yet)")
    p.add_argument("--light", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "Z"),
                   help="world-space light position for --shadows")
    p.add_argument("--metrics", default=None,
                   help="append per-frame metrics as JSONL to this file "
                        "(implies --sync)")
    p.add_argument("--sync", action="store_true",
                   help="block on every frame (accurate per-frame "
                        "metrics).  Default is a pipelined loop: the host "
                        "enqueues frames ahead and drains the device "
                        "queue about once a second")
    args = p.parse_args(argv)

    import torch

    from raytracebvh_tpu_torch import Camera, RenderConfig, render_frame
    from raytracebvh_tpu_torch.camera import orbit
    from raytracebvh_tpu_torch.io.bmp import write_bmp
    from raytracebvh_tpu_torch.io.obj import load_obj
    from raytracebvh_tpu_torch.utils.assets import find_asset

    device = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    if device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but no CUDA device is visible",
              file=sys.stderr)
        return 1
    if args.refract or args.shadows:
        print("error: --refract and --shadows are not ported yet",
              file=sys.stderr)
        return 1
    path = args.obj if os.path.isfile(args.obj) else find_asset(args.obj)
    if path is None:
        print(f"error: cannot find {args.obj}", file=sys.stderr)
        return 1
    scene = load_obj(path).to(device)
    ray_chunk = args.ray_chunk
    if ray_chunk < 0:
        ray_chunk = _auto_ray_chunk(args.width, args.height)
    backend = args.backend
    cfg = RenderConfig(
        width=args.width,
        height=args.height,
        bounces=args.bounces,
        ray_chunk=ray_chunk,
        traversal_chunk=args.chunk,
        camera_mode=args.camera,
        traversal_backend=backend,
        shade_gather_backend=backend,
        texture_gather_backend=backend,
        **(dict(light_pos=tuple(args.light)) if args.light else {}),
    )
    cam = Camera.default(device)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    rays_per_frame = cfg.width * cfg.height * (1 + cfg.bounces)
    if args.metrics and not args.sync:
        print("note: --metrics implies --sync (per-frame timing)")
        args.sync = True
    metrics = open(args.metrics, "a") if args.metrics else None
    img = None
    t0 = last_print = last_t = time.perf_counter()
    frames = 0
    try:
        with torch.inference_mode():
            for i in range(args.frames):
                img = render_frame(scene, cam, cfg)
                frames += 1
                if args.sync or args.frames == 1:
                    sync()
                    now = time.perf_counter()
                    if metrics is not None:
                        metrics.write(json.dumps(dict(
                            ts=time.time(), event="frame", frame=i,
                            ms=(now - last_t) * 1e3,
                            mrays_per_sec=rays_per_frame
                            / max(now - last_t, 1e-9) / 1e6)) + "\n")
                    last_t = now
                else:
                    # pipelined: frames stay queued on the device, which
                    # runs them in order; a sync drains everything before
                    now = time.perf_counter()
                if now - last_print >= 1.0:  # once-a-second FPS print
                    if not args.sync:
                        sync()
                        now = time.perf_counter()
                    print(f"FPS: {frames / (now - t0):.2f}")
                    last_print = now
                if args.frames > 1:
                    cam = orbit(cam, args.orbit_yaw, 0.0)
            sync()
    finally:
        if metrics is not None:
            metrics.close()
    dt = time.perf_counter() - t0
    print(f"rendered {args.frames} frame(s) in {dt:.3f}s "
          f"({args.frames / dt:.2f} FPS)")

    arr = img[..., :3].float().cpu().numpy()
    if args.out.lower().endswith((".png", ".jpg", ".jpeg")):
        from PIL import Image
        import numpy as np

        Image.fromarray(
            (np.clip(arr, 0, 1) * 255 + 0.5).astype(np.uint8)).save(args.out)
    else:
        write_bmp(args.out, arr)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
