"""Reproduction of the reference's one committed render artifact (the
JAX package's ``ref/refimage.py``).

``out.bmp`` (500x500) is NOT a shaded frame: it is the depth
visualization written by the CPU golden model's scalar trace (reference:
TestData.cpp:804-851 — ray origin ``(x - w/2, y - h/2, 0)`` with NO ortho
scale, direction (0,0,1), hit pixels = ``char(distance)`` replicated to
gray, misses = ``char3(255,0,0)`` which in BMP byte order is pure blue;
writer SaveBMP.cpp:3-62).  This module renders the same quantity through
the port's pipeline: the LBVH build and the traversal dispatch, so on
CUDA tensors the walk is kernel K5 where the tree fits a block's shared
memory and K1 above, replayed as a CUDA graph, and on the CPU the plain
walk.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import graphs
from ..camera import camera_matrices
from ..config import RenderConfig
from ..core.types import Camera, Rays, Scene
from ..pipeline import _traverse_ids, build_bvh

MISS_RGB = np.array([0, 0, 255], np.uint8)  # char3(255,0,0) in BMP order

# render_depth_bmp's captures on the card, by signature
DEPTH_GRAPHS = graphs.Cache(name="depth")


def _depth_walk(scene: Scene, width: int, height: int, stride: int):
    """The function ``render_depth_bmp`` runs on the scene's device:
    scene -> (hit, distance) of the depth image's rays, the LBVH build,
    the rays and the walk.  The camera's matrices are made here, outside
    the function, so that it captures (a tensor made from host values on
    the card does not)."""
    cam = Camera.default(scene.verts.device)
    cfg = RenderConfig(width=width, height=height, bounces=0, ortho_scale=1.0)
    wvp, wv = camera_matrices(cam, width, height)

    def run(scene: Scene):
        device = scene.verts.device
        xs = torch.arange(0, width, stride, dtype=torch.float32,
                          device=device)
        ys = torch.arange(0, height, stride, dtype=torch.float32,
                          device=device)
        gx, gy = torch.meshgrid(xs, ys, indexing="xy")
        zero = torch.zeros_like(gx)
        origin = torch.stack(
            [gx - width // 2, gy - height // 2, zero], dim=-1).reshape(-1, 3)
        direction = torch.stack([zero, zero, torch.ones_like(gx)],
                                dim=-1).reshape(-1, 3)
        bvh = build_bvh(scene, wvp, wv, cfg)
        rec = _traverse_ids(bvh, Rays(origin=origin, direction=direction),
                            cfg)
        return rec.hit, rec.distance

    return run


def _depth_image(hit, distance, width: int, height: int,
                 stride: int) -> np.ndarray:
    """The BMP pixels of the rays' (hit, distance), on the host."""
    h, w = len(range(0, height, stride)), len(range(0, width, stride))
    hit = hit.cpu().numpy().reshape(h, w)
    dist = np.where(hit, distance.float().cpu().numpy().reshape(h, w), 0)
    # char(distance): float -> int truncation, low byte (TestData.cpp:840)
    gray = (dist.astype(np.int32) & 0xFF).astype(np.uint8)
    img = np.where(
        hit[..., None], np.repeat(gray[..., None], 3, axis=-1), MISS_RGB
    )
    # SaveBMP stores the y-up buffer bottom-up; read back top-down the
    # artifact is vertically flipped relative to our row order.
    return img[::-1]


def render_depth_bmp(
    scene: Scene, width: int = 500, height: int = 500, stride: int = 1
) -> np.ndarray:
    """Render the TestData.cpp depth image on the scene's device; returns
    [H/stride, W/stride, 3] uint8 in the same top-down row order
    ``io.bmp.read_bmp`` yields for the committed artifact.

    ``stride`` subsamples the pixel grid (valid because the rays are
    orthographic and independent) so the comparison stays cheap on CPU.
    On CUDA tensors the build, the rays and the walk are one CUDA graph,
    captured at the first call of its signature (width, height, stride
    and the scene's shapes) and replayed with the scene copied in, as the
    JAX function jits them; the byte conversion runs on the host.  On the
    CPU they run eagerly.
    """
    run = _depth_walk(scene, width, height, stride)
    with torch.no_grad():
        if scene.verts.device.type == "cuda":
            with torch.inference_mode(False):
                graph = DEPTH_GRAPHS.get(
                    graphs.signature((width, height, stride), scene),
                    lambda: graphs.Captured(
                        run, (scene,), DEPTH_GRAPHS.stream(scene.device),
                        **DEPTH_GRAPHS.options()))
            hit, distance = graph(scene)
        else:
            hit, distance = run(scene)
        return _depth_image(hit, distance, width, height, stride)


def compare_images(ours: np.ndarray, ref: np.ndarray):
    """Returns (psnr_db, foreground_iou) between two HxWx3 uint8 images
    that use MISS_RGB as the background key."""
    diff = ours.astype(np.int64) - ref.astype(np.int64)
    mse = float((diff**2).mean())
    psnr = 99.0 if mse == 0 else 10.0 * np.log10(255.0**2 / mse)
    fg_a = ~(ours == MISS_RGB).all(-1)
    fg_b = ~(ref == MISS_RGB).all(-1)
    union = (fg_a | fg_b).sum()
    iou = float((fg_a & fg_b).sum() / max(1, union))
    return psnr, iou
