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
memory and K1 above, and on the CPU the plain walk.
"""

from __future__ import annotations

import numpy as np
import torch

from ..camera import camera_matrices
from ..config import RenderConfig
from ..core.types import Camera, Rays, Scene
from ..pipeline import _traverse_ids, build_bvh

MISS_RGB = np.array([0, 0, 255], np.uint8)  # char3(255,0,0) in BMP order


def render_depth_bmp(
    scene: Scene, width: int = 500, height: int = 500, stride: int = 1
) -> np.ndarray:
    """Render the TestData.cpp depth image on the scene's device; returns
    [H/stride, W/stride, 3] uint8 in the same top-down row order
    ``io.bmp.read_bmp`` yields for the committed artifact.

    ``stride`` subsamples the pixel grid (valid because the rays are
    orthographic and independent) so the comparison stays cheap on CPU.
    """
    device = scene.verts.device
    cam = Camera.default(device)
    cfg = RenderConfig(width=width, height=height, bounces=0, ortho_scale=1.0)
    wvp, wv = camera_matrices(cam, width, height)

    xs = torch.arange(0, width, stride, dtype=torch.float32, device=device)
    ys = torch.arange(0, height, stride, dtype=torch.float32, device=device)
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    origin = torch.stack(
        [gx - width // 2, gy - height // 2, torch.zeros_like(gx)], dim=-1
    ).reshape(-1, 3)
    direction = torch.tensor([0.0, 0.0, 1.0], device=device).expand(
        origin.shape).contiguous()

    with torch.no_grad():
        bvh = build_bvh(scene, wvp, wv, cfg)
        rec = _traverse_ids(bvh, Rays(origin=origin, direction=direction), cfg)
    h, w = len(ys), len(xs)
    hit = rec.hit.cpu().numpy().reshape(h, w)
    dist = np.where(hit, rec.distance.float().cpu().numpy().reshape(h, w), 0)
    # char(distance): float -> int truncation, low byte (TestData.cpp:840)
    gray = (dist.astype(np.int32) & 0xFF).astype(np.uint8)
    img = np.where(
        hit[..., None], np.repeat(gray[..., None], 3, axis=-1), MISS_RGB
    )
    # SaveBMP stores the y-up buffer bottom-up; read back top-down the
    # artifact is vertically flipped relative to our row order.
    return img[::-1]


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
