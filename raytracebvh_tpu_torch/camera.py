"""Camera matrices, ray generation and ray tiling.

The JAX package's ``camera.py`` in torch, op for op: DirectXMath
row-vector conventions (``[p, 1] @ WVP``), no w-divide in 'reference'
mode (tracing happens in pre-divide clip space with orthographic primary
rays), a world-space pinhole in 'perspective' mode.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .core.types import Camera, Rays
from .ops.ieee import div, sqrt
from .ops.shade import cross3, norm3

TILE_ORDERS = ("row", "col")


def _axes(eye, at, up):
    """Unit (x, y, z) camera axes of a left-handed look-at."""
    zaxis = at - eye
    zaxis = zaxis / norm3(zaxis)
    xaxis = torch.stack(cross3(up, zaxis))
    xaxis = xaxis / norm3(xaxis)
    return xaxis, torch.stack(cross3(zaxis, xaxis)), zaxis


def look_at_lh(eye, at, up):
    """Row-vector left-handed look-at, as XMMatrixLookAtLH."""
    xaxis, yaxis, zaxis = _axes(eye, at, up)
    zero = torch.zeros((), dtype=eye.dtype, device=eye.device)
    one = torch.ones((), dtype=eye.dtype, device=eye.device)
    return torch.stack([
        torch.stack([xaxis[0], yaxis[0], zaxis[0], zero]),
        torch.stack([xaxis[1], yaxis[1], zaxis[1], zero]),
        torch.stack([xaxis[2], yaxis[2], zaxis[2], zero]),
        torch.stack([-torch.dot(xaxis, eye), -torch.dot(yaxis, eye),
                     -torch.dot(zaxis, eye), one]),
    ])


def perspective_fov_lh(fov_y, aspect, z_near, z_far):
    """Row-vector left-handed perspective, as XMMatrixPerspectiveFovLH
    (the reference passes aspect = height / width; so must callers)."""
    h = 1.0 / torch.tan(fov_y * 0.5)
    w = h / aspect
    rng = z_far / (z_far - z_near)
    z = torch.zeros_like(h)
    o = torch.ones_like(h)
    return torch.stack([
        torch.stack([w, z, z, z]),
        torch.stack([z, h, z, z]),
        torch.stack([z, z, rng, o]),
        torch.stack([z, z, -rng * z_near, z]),
    ])


def camera_matrices(cam: Camera, width: int, height: int):
    """(wvp, wv) row-vector matrices, world = identity, in the camera's
    dtype and on its device."""
    view = look_at_lh(cam.eye, cam.at, cam.up)
    aspect = div(cam.eye.new_full((), height), width)
    proj = perspective_fov_lh(cam.fov, aspect, cam.near, cam.far)
    return view @ proj, view


def transform_points(points, m):
    """[n, 3] by a 4x4 row-vector transform, xyz kept, NO w-divide.
    Per-column math in the JAX package's operation order (a matmul
    would round differently)."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    cols = [x * m[0, k] + y * m[1, k] + z * m[2, k] + m[3, k]
            for k in range(3)]
    return torch.stack(cols, dim=-1)


def transform_normals(normals, wv):
    """Normals by the 3x3 of worldView (column math, as transform_points)."""
    x, y, z = normals[:, 0], normals[:, 1], normals[:, 2]
    cols = [x * wv[0, k] + y * wv[1, k] + z * wv[2, k] for k in range(3)]
    return torch.stack(cols, dim=-1)


def reference_rays(width: int, height: int, ortho_scale: float,
                   dtype=torch.float32, device="cuda") -> Rays:
    """The reference's orthographic primary rays in clip space: origin
    ((x - w//2) / s, (y - h//2) / s, 0), direction (0, 0, 1), row-major.
    On the CUDA device unless asked for another (without one it raises)."""
    xs = torch.arange(width, dtype=dtype, device=device)
    ys = torch.arange(height, dtype=dtype, device=device)
    hx = torch.full((), width // 2, dtype=dtype, device=device)
    hy = torch.full((), height // 2, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")  # [h, w]
    origin = torch.stack(
        [div(gx - hx, ortho_scale), div(gy - hy, ortho_scale),
         torch.zeros_like(gx)], dim=-1)
    direction = torch.zeros_like(origin)
    direction[..., 2].fill_(1.0)
    return Rays(origin=origin.reshape(-1, 3),
                direction=direction.reshape(-1, 3))


def perspective_rays(cam: Camera, width: int, height: int,
                     dtype=torch.float32) -> Rays:
    """World-space pinhole rays (an extension beyond the reference)."""
    dev = cam.eye.device
    xaxis, yaxis, zaxis = _axes(cam.eye, cam.at, cam.up)
    tan_half = torch.tan(cam.fov * 0.5)
    xs = div(torch.arange(width, dtype=dtype, device=dev) + 0.5, width) * 2.0 - 1.0
    ys = 1.0 - div(torch.arange(height, dtype=dtype, device=dev) + 0.5, height) * 2.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    aspect = width / height
    d = (gx[..., None] * (xaxis * tan_half * aspect)
         + gy[..., None] * (yaxis * tan_half) + zaxis)
    d = d / sqrt((d * d).sum(dim=-1, keepdim=True))
    origin = cam.eye.to(dtype).expand(d.shape)
    return Rays(origin=origin.reshape(-1, 3).contiguous(),
                direction=d.reshape(-1, 3))


def orbit(cam: Camera, d_yaw: float, d_pitch: float) -> Camera:
    """Rotate the eye around ``at`` (row-vector XMMatrixRotationX/Y)."""
    dt, dev = cam.eye.dtype, cam.eye.device
    yaw = torch.tensor(d_yaw, dtype=dt, device=dev)
    pitch = torch.tensor(d_pitch, dtype=dt, device=dev)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    o, z = torch.ones_like(cy), torch.zeros_like(cy)
    rot_y = torch.stack([torch.stack([cy, z, -sy]), torch.stack([z, o, z]),
                         torch.stack([sy, z, cy])])
    rot_x = torch.stack([torch.stack([o, z, z]), torch.stack([z, cp, sp]),
                         torch.stack([z, -sp, cp])])
    eye = (cam.eye - cam.at) @ (rot_x @ rot_y) + cam.at
    return cam.replace(eye=eye)


def check_tile_order(order: str):
    if order not in TILE_ORDERS:
        raise ValueError(
            f"unknown ray_tile_order {order!r}; expected one of {TILE_ORDERS}")


def tile_order(width: int, height: int, tile: int):
    """(perm, inv) int64 numpy permutations putting rays in
    (tile x tile)-pixel tile-major order: ``perm[i]`` is the row-major
    index of the i-th tiled ray, ``color_rowmajor = color_tiled[inv]``."""
    idx = np.arange(width * height, dtype=np.int64).reshape(height, width)
    blocks = []
    for ty in range(0, height, tile):
        for tx in range(0, width, tile):
            blocks.append(idx[ty:ty + tile, tx:tx + tile].reshape(-1))
    perm = np.concatenate(blocks)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int64)
    return perm, inv


@functools.lru_cache(maxsize=8)
def tile_permutation(width: int, height: int, tile: int,
                     device: torch.device):
    """``tile_order``'s (perm, inv) as int64 tensors on ``device``, made
    once a frame size, tile and device: a frame then indexes with them
    without a copy from the host, which a CUDA graph cannot replay."""
    perm, inv = tile_order(width, height, tile)
    with torch.inference_mode(False):
        return (torch.as_tensor(perm, device=device),
                torch.as_tensor(inv, device=device))


def permute_rays(rays: Rays, perm) -> Rays:
    """Apply a ray permutation (an index tensor or array)."""
    perm = torch.as_tensor(perm, device=rays.origin.device)
    return Rays(origin=rays.origin[perm], direction=rays.direction[perm])


def structured_tile_shape(width: int, height: int, tile: int):
    """(th, tw) for the reshape-based tile path, or None: ``tile`` x
    ``tile`` tiles, the tile height halved until it divides the frame
    (1080p with tile 16 -> 8 x 16)."""
    if width % tile != 0:
        return None
    th = tile
    while th > 1 and height % th != 0:
        th //= 2
    if th <= 1:
        return None
    return th, tile


def tile_flat(x, width: int, height: int, th: int, tw: int,
              order: str = "row"):
    """[height*width] row-major -> (th x tw)-tile-major, as a pure
    reshape + permute; ``order`` sequences the tiles along x ('row') or
    down y ('col')."""
    check_tile_order(order)
    t4 = x.reshape(height // th, th, width // tw, tw)
    if order == "col":
        return t4.permute(2, 0, 1, 3).reshape(height * width)
    return t4.permute(0, 2, 1, 3).reshape(height * width)


def untile_flat(x, width: int, height: int, th: int, tw: int,
                order: str = "row"):
    """Inverse of tile_flat."""
    check_tile_order(order)
    if order == "col":
        return (x.reshape(width // tw, height // th, th, tw)
                .permute(1, 2, 0, 3).reshape(height * width))
    return (x.reshape(height // th, width // tw, th, tw)
            .permute(0, 2, 1, 3).reshape(height * width))


def tile_rays(rays: Rays, width: int, height: int, th: int, tw: int,
              order: str = "row") -> Rays:
    """permute_rays for the structured tile order (no gathers)."""
    tf = lambda c: tile_flat(c, width, height, th, tw, order)
    o, d = rays.origin, rays.direction
    return Rays(origin=torch.stack([tf(o[:, k]) for k in range(3)], -1),
                direction=torch.stack([tf(d[:, k]) for k in range(3)], -1))
