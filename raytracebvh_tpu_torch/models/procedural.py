"""Procedural test scenes (no asset files required).

Numpy copies of the JAX package's ``models/procedural.py``: the arrays
are equal to the JAX ones.  The Scene goes to ``device``, the CUDA device
unless the caller asks for another (``device="cpu"``); without a card the
default raises, as ``scene_from_numpy``'s does.
"""

from __future__ import annotations

import numpy as np

from ..core.types import Scene, scene_from_numpy, stack_textures


def _default_materials(num: int = 1, shininess: float = 500.0,
                       with_texture: bool = False, alpha: float = 1.0,
                       optical_density: float = 0.0) -> tuple:
    """(materials dict, texture stack, tex_hw) as numpy arrays."""
    rng = np.random.default_rng(0)
    amb = np.tile(np.array([0.1, 0.1, 0.1, 1.0], np.float32), (num, 1))
    diff = rng.uniform(0.3, 0.9, (num, 4)).astype(np.float32)
    diff[:, 3] = 1.0
    spec = np.ones((num, 4), np.float32)
    textures = []
    tex_ids = np.full(num, -1, np.int32)
    if with_texture:
        # 64x64 checkerboard in 8-texel squares
        yy, xx = np.mgrid[0:64, 0:64]
        checker = ((xx // 8 + yy // 8) % 2).astype(np.float32)
        tex = np.stack([checker, 1 - checker, checker * 0.5,
                        np.ones_like(checker)], -1)
        textures.append(tex)
        tex_ids[:] = 0
    stack, hw = stack_textures(textures)
    mats = dict(
        ambient=amb,
        diffuse=diff,
        specular=spec,
        shininess=np.full(num, shininess, np.float32),
        optical_density=np.full(num, optical_density, np.float32),
        alpha=np.full(num, alpha, np.float32),
        tex_id=tex_ids,
    )
    return mats, stack, hw


def random_triangles(num_tris: int, seed: int = 0, extent: float = 50.0,
                     tri_size: float = 4.0, num_materials: int = 3,
                     with_texture: bool = False, alpha: float = 1.0,
                     optical_density: float = 0.0, device="cuda") -> Scene:
    """A cloud of random triangles in [-extent, extent]^3."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-extent, extent, (num_tris, 1, 3))
    offsets = rng.normal(0.0, tri_size, (num_tris, 3, 3))
    verts = (centers + offsets).astype(np.float32).reshape(-1, 3)
    e1 = verts[1::3] - verts[0::3]
    e2 = verts[2::3] - verts[0::3]
    n = np.cross(e1, e2)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    normals = np.repeat(n, 3, axis=0).astype(np.float32)
    uv = rng.uniform(0, 1, (verts.shape[0], 2)).astype(np.float32)
    mats, tex, hw = _default_materials(num_materials, with_texture=with_texture,
                                       alpha=alpha,
                                       optical_density=optical_density)
    return scene_from_numpy(dict(
        verts=verts,
        normals=normals,
        uv=uv,
        indices=np.arange(num_tris * 3, dtype=np.int32),
        mat_index=rng.integers(0, num_materials, num_tris).astype(np.int32),
        materials=mats,
        textures=tex,
        tex_hw=hw,
    ), device=device)


def sphere_grid(nx: int = 4, ny: int = 4, subdiv: int = 8,
                spacing: float = 25.0, radius: float = 8.0,
                with_texture: bool = True, device="cuda") -> Scene:
    """Grid of UV spheres (nx * ny * subdiv * 2 * subdiv * 2 triangles)."""
    # quad corner angles per (sphere-row i, sphere-col j, corner)
    i_ = np.arange(subdiv)[:, None, None]
    j_ = np.arange(subdiv * 2)[None, :, None]
    di = np.array([0, 1, 1, 0])[None, None, :]
    dj = np.array([0, 0, 1, 1])[None, None, :]
    theta = np.pi * (i_ + di) / subdiv          # [i, j, 4]
    phi = 2 * np.pi * (j_ + dj) / (subdiv * 2)
    p = np.stack(
        [np.sin(theta) * np.cos(phi), np.cos(theta) + 0 * phi,
         np.sin(theta) * np.sin(phi)], axis=-1,
    )  # [i, j, 4, 3] unit sphere corners
    uv4 = np.stack(
        [phi / (2 * np.pi) + 0 * theta, theta / np.pi + 0 * phi], axis=-1
    )  # [i, j, 4, 2]
    # two triangles (0,1,2) and (0,2,3) per quad -> 6 emitted corners
    tri_k = np.array([0, 1, 2, 0, 2, 3])
    p6 = p[:, :, tri_k, :].reshape(-1, 3)       # per-sphere [q*6, 3]
    uv6 = uv4[:, :, tri_k, :].reshape(-1, 2)

    cx = (np.arange(nx) - (nx - 1) / 2) * spacing
    cy = (np.arange(ny) - (ny - 1) / 2) * spacing
    centers = np.stack(
        [np.broadcast_to(cx[None, :], (ny, nx)),
         np.broadcast_to(cy[:, None], (ny, nx)),
         np.zeros((ny, nx))], axis=-1,
    ).reshape(-1, 3)  # [ny*nx, 3] in (gy, gx) order

    verts = (p6[None] * radius + centers[:, None, :]).reshape(-1, 3)
    normals = np.broadcast_to(
        p6[None], (centers.shape[0],) + p6.shape
    ).reshape(-1, 3)
    uvs = np.broadcast_to(
        uv6[None], (centers.shape[0],) + uv6.shape
    ).reshape(-1, 2)
    indices = np.arange(verts.shape[0], dtype=np.int32)
    gy_, gx_ = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    mat_sphere = ((gx_ + gy_) % 3).reshape(-1)  # [ny*nx]
    tris_per_sphere = subdiv * (subdiv * 2) * 2
    mat_index = np.repeat(mat_sphere, tris_per_sphere)
    mats, tex, hw = _default_materials(3, with_texture=with_texture)
    return scene_from_numpy(dict(
        verts=np.asarray(verts, np.float32),
        normals=np.asarray(normals, np.float32),
        uv=np.asarray(uvs, np.float32),
        indices=np.asarray(indices, np.int32),
        mat_index=np.asarray(mat_index, np.int32),
        materials=mats,
        textures=tex,
        tex_hw=hw,
    ), device=device)

