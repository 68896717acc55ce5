"""Core datatypes: Materials, Scene, Camera, BVH, Rays, HitRecord.

Frozen dataclasses of tensors, field for field the JAX package's
``core/types.py`` pytrees (without the TPU rank-space layouts
``BVH.hbm_table`` and ``BVH.rank``).  ``.to(device)`` moves every tensor
field (``Tensor.to`` is differentiable: a field that carries a gradient
keeps it); ``*_from_numpy`` build them from numpy arrays (or from any object
with the same attribute names, such as a JAX pytree), so a test can hand
the port the very arrays the JAX package made.  They and
``Camera.default`` put their tensors on the CUDA device unless the caller
names another (``device="cpu"``), as the port's entry points run on the
card; without one they raise rather than fall back to the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch


def map_tensors(fn, obj):
    """Copy of a dataclass with ``fn`` applied to every tensor field (and
    to those of nested dataclasses)."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            v = fn(v)
        elif dataclasses.is_dataclass(v):
            v = map_tensors(fn, v)
        kw[f.name] = v
    return dataclasses.replace(obj, **kw)


def _to(obj, device):
    """Copy of a dataclass with every tensor field moved to ``device``."""
    return map_tensors(lambda t: t.to(device), obj)


def _get(d, name):
    return d[name] if isinstance(d, dict) else getattr(d, name)


def _tensor(x, device="cuda"):
    return torch.as_tensor(np.array(x), device=device)  # own, writable copy


@dataclasses.dataclass(frozen=True)
class Materials:
    """Struct-of-arrays material table; ``tex_id`` -1 = untextured."""

    ambient: torch.Tensor  # [k, 4]
    diffuse: torch.Tensor  # [k, 4]
    specular: torch.Tensor  # [k, 4]
    shininess: torch.Tensor  # [k]
    optical_density: torch.Tensor  # [k]
    alpha: torch.Tensor  # [k]
    tex_id: torch.Tensor  # [k] int32, -1 = none

    @property
    def count(self) -> int:
        return self.ambient.shape[0]

    def replace(self, **kw) -> "Materials":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "Materials":
        return _to(self, device)


@dataclasses.dataclass(frozen=True)
class Scene:
    """Deduplicated triangle mesh + materials + one padded texture stack
    ``textures[T, H, W, 4]`` with valid extents ``tex_hw[T, 2]``."""

    verts: torch.Tensor  # [nv, 3] float
    normals: torch.Tensor  # [nv, 3] float
    uv: torch.Tensor  # [nv, 2] float
    indices: torch.Tensor  # [nf * 3] int32
    mat_index: torch.Tensor  # [nf] int32
    materials: Materials
    textures: torch.Tensor  # [T, H, W, 4] float
    tex_hw: torch.Tensor  # [T, 2] int32

    @property
    def num_faces(self) -> int:
        return self.mat_index.shape[0]

    @property
    def num_verts(self) -> int:
        return self.verts.shape[0]

    @property
    def device(self) -> torch.device:
        return self.verts.device

    def replace(self, **kw) -> "Scene":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "Scene":
        return _to(self, device)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Orbit camera; ``fov`` is XMMatrixPerspectiveFovLH's vertical fov."""

    eye: torch.Tensor  # [3]
    at: torch.Tensor  # [3]
    up: torch.Tensor  # [3]
    fov: torch.Tensor  # scalar
    near: torch.Tensor  # scalar
    far: torch.Tensor  # scalar

    @classmethod
    def default(cls, device="cuda", dtype=torch.float32) -> "Camera":
        # eye (0, 5, -100), at the origin, +Y up, fov pi/4, near .1,
        # far 1000 -- the JAX package's Camera.default
        t = lambda v: torch.tensor(v, dtype=dtype, device=device)
        return cls(eye=t([0.0, 5.0, -100.0]), at=t([0.0, 0.0, 0.0]),
                   up=t([0.0, 1.0, 0.0]), fov=t(math.pi / 4), near=t(0.1),
                   far=t(1000.0))

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "Camera":
        return _to(self, device)


@dataclasses.dataclass(frozen=True)
class BVH:
    """Linear BVH in struct-of-arrays form (node numbering and fields as
    the JAX package's ``BVH``): leaves ``[0, n)`` in morton order,
    internal nodes ``[n, 2n-1)``, root ``n``; per-node arrays are sized
    ``2n``.  ``leaf_attrs [n, 40]`` packs t0|t1|t2 xyz (0-8), n0|n1|n2
    (9-17), uv0|uv1|uv2 (18-23), ambient (24-27), diffuse (28-31),
    specular (32-35), shininess, optical density, alpha, tex_id (36-39).

    ``node_table``/``leaf_table`` hold the CUDA traversal's packed tables
    (``ops.traverse_cuda.pack_tables``, or the build's kernel pack
    ``ops.pack_cuda``, which also makes ``tri_verts``, ``tri_normals`` and
    ``tri_uv`` views of ``leaf_attrs``); the pipeline packs them once per
    build and every traversal of the frame reuses them.  None = pack on
    demand."""

    codes: torch.Tensor  # [n] int32 sorted 30-bit morton codes
    prim: torch.Tensor  # [n] int32 face id, -1 = padding
    bbmin: torch.Tensor  # [2n, 3]
    bbmax: torch.Tensor  # [2n, 3]
    child_l: torch.Tensor  # [2n] int32
    child_r: torch.Tensor  # [2n] int32
    parent: torch.Tensor  # [2n] int32, -1 at root
    entry_link: torch.Tensor  # [2n] int32 next node on box hit
    skip_link: torch.Tensor  # [2n] int32 next node on miss / after leaf
    tri_verts: torch.Tensor  # [n, 3, 3]
    tri_normals: torch.Tensor  # [n, 3, 3]
    tri_uv: torch.Tensor  # [n, 3, 2]
    tri_mat: torch.Tensor  # [n] int32
    leaf_attrs: torch.Tensor  # [n, 40]
    node_table: Optional[torch.Tensor] = None  # [2n, 8] float32
    leaf_table: Optional[torch.Tensor] = None  # [n, 12] float32

    @property
    def n_leaves(self) -> int:
        return self.codes.shape[0]

    @property
    def root(self) -> int:
        return self.n_leaves

    def replace(self, **kw) -> "BVH":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "BVH":
        return _to(self, device)

    def detach(self) -> "BVH":
        tensors = {f.name: getattr(self, f.name)
                   for f in dataclasses.fields(self)}
        return dataclasses.replace(self, **{
            k: v.detach() for k, v in tensors.items()
            if isinstance(v, torch.Tensor)})


@dataclasses.dataclass(frozen=True)
class Rays:
    """A batch of rays."""

    origin: torch.Tensor  # [R, 3]
    direction: torch.Tensor  # [R, 3]

    @property
    def inv_direction(self) -> torch.Tensor:
        return 1.0 / self.direction

    def to(self, device) -> "Rays":
        return _to(self, device)


@dataclasses.dataclass(frozen=True)
class HitRecord:
    """Traversal result per ray: leaf id of the nearest hit (0 on miss)."""

    hit: torch.Tensor  # [R] bool
    distance: torch.Tensor  # [R] float
    leaf: torch.Tensor  # [R] int32

    def to(self, device) -> "HitRecord":
        return _to(self, device)


def stack_textures(textures: list) -> tuple:
    """Pad a list of [H, W, 4] float arrays into one [T, Hmax, Wmax, 4]
    numpy stack; returns (stack, tex_hw).  No textures -> one 1x1 white
    texture, so gathers stay in bounds (tex_id -1 never samples it)."""
    if not textures:
        return np.ones((1, 1, 1, 4), np.float32), np.array([[1, 1]], np.int32)
    hmax = max(t.shape[0] for t in textures)
    wmax = max(t.shape[1] for t in textures)
    out = np.zeros((len(textures), hmax, wmax, 4), np.float32)
    hw = np.zeros((len(textures), 2), np.int32)
    for i, t in enumerate(textures):
        out[i, : t.shape[0], : t.shape[1]] = t
        hw[i] = (t.shape[0], t.shape[1])
    return out, hw


def materials_from_numpy(d, device="cuda") -> Materials:
    return Materials(**{f.name: _tensor(_get(d, f.name), device)
                        for f in dataclasses.fields(Materials)})


def scene_from_numpy(d, device="cuda") -> Scene:
    """A Scene from a dict (or object) of numpy arrays named as the JAX
    Scene's fields; ``materials`` may be a dict or an object too."""
    kw = {f.name: _tensor(_get(d, f.name), device)
          for f in dataclasses.fields(Scene) if f.name != "materials"}
    return Scene(materials=materials_from_numpy(_get(d, "materials"), device),
                 **kw)


def camera_from_numpy(d, device="cuda") -> Camera:
    return Camera(**{f.name: _tensor(_get(d, f.name), device)
                     for f in dataclasses.fields(Camera)})


def bvh_from_numpy(d, device="cuda") -> BVH:
    """A BVH from the arrays of a JAX ``BVH`` (its TPU-only fields are
    ignored); morton codes come in as uint32 and are held as int32."""
    kw = {}
    for f in dataclasses.fields(BVH):
        if f.name in ("node_table", "leaf_table"):
            continue
        a = np.asarray(_get(d, f.name))
        if a.dtype == np.uint32:
            a = a.astype(np.int32)  # 30-bit codes fit
        kw[f.name] = _tensor(a, device)
    return BVH(**kw)
