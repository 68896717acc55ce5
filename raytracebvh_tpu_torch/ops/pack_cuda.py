"""The build's leaf pack as one hand-written CUDA kernel
(``csrc/pack.cu``): after the links, one launch writes every table a
frame reads from the tree: ``leaf_attrs`` [n, 40], ``tri_mat`` and K1's
node table [2n, 8] and leaf table [n, 12].  ``tri_verts``,
``tri_normals`` and ``tri_uv`` are views of ``leaf_attrs``' channels 0-8,
9-17 and 18-23.  Every value equals the plain pack's
(``pipeline._pack_leaves``, then ``traverse_cuda.pack_tables``) bit for
bit.

The kernel has no backward: a build takes it where ``engages`` holds,
which needs every input on a CUDA device and no input that needs a
gradient.  Everywhere else (the CPU, bfloat16, the training step's
differentiated build) the plain pack runs.
"""

from __future__ import annotations

import torch

from .. import _kernels
from ..config import RenderConfig
from .shade_cuda import LEAF_CHANNELS

# kernel launches, one a build that took the kernel (chip_smoke.py and
# the gpu tests check the frames reach it); a CUDA graph's capture
# counts, its replays do not (they skip this wrapper)
launches = 0

_FLOATS = ("verts", "normals", "uv", "ambient", "diffuse", "specular",
           "shininess", "optical_density", "alpha", "bbmin", "bbmax")


def inputs(scene, verts_t, normals_t, prim, bbmin, bbmax, entry, skip):
    """Name -> the tensors a pack reads (the scene's uv, indices,
    material index and material table, and the build's tensors)."""
    mats = scene.materials
    return dict(prim=prim, indices=scene.indices, verts=verts_t,
                normals=normals_t, uv=scene.uv, mat_index=scene.mat_index,
                ambient=mats.ambient, diffuse=mats.diffuse,
                specular=mats.specular, shininess=mats.shininess,
                optical_density=mats.optical_density, alpha=mats.alpha,
                tex_id=mats.tex_id, bbmin=bbmin, bbmax=bbmax, entry=entry,
                skip=skip)


def engages(cfg: RenderConfig, tensors: dict) -> bool:
    """Whether a build of ``cfg`` whose pack reads ``tensors``
    (``inputs``' names) takes the kernel: ``cfg.dtype`` is float32, every
    input lies on a CUDA device, the float inputs are float32 and the
    integer ones int32, and no input needs a gradient
    (``graphs.check_no_grad``'s rule: grad mode on and an input that
    requires grad)."""
    return (cfg.dtype == "float32"
            and all(t.device.type == "cuda" for t in tensors.values())
            and all(t.dtype == (torch.float32 if k in _FLOATS
                                else torch.int32)
                    for k, t in tensors.items())
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in tensors.values())))


def _checked(tensors: dict) -> dict:
    """``tensors`` made contiguous, with their shapes checked against the
    leaf count n = prim's length; raises where one differs."""
    t = {k: v.contiguous() for k, v in tensors.items()}
    n = t["prim"].shape[0]
    nv, nf = t["verts"].shape[0], t["mat_index"].shape[0]
    k = t["ambient"].shape[0]
    shapes = dict(prim=(n,), indices=(3 * nf,), verts=(nv, 3),
                  normals=(nv, 3), uv=(nv, 2), mat_index=(nf,),
                  ambient=(k, 4), diffuse=(k, 4), specular=(k, 4),
                  shininess=(k,), optical_density=(k,), alpha=(k,),
                  tex_id=(k,), bbmin=(2 * n, 3), bbmax=(2 * n, 3),
                  entry=(2 * n,), skip=(2 * n,))
    for name, shape in shapes.items():
        if tuple(t[name].shape) != shape:
            raise ValueError(f"leaf_pack: {name} must be {shape}; got "
                             f"{tuple(t[name].shape)}")
    if nf == 0 or k == 0:
        raise ValueError("leaf_pack: the scene has no face or no material")
    return t


def pack(tensors: dict) -> dict:
    """The BVH's leaf fields (``tri_verts``, ``tri_normals``, ``tri_uv``,
    ``tri_mat``, ``leaf_attrs``) and K1's tables (``node_table``,
    ``leaf_table``) from ``inputs``' tensors, in one launch."""
    global launches
    t = _checked(tensors)
    n = t["prim"].shape[0]
    dev = t["prim"].device
    f32 = dict(dtype=torch.float32, device=dev)
    leaf_attrs = torch.empty((n, LEAF_CHANNELS), **f32)
    tri_mat = torch.empty((n,), dtype=torch.int32, device=dev)
    node_table = torch.empty((2 * n, 8), **f32)
    leaf_table = torch.empty((n, 12), **f32)
    lib = _kernels.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rtbvh_leaf_pack(
            *(t[k].data_ptr() for k in (
                "prim", "indices", "verts", "normals", "uv", "mat_index",
                "ambient", "diffuse", "specular", "shininess",
                "optical_density", "alpha", "tex_id", "bbmin", "bbmax",
                "entry", "skip")),
            n, leaf_attrs.data_ptr(), tri_mat.data_ptr(),
            node_table.data_ptr(), leaf_table.data_ptr(), stream)
    _kernels.check(err, "leaf_pack launch")
    launches += 1
    return dict(tri_verts=leaf_attrs[:, 0:9].unflatten(1, (3, 3)),
                tri_normals=leaf_attrs[:, 9:18].unflatten(1, (3, 3)),
                tri_uv=leaf_attrs[:, 18:24].unflatten(1, (3, 2)),
                tri_mat=tri_mat, leaf_attrs=leaf_attrs,
                node_table=node_table, leaf_table=leaf_table)
