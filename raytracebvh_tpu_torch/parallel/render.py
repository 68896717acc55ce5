"""Sharded rendering and the distributed training step (the JAX package's
``parallel/render.py`` on ``torch.distributed``).

Every function here is called by every rank of the mesh with the same
(whole) scene, camera and config, and returns the same result on every
rank:

  * ``render_sharded``: rays sharded over the ray axes, the scene and
    camera replicated (broadcast from the mesh's origin rank).  Each rank
    builds the whole LBVH (XLA replicates the build too), traces its
    block of image rows, and an all-gather over the ray axes assembles
    the frame.  Tracing needs no collective: rays are independent.
  * ``render_geo_sharded``: the sharded leaf stage.  Each rank of a
    ``geo`` group transforms its share of the vertices and makes the leaf
    data (morton codes, boxes) of its share of the faces; min/max
    all-reduces give the scene box, all-gathers ship the derived arrays
    (not the scene, which every rank holds), and each rank assembles the
    tree and traces its ray block.
  * ``train_step_sharded``: the inverse-rendering loss over this rank's
    rays, its gradient by autograd, and the average of loss and gradient
    over every mesh axis, innermost first.

On the card the collectives are NCCL's, on the CPU Gloo's; the frame's
own work runs through the port's kernels (K1, K2, K4 on a shadowed frame,
K3 in the backward, K5-K8 where the config picks them) exactly as in
``pipeline.render_frame``.  The frames equal ``render_frame``'s bit for
bit: the shards' sums are the same elementwise operations, min and max
and gathers are exact, and a ray's colour does not depend on its order.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..camera import transform_normals, transform_points
from ..config import RenderConfig
from ..core.types import Camera, Rays, Scene
from ..ops import morton as morton_ops
from ..ops.ieee import div
from ..pipeline import (
    assemble_bvh,
    build_bvh,
    build_transforms,
    frame_inputs,
    light_in_ray_space,
    make_rays,
    shade_rays,
    shade_tiled,
)
from .mesh import (GEO_AXIS, axis_size, geo_shard, ray_axes, ray_shard,
                   replicated)


def _ray_axis_names(mesh):
    axes = ray_axes(mesh)
    return axes if isinstance(axes, tuple) else (axes,)


def _ray_rows(cfg: RenderConfig, mesh) -> int:
    """Image rows of this rank's ray block; raises where the rows do not
    divide over the ray shards.  (``shade_rays`` raises where
    ``cfg.ray_chunk`` does not divide the block's rays.)"""
    shards = 1
    for name in _ray_axis_names(mesh):
        shards *= axis_size(mesh, name)
    if cfg.height % shards:
        raise ValueError(f"height {cfg.height} does not divide into "
                         f"{shards} ray shards")
    return cfg.height // shards


def _all_gather(x, mesh, name: str):
    """``x`` of every rank of axis ``name``, concatenated along dim 0 in
    the axis' coordinate order."""
    x = x.contiguous()
    out = x.new_empty((axis_size(mesh, name) * x.shape[0],) + x.shape[1:])
    dist.all_gather_into_tensor(out, x, group=mesh.get_group(name))
    return out


def _gather_rays(x, mesh):
    """Every rank's ray block in row order: a gather over the inner ray
    axis, then over 'dcn' on a host mesh (its coordinate is the outer
    digit of a block's index)."""
    for name in reversed(_ray_axis_names(mesh)):
        x = _all_gather(x, mesh, name)
    return x


def _local_rays(rays: Rays, mesh) -> Rays:
    return Rays(ray_shard(rays.origin, mesh), ray_shard(rays.direction, mesh))


def render_sharded(scene: Scene, camera: Camera, cfg: RenderConfig, mesh):
    """The frame [height, width, 4] with rays sharded over the ray axes by
    whole image rows; the block is traced in ``cfg.ray_tile`` order as
    ``render_frame`` traces the frame.  The scene and camera are
    broadcast from the mesh's origin rank first (``replicated``), so every
    rank traces the same scene."""
    rows = _ray_rows(cfg, mesh)
    scene, camera = replicated(scene, mesh), replicated(camera, mesh)
    bvh, rays, light3 = frame_inputs(scene, camera, cfg)
    color = shade_tiled(scene, bvh, _local_rays(rays, mesh), cfg, light3,
                        cfg.width, rows)
    return _gather_rays(color, mesh).reshape(cfg.height, cfg.width, 4)


def _trace_tile(scene: Scene, bvh, rays: Rays, cfg: RenderConfig, wvp):
    """Launch + bounces (+ refraction + shadows) for a tile of rays, in
    the rays' order.  The light takes ``cfg``'s dtype, as in
    ``render_frame``."""
    light3 = None
    if cfg.enable_shadows:
        light3 = light_in_ray_space(cfg, wvp, cfg.torch_dtype)
    return shade_rays(scene, bvh, rays, cfg, light3)


def render_geo_sharded(scene: Scene, camera: Camera, cfg: RenderConfig,
                       mesh):
    """The frame [height, width, 4] with the leaf stage sharded over 'geo'
    and rays over the ray axes (forward only: the gathers carry no
    gradient).  Unlike ``render_sharded`` the ray block is traced in row
    order, as in the JAX package.

    The vertex count and the face count must each divide over 'geo', so
    that a rank's face share is whole faces: pad a scene that does not
    with degenerate triangles (``parallel.mesh.pad_to_multiple``).  Face
    indices are global; each face share indexes the gathered vertices.
    Every rank holds the whole scene, so only the arrays derived from a
    share are gathered: the transformed vertices and normals and the
    leaf data."""
    geo = axis_size(mesh, GEO_AXIS)
    nv, nf = scene.num_verts, scene.num_faces
    if nv % geo or nf % geo or scene.indices.shape[0] != 3 * nf:
        raise ValueError(
            f"render_geo_sharded: {nv} vertices and {nf} faces "
            f"({scene.indices.shape[0]} indices) must each divide over "
            f"geo={geo}; pad the scene with degenerate triangles "
            "(parallel.mesh.pad_to_multiple)")
    _ray_rows(cfg, mesh)
    group = mesh.get_group(GEO_AXIS)
    wvp, m, mv = build_transforms(camera, cfg)
    dtype = cfg.torch_dtype
    vt_l = transform_points(geo_shard(scene.verts, mesh).to(dtype),
                            m.to(dtype))
    nt_l = transform_normals(geo_shard(scene.normals, mesh).to(dtype),
                             mv.to(dtype))
    smin, smax = morton_ops.scene_aabb(vt_l)
    dist.all_reduce(smin, op=dist.ReduceOp.MIN, group=group)
    dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
    verts_t = _all_gather(vt_l, mesh, GEO_AXIS)
    normals_t = _all_gather(nt_l, mesh, GEO_AXIS)

    codes_l, lmin_l, lmax_l, _ = morton_ops.triangle_leaves(
        verts_t, geo_shard(scene.indices, mesh), smin, smax)
    codes, lmin, lmax = (_all_gather(x, mesh, GEO_AXIS)
                         for x in (codes_l, lmin_l, lmax_l))
    bvh = assemble_bvh(scene, verts_t, normals_t, codes, lmin, lmax, cfg)
    rays = _local_rays(make_rays(camera, cfg), mesh)
    color = _trace_tile(scene, bvh, rays, cfg, wvp)
    return _gather_rays(color, mesh).reshape(cfg.height, cfg.width, 4)


def train_step_sharded(params, scene_fn, scene: Scene, camera: Camera,
                       target, cfg: RenderConfig, mesh, grad_chunks: int = 1):
    """One inverse-rendering step -> (loss, grads): the mean squared error
    of this rank's rays against ``target`` ([height, width, 4], whole on
    every rank), and its gradient with respect to ``params`` (a
    NamedTuple of tensors, such as ``models.inverse.InverseParams``),
    both averaged over every mesh axis, innermost first: an
    ``all_reduce(SUM)`` over the axis' group, divided by its size.
    ``grads`` has ``params``' type; ``params`` are not modified.

    ``scene_fn(params, scene)`` applies the parameters.  The rays are
    traced in row order, as in the JAX package.

    ``grad_chunks`` > 1 splits the local rays into that many chunks, each
    with its own build, forward and backward (so K1-K3 launch that many
    times more).  A chunk's all-reduce over the innermost axis is issued
    asynchronously before the next chunk's build, so it overlaps that
    work; the handles are waited on after the last chunk, then the outer
    axes reduce all chunks at once (the same sums, elementwise).  The
    chunks' means add up as ``acc + x / grad_chunks`` in chunk order."""
    rows = _ray_rows(cfg, mesh)
    nloc = rows * cfg.width
    if grad_chunks < 1 or nloc % grad_chunks:
        raise ValueError(f"grad_chunks {grad_chunks} must divide the local "
                         f"ray count {nloc}")
    csz = nloc // grad_chunks
    wvp, m, mv = build_transforms(camera, cfg)
    rays = _local_rays(make_rays(camera, cfg), mesh)
    target = ray_shard(target.reshape(-1, 4), mesh)
    leaves = type(params)(*(p.detach().requires_grad_(True) for p in params))
    inner, *outer = reversed(mesh.mesh_dim_names)

    pending = []
    for c in range(grad_chunks):
        sl = slice(c * csz, (c + 1) * csz)
        s = scene_fn(leaves, scene)
        bvh = build_bvh(s, m, mv, cfg)
        color = _trace_tile(s, bvh, Rays(rays.origin[sl], rays.direction[sl]),
                            cfg, wvp)
        loss = torch.mean((color - target[sl]) ** 2)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        buf = torch.cat([loss.detach().reshape(1)] + [
            (torch.zeros_like(p) if g is None else g).reshape(-1)
            for g, p in zip(grads, leaves)])
        work = dist.all_reduce(buf, op=dist.ReduceOp.SUM,
                               group=mesh.get_group(inner), async_op=True)
        pending.append((buf, work))
    for _, work in pending:
        work.wait()
    bufs = div(torch.stack([buf for buf, _ in pending]),
               axis_size(mesh, inner))
    for name in outer:
        dist.all_reduce(bufs, op=dist.ReduceOp.SUM, group=mesh.get_group(name))
        bufs = div(bufs, axis_size(mesh, name))
    if grad_chunks == 1:
        acc = bufs[0]
    else:
        acc = torch.zeros_like(bufs[0])
        for c in range(grad_chunks):
            acc = acc + div(bufs[c], grad_chunks)

    out, start = [], 1
    for p in leaves:
        out.append(acc[start:start + p.numel()].reshape(p.shape).to(p.dtype))
        start += p.numel()
    return acc[0].to(loss.dtype), type(params)(*out)
