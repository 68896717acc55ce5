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

On CUDA tensors the three are compiled, as the JAX functions always are:
each captures its eager body (``_render_sharded``,
``_render_geo_sharded``, ``_train_step_sharded``) into a CUDA graph once
a signature and replays it.  The graphs are kept on the mesh
(``mesh.mesh_graphs``): they replay its communicators, so they go with
it, and another mesh captures its own.  NCCL does not finalize a
communicator while a graph that captured it lives: end with
``mesh.destroy_distributed()``, which drops the graphs first.  The signature is the
entry point, the config, ``grad_chunks`` and ``scene_fn`` for the step,
and the inputs' shapes, dtypes and devices.  The design: the collectives
are inside the graph.
torch captures NCCL's ``broadcast``, ``all_reduce`` and
``all_gather_into_tensor`` (and the ``async_op`` handles waited on in
the body) as graph nodes on the communicator's stream, joined to the
capture stream.  The captures run in ``capture_error_mode=
"thread_local"``, since the process group's watchdog thread queries CUDA
events, which the default "global" mode forbids while any thread
captures.  Each capture's eager warm-up (``graphs.Captured``) runs every
collective of the body first, so the communicators' set-up falls outside
the graph.  A rank whose
rays run in ray chunks shades them in the graph's WHILE nodes
(``graphs.while_loop``; culled, its own hit chunks), its collectives
outside them: the broadcast and the build's before the loop, the frame's
all-gather and the step's gradient all-reduce after it.  Nothing catches a
failed capture: it raises.  On CPU tensors (Gloo) they run the eager
bodies.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import graphs
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
from .mesh import (GEO_AXIS, axis_size, geo_shard, mesh_graphs, ray_axes,
                   ray_shard, replicated)


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


def signature(name: str, cfg: RenderConfig, inputs, *static):
    """The key of a sharded call in its mesh's cache (``mesh_graphs``):
    the entry point's name, the config, any other static arguments and
    the inputs' structure (``graphs.signature``)."""
    return graphs.signature((name, cfg) + static, *inputs)


def _graphed_frame(name: str, fn, inputs, cfg: RenderConfig, mesh):
    """``fn(*inputs)`` replayed from the mesh's capture for
    ``signature``."""
    graphs.check_no_grad(inputs, name)
    return mesh_graphs(mesh).call(signature(name, cfg, inputs), fn, inputs)


def _ray_inputs(scene: Scene, camera: Camera, cfg: RenderConfig, mesh):
    """(scene, bvh, this rank's rays in row order, light3) of
    ``render_sharded``: the scene and camera broadcast from the mesh's
    origin rank (``replicated``) and the whole build."""
    scene, camera = replicated(scene, mesh), replicated(camera, mesh)
    bvh, rays, light3 = frame_inputs(scene, camera, cfg)
    return scene, bvh, _local_rays(rays, mesh), light3


def _render_sharded(scene: Scene, camera: Camera, cfg: RenderConfig, mesh):
    """``render_sharded``'s eager body."""
    rows = _ray_rows(cfg, mesh)
    scene, bvh, rays, light3 = _ray_inputs(scene, camera, cfg, mesh)
    color = shade_tiled(scene, bvh, rays, cfg, light3, cfg.width, rows)
    return _gather_rays(color, mesh).reshape(cfg.height, cfg.width, 4)


def render_sharded(scene: Scene, camera: Camera, cfg: RenderConfig, mesh):
    """The frame [height, width, 4] with rays sharded over the ray axes by
    whole image rows; the block is traced in ``cfg.ray_tile`` order as
    ``render_frame`` traces the frame.  The scene and camera are
    broadcast from the mesh's origin rank first (``replicated``), so every
    rank traces the same scene.  On CUDA tensors a replayed CUDA graph
    (see the module docstring)."""
    if scene.device.type != "cuda":
        return _render_sharded(scene, camera, cfg, mesh)
    return _graphed_frame(
        "render_sharded", lambda s, c: _render_sharded(s, c, cfg, mesh),
        (scene, camera), cfg, mesh)


def _light3(cfg: RenderConfig, wvp):
    """The light in ray space where ``cfg`` shades shadows, else None; in
    ``cfg``'s dtype, as in ``render_frame``."""
    if cfg.enable_shadows:
        return light_in_ray_space(cfg, wvp, cfg.torch_dtype)
    return None


def _check_geo(scene: Scene, cfg: RenderConfig, mesh) -> None:
    """Raises where the scene's vertices or faces, or the image rows, do
    not divide over the mesh."""
    geo = axis_size(mesh, GEO_AXIS)
    nv, nf = scene.num_verts, scene.num_faces
    if nv % geo or nf % geo or scene.indices.shape[0] != 3 * nf:
        raise ValueError(
            f"render_geo_sharded: {nv} vertices and {nf} faces "
            f"({scene.indices.shape[0]} indices) must each divide over "
            f"geo={geo}; pad the scene with degenerate triangles "
            "(parallel.mesh.pad_to_multiple)")
    _ray_rows(cfg, mesh)


def _geo_inputs(scene: Scene, camera: Camera, cfg: RenderConfig, mesh):
    """(scene, bvh, this rank's rays in row order, light3) of
    ``render_geo_sharded``: the sharded leaf stage and the tree."""
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
    return scene, bvh, rays, _light3(cfg, wvp)


def _render_geo_sharded(scene: Scene, camera: Camera, cfg: RenderConfig,
                        mesh):
    """``render_geo_sharded``'s eager body."""
    _check_geo(scene, cfg, mesh)
    scene, bvh, rays, light3 = _geo_inputs(scene, camera, cfg, mesh)
    color = shade_rays(scene, bvh, rays, cfg, light3)
    return _gather_rays(color, mesh).reshape(cfg.height, cfg.width, 4)


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
    leaf data.  On CUDA tensors a replayed CUDA graph (see the module
    docstring)."""
    if scene.device.type != "cuda":
        return _render_geo_sharded(scene, camera, cfg, mesh)
    _check_geo(scene, cfg, mesh)
    return _graphed_frame(
        "render_geo_sharded",
        lambda s, c: _render_geo_sharded(s, c, cfg, mesh), (scene, camera),
        cfg, mesh)


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
    chunks' means add up as ``acc + x / grad_chunks`` in chunk order.

    On CUDA tensors the step (the builds, the forward, the backward with
    K3 and the all-reduces; a chunk loop's WHILE nodes) is one
    replayed CUDA graph (see the module docstring), and the returned
    tensors are new."""
    if params[0].device.type != "cuda":
        return _train_step_sharded(params, scene_fn, scene, camera, target,
                                   cfg, mesh, grad_chunks)
    _check_chunks(cfg, mesh, grad_chunks)
    inputs = (params, scene, camera, target)
    return mesh_graphs(mesh).call(
        signature("train_step_sharded", cfg, inputs, grad_chunks, scene_fn),
        lambda p, s, c, t: _train_step_sharded(p, scene_fn, s, c, t, cfg,
                                               mesh, grad_chunks),
        inputs)


def _check_chunks(cfg: RenderConfig, mesh, grad_chunks: int) -> int:
    """The rank's ray count; raises where ``grad_chunks`` does not divide
    it."""
    nloc = _ray_rows(cfg, mesh) * cfg.width
    if grad_chunks < 1 or nloc % grad_chunks:
        raise ValueError(f"grad_chunks {grad_chunks} must divide the local "
                         f"ray count {nloc}")
    return nloc


def _train_step_sharded(params, scene_fn, scene: Scene, camera: Camera,
                        target, cfg: RenderConfig, mesh, grad_chunks: int = 1):
    """``train_step_sharded``'s eager body."""
    csz = _check_chunks(cfg, mesh, grad_chunks) // grad_chunks
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
        color = shade_rays(s, bvh, Rays(rays.origin[sl], rays.direction[sl]),
                           cfg, _light3(cfg, wvp))
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
