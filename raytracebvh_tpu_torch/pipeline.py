"""The frame pipeline: transform -> morton -> sort -> build -> trace -> shade
(the JAX package's ``pipeline.py``, forward rendering, in torch).

Traversal returns discrete hit ids behind a ``.detach()`` boundary; hit
distances, positions, normals, uv and colours are recomputed from those
ids by plain tensor code, as in the JAX package.  On CUDA tensors the
traversal is kernel K1 (``ops.traverse_cuda``) and the leaf-attribute
and texture-quad row gathers are kernel K2 (``ops.gather_cuda``); the
``*_backend`` fields of the config pick them (see ``config.py``).

Shadows and refraction are not ported yet: ``render_frame`` raises
NotImplementedError for them.
"""

from __future__ import annotations

import torch

from .camera import (
    camera_matrices,
    check_tile_order,
    perspective_rays,
    permute_rays,
    reference_rays,
    structured_tile_shape,
    tile_order,
    tile_rays,
    transform_normals,
    transform_points,
    untile_flat,
)
from .config import SORT_BACKENDS, RenderConfig, resolve_backend
from .core.types import BVH, Camera, HitRecord, Rays, Scene
from .ops import bvh as bvh_ops
from .ops import gather_cuda
from .ops.ieee import div
from .ops import morton as morton_ops
from .ops import shade as shade_ops
from .ops import sort as sort_ops
from .ops import traverse_cuda

I32 = torch.int32


def _pad_count(nf: int, multiple: int) -> int:
    """Padded leaf count (the reference's 256 * ceil(nf / 256) sizing)."""
    return max(multiple, ((nf + multiple - 1) // multiple) * multiple)


def build_bvh(scene: Scene, wvp, wv, cfg: RenderConfig) -> BVH:
    """Per-frame LBVH rebuild in ray space."""
    dtype = cfg.torch_dtype
    verts_t = transform_points(scene.verts.to(dtype), wvp.to(dtype))
    normals_t = transform_normals(scene.normals.to(dtype), wv.to(dtype))
    smin, smax = morton_ops.scene_aabb(verts_t)
    codes, lmin, lmax, _ = morton_ops.triangle_leaves(
        verts_t, scene.indices, smin, smax)
    return assemble_bvh(scene, verts_t, normals_t, codes, lmin, lmax, cfg)


def assemble_bvh(scene: Scene, verts_t, normals_t, codes, lmin, lmax,
                 cfg: RenderConfig) -> BVH:
    """Sort + Karras + AABB fit + links + leaf-attribute pack from per-face
    leaf data in face-id order."""
    if cfg.sort_backend not in SORT_BACKENDS:
        raise ValueError(
            f"sort_backend {cfg.sort_backend!r} is not ported; expected one "
            f"of {SORT_BACKENDS}")
    dtype = cfg.torch_dtype
    dev = verts_t.device
    nf = scene.num_faces
    n = _pad_count(nf, cfg.leaf_pad_multiple)

    # pad to the leaf count with sentinel codes + empty boxes
    pad = n - nf
    codes = torch.cat([codes.to(I32), torch.full(
        (pad,), morton_ops.SENTINEL_CODE, dtype=I32, device=dev)])
    lmin = torch.cat([lmin, torch.full((pad, 3), bvh_ops.BIG, dtype=dtype,
                                       device=dev)])
    lmax = torch.cat([lmax, torch.full((pad, 3), -bvh_ops.BIG, dtype=dtype,
                                       device=dev)])
    prim = torch.cat([torch.arange(nf, dtype=I32, device=dev),
                      torch.full((pad,), -1, dtype=I32, device=dev)])

    sorted_codes, order = sort_ops.sort_by_code(codes)
    order = order.long()
    prim, lmin, lmax = prim[order], lmin[order], lmax[order]

    topo = bvh_ops.build_topology(sorted_codes)
    bbmin, bbmax = bvh_ops.fit_aabbs(topo.node_lo, topo.node_hi, lmin, lmax)
    entry, skip = bvh_ops.compute_links(topo, n)

    # leaf triangle data in morton order, gathered once per build
    safe_prim = torch.clamp(prim, min=0).long()
    corner = scene.indices.reshape(-1, 3)[safe_prim].long()  # [n, 3]
    vrow8 = torch.cat([verts_t, normals_t, scene.uv.to(dtype)], dim=1)
    A = [vrow8[corner[:, v]] for v in range(3)]  # 3 x [n, 8]
    tri_mat = scene.mat_index[safe_prim]

    mats = scene.materials
    mrow16 = torch.cat([
        mats.ambient.to(dtype), mats.diffuse.to(dtype),
        mats.specular.to(dtype), mats.shininess.to(dtype)[:, None],
        mats.optical_density.to(dtype)[:, None], mats.alpha.to(dtype)[:, None],
        mats.tex_id.to(dtype)[:, None],  # integer-valued float
    ], dim=1)  # [nmat, 16]
    leaf_attrs = torch.cat(
        [A[0][:, 0:3], A[1][:, 0:3], A[2][:, 0:3],
         A[0][:, 3:6], A[1][:, 3:6], A[2][:, 3:6],
         A[0][:, 6:8], A[1][:, 6:8], A[2][:, 6:8], mrow16[tri_mat.long()]],
        dim=-1)  # [n, 40]

    return BVH(
        codes=sorted_codes,
        prim=prim,
        bbmin=bbmin,
        bbmax=bbmax,
        child_l=topo.child_l,
        child_r=topo.child_r,
        parent=topo.parent,
        entry_link=entry,
        skip_link=skip,
        tri_verts=torch.stack([a[:, 0:3] for a in A], dim=1),
        tri_normals=torch.stack([a[:, 3:6] for a in A], dim=1),
        tri_uv=torch.stack([a[:, 6:8] for a in A], dim=1),
        tri_mat=tri_mat,
        leaf_attrs=leaf_attrs,
    )


def resolve_traversal_backend(cfg: RenderConfig) -> str:
    """'torch' (the plain walk) or 'cuda' (K1's wrapper); see config.py."""
    return resolve_backend(cfg, "traversal_backend")


def _traverse_ids(bvh: BVH, rays: Rays, cfg: RenderConfig) -> HitRecord:
    """Traversal behind a detach boundary: the ids are discrete."""
    bvh = bvh.detach()
    rays = Rays(origin=rays.origin.detach().contiguous(),
                direction=rays.direction.detach().contiguous())
    traverse = traverse_cuda.traverse_for(resolve_traversal_backend(cfg))
    nrays = rays.origin.shape[0]
    chunk = cfg.traversal_chunk
    if chunk > 0 and nrays > chunk:
        if nrays % chunk:
            raise ValueError(
                f"traversal_chunk {chunk} must divide ray count {nrays}")
        recs = [traverse(bvh, Rays(rays.origin[s:s + chunk],
                                   rays.direction[s:s + chunk]),
                         cfg.epsilon, cfg.max_traversal_steps)
                for s in range(0, nrays, chunk)]
        return HitRecord(hit=torch.cat([r.hit for r in recs]),
                         distance=torch.cat([r.distance for r in recs]),
                         leaf=torch.cat([r.leaf for r in recs]))
    return traverse(bvh, rays, cfg.epsilon, cfg.max_traversal_steps)


def _shade_hit_soa(scene: Scene, bvh: BVH, o3, d3, rec: HitRecord,
                   tex_quads, cfg: RenderConfig):
    """Re-evaluation of a hit from its leaf id: position, normal, surface
    colour (renderPixel * specular) and shininess.  One [40]-channel row
    gather per ray (K2 on CUDA) fetches everything."""
    gather = gather_cuda.gather_for(
        resolve_backend(cfg, "shade_gather_backend"))
    A = gather(bvh.leaf_attrs, rec.leaf)
    a = lambda k: A[k]
    t0 = (a(0), a(1), a(2))
    t1 = (a(3), a(4), a(5))
    t2 = (a(6), a(7), a(8))

    # the hit distance, recomputed op for op as Moeller-Trumbore
    e1 = shade_ops.sub3(t1, t0)
    e2 = shade_ops.sub3(t2, t0)
    p = shade_ops.cross3(d3, e2)
    det = shade_ops.dot3(e1, p)
    det_ok = torch.abs(det) >= 1e-12
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    tv = shade_ops.sub3(o3, t0)
    u = shade_ops.dot3(tv, p) * inv_det
    q = shade_ops.cross3(tv, e1)
    v = shade_ops.dot3(d3, q) * inv_det
    t = shade_ops.dot3(e2, q) * inv_det
    ok = (det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > 1e-12))
    t = torch.where(ok, t, -1.0)
    t = torch.where(rec.hit, t, 0.0)
    hit_loc = tuple(o3[i] + d3[i] * t for i in range(3))

    w0, w1, w2 = shade_ops.barycentric_weights3(t0, t1, t2, hit_loc)
    n0 = (a(9), a(10), a(11))
    n1 = (a(12), a(13), a(14))
    n2 = (a(15), a(16), a(17))
    normal = tuple(n0[i] * w0 + n1[i] * w1 + n2[i] * w2 for i in range(3))
    uvu = a(18) * w0 + a(20) * w1 + a(22) * w2
    uvv = a(19) * w0 + a(21) * w1 + a(23) * w2

    # texture sample; miss lanes are pinned to texel (0, 0) so they do not
    # gather random rows of the quad table
    tex_id = a(39).to(I32)
    hmax, wmax = scene.textures.shape[1], scene.textures.shape[2]
    uvu = torch.where(rec.hit, uvu, 0.0)
    uvv = torch.where(rec.hit, uvv, 0.0)
    tex = shade_ops.sample_texture_quads(
        tex_quads, scene.tex_hw, tex_id, uvu, uvv, hmax, wmax,
        backend=resolve_backend(cfg, "texture_gather_backend"))
    # saturate(ambient + diffuse * tex) * specular
    color = tuple(
        torch.clamp(a(24 + c) + a(28 + c) * tex[c], 0.0, 1.0) * a(32 + c)
        for c in range(4))
    return hit_loc, normal, color, a(36)


def _launch_soa(scene: Scene, bvh: BVH, o3, d3, cfg: RenderConfig,
                tex_quads, rec=None):
    """Primary-ray pass: (color4, (refl_o3, refl_d3), refl_intensity)."""
    if rec is None:
        rec = _traverse_ids(bvh, _rays_of(o3, d3), cfg)
    hit_loc, normal, hit_color, shininess = _shade_hit_soa(
        scene, bvh, o3, d3, rec, tex_quads, cfg)
    hit = rec.hit
    bg = cfg.background
    color = tuple(torch.where(hit, hit_color[c], bg[c]) for c in range(4))

    # reflection spawn
    intensity = torch.where(
        hit, div(shininess, 1000.0) * cfg.reflection_decay, 0.0)
    refl_dir = shade_ops.normalize3(shade_ops.reflect3(d3, normal))
    refl_o = tuple(torch.where(hit, hit_loc[i] + normal[i] * cfg.ray_offset,
                               o3[i]) for i in range(3))
    refl_d = tuple(torch.where(hit, refl_dir[i], d3[i]) for i in range(3))
    return color, (refl_o, refl_d), intensity


def _bounce_soa(scene: Scene, bvh: BVH, color, o3, d3, intensity,
                cfg: RenderConfig, tex_quads):
    """One reflection pass: live rays (intensity > intensity_min)
    re-trace; hits lerp the carried colour toward the new surface colour
    and respawn; misses lerp toward the background and die."""
    live = intensity > cfg.intensity_min
    # dead rays start far outside every box: their walk ends on step one
    o3m = tuple(torch.where(live, o3[i], 1.0e30) for i in range(3))
    rec = _traverse_ids(bvh, _rays_of(o3m, d3), cfg)
    hit_loc, normal, hit_color, shininess = _shade_hit_soa(
        scene, bvh, o3, d3, rec, tex_quads, cfg)
    hit = rec.hit & live
    bg = cfg.background

    new_color = tuple(
        torch.where(live, color[c] + intensity
                    * (torch.where(hit, hit_color[c], bg[c]) - color[c]),
                    color[c])
        for c in range(4))
    upd = live & hit
    new_intensity = torch.where(
        upd, div(intensity * shininess, 1000.0) * cfg.reflection_decay, 0.0)
    new_dir = shade_ops.normalize3(shade_ops.reflect3(d3, normal))
    new_o = tuple(torch.where(upd, hit_loc[i] + normal[i]
                              * cfg.bounce_ray_offset, o3[i])
                  for i in range(3))
    new_d = tuple(torch.where(upd, new_dir[i], d3[i]) for i in range(3))
    return new_color, new_o, new_d, new_intensity


def _rays_of(o3, d3):
    return Rays(origin=torch.stack(o3, dim=-1),
                direction=torch.stack(d3, dim=-1))


def _split_rays(rays: Rays):
    o, d = rays.origin, rays.direction
    return tuple(o[:, k] for k in range(3)), tuple(d[:, k] for k in range(3))


def make_rays(camera: Camera, cfg: RenderConfig) -> Rays:
    if cfg.camera_mode == "reference":
        return reference_rays(cfg.width, cfg.height, cfg.ortho_scale,
                              cfg.torch_dtype, camera.eye.device)
    return perspective_rays(camera, cfg.width, cfg.height, cfg.torch_dtype)


def _frame_tex_quads(scene: Scene, cfg: RenderConfig):
    """One row-major quad table per frame, shared by every pass and every
    ray chunk; UNORM8 when ``cfg.texture_dtype == 'uint8'``."""
    resolve_backend(cfg, "texture_gather_backend")  # validate
    tex_quads = shade_ops.pack_texture_quads(scene.textures, scene.tex_hw)
    if cfg.texture_dtype == "uint8":
        tex_quads = shade_ops.quantize_quads_u8(tex_quads.detach())
    elif cfg.texture_dtype != "float32":
        raise ValueError(f"unknown texture_dtype {cfg.texture_dtype!r}; "
                         "expected float32 or uint8")
    return tex_quads


def _shade_rays_one(scene: Scene, bvh: BVH, rays: Rays, cfg: RenderConfig,
                    tex_quads, rec=None):
    """Launch + bounce chain for one batch of rays -> [R, 4] colour."""
    o3, d3 = _split_rays(rays)
    color, (ro, rd), intensity = _launch_soa(scene, bvh, o3, d3, cfg,
                                             tex_quads, rec)
    for _ in range(cfg.bounces):
        color, ro, rd, intensity = _bounce_soa(
            scene, bvh, color, ro, rd, intensity, cfg, tex_quads)
    return torch.stack(color, dim=-1)


def shade_rays(scene: Scene, bvh: BVH, rays: Rays, cfg: RenderConfig):
    """The whole per-ray pipeline, optionally in sequential chunks of
    ``cfg.ray_chunk`` rays.  With ``cull_empty_chunks`` a chunk whose
    primary rays all miss skips shading: it is pure background (its
    spawns carry zero intensity), so the image is the same."""
    if resolve_traversal_backend(cfg) == "cuda":
        # pack K1's tables once per build: every traversal reuses them
        bvh = traverse_cuda.with_tables(bvh)
    tex_quads = _frame_tex_quads(scene, cfg)
    nrays = rays.origin.shape[0]
    chunk = cfg.ray_chunk
    if not (chunk > 0 and nrays > chunk):
        return _shade_rays_one(scene, bvh, rays, cfg, tex_quads)
    if nrays % chunk:
        raise ValueError(f"ray_chunk {chunk} must divide ray count {nrays}")
    bg = torch.tensor(cfg.background, dtype=cfg.torch_dtype,
                      device=rays.origin.device).expand(chunk, 4)
    out = []
    for s in range(0, nrays, chunk):
        r = Rays(rays.origin[s:s + chunk], rays.direction[s:s + chunk])
        rec = None
        if cfg.cull_empty_chunks:
            rec = _traverse_ids(bvh, r, cfg)
            if not bool(rec.hit.any()):
                out.append(bg)
                continue
        out.append(_shade_rays_one(scene, bvh, r, cfg, tex_quads, rec))
    return torch.cat(out)


def render_frame(scene: Scene, camera: Camera, cfg: RenderConfig):
    """One full frame -> [height, width, 4] float image: rebuild the
    LBVH, launch primary rays, run ``cfg.bounces`` reflection passes.
    ``scene`` and ``camera`` must be on the same device; the frame is
    rendered there."""
    if cfg.enable_shadows:
        raise NotImplementedError(
            "shadows (any-hit traversal, kernel K4) are not ported yet")
    if cfg.enable_refraction:
        raise NotImplementedError("refraction is not ported yet")
    if cfg.ray_tile > 0:
        check_tile_order(cfg.ray_tile_order)
    wvp, wv = camera_matrices(camera, cfg.width, cfg.height)
    if cfg.camera_mode == "reference":
        bvh = build_bvh(scene, wvp, wv, cfg)
    elif cfg.camera_mode == "perspective":
        # world-space tracing: identity transform
        eye4 = torch.eye(4, dtype=cfg.torch_dtype, device=scene.device)
        bvh = build_bvh(scene, eye4, eye4, cfg)
    else:
        raise ValueError(f"unknown camera_mode {cfg.camera_mode!r}")
    rays = make_rays(camera, cfg)

    w, h = cfg.width, cfg.height
    st = structured_tile_shape(w, h, cfg.ray_tile) if cfg.ray_tile > 0 else None
    if st is not None:
        th, tw = st
        rays = tile_rays(rays, w, h, th, tw, cfg.ray_tile_order)
        color = shade_rays(scene, bvh, rays, cfg)
        color = torch.stack(
            [untile_flat(color[:, c], w, h, th, tw, cfg.ray_tile_order)
             for c in range(4)], dim=-1)
    elif cfg.ray_tile > 0:
        perm, inv = tile_order(w, h, cfg.ray_tile)
        color = shade_rays(scene, bvh, permute_rays(rays, perm), cfg)
        color = color[torch.as_tensor(inv, device=color.device)]
    else:
        color = shade_rays(scene, bvh, rays, cfg)
    return color.reshape(h, w, 4)

