"""The plain reference of a frame: plain PyTorch, float32, no tree.

It computes what a frame of the ray tracer means, from the raw inputs the
benchmark makes (``rtbench/scenes.py``): the camera's matrices, the
orthographic primary rays in clip space (the reference's "reference"
camera mode: WVP-transformed geometry, no w-divide), the nearest hit of
each ray by the Moeller-Trumbore test against every triangle (with the
configuration's epsilon as the determinant and distance threshold), the
shading of a hit (barycentric interpolation of normals and uvs, a bilinear
wrap sample of the texture, ambient + diffuse * texture, times specular),
one reflection pass a bounce, and the shadow ray of a primary hit.

No bounding volume hierarchy is built: a tree only accelerates the nearest
hit, so the answer is the brute-force one.  Primary rays all point along
+z, so the triangles a primary ray can hit are those whose xy box holds
its origin: their pixel boxes are enumerated (an exact cull, one pixel of
margin).  Other rays test every triangle, in blocks.  Ties in distance go
to the lowest triangle index.

Everything that the program derives (the tree, its leaf table, the rays,
the texture quads, the light in ray space) is worked out again here.  It
imports nothing of the program.
"""

from __future__ import annotations

import torch

# pairs of (ray, triangle) a brute-force block holds
BLOCK_PAIRS = 1 << 26


def cross(a, b):
    ax, ay, az = a
    bx, by, bz = b
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def norm(a):
    return torch.sqrt(dot(a, a))


def normalize(v):
    inv = 1.0 / torch.clamp(norm(v), min=1e-30)
    return (v[0] * inv, v[1] * inv, v[2] * inv)


def comps(x):
    """[..., 3] -> tuple of three [...] tensors."""
    return (x[..., 0], x[..., 1], x[..., 2])


# ---- camera -------------------------------------------------------------

def camera_matrices(cam: dict, width: int, height: int):
    """(wvp, wv): the row-vector world-view-projection and world-view of a
    left-handed look-at and perspective (DirectXMath's XMMatrixLookAtLH and
    XMMatrixPerspectiveFovLH with aspect height / width), world = identity."""
    eye, at, up = cam["eye"], cam["at"], cam["up"]
    z = at - eye
    z = z / torch.sqrt(torch.dot(z, z))
    x = torch.stack(cross(comps(up), comps(z)))
    x = x / torch.sqrt(torch.dot(x, x))
    y = torch.stack(cross(comps(z), comps(x)))
    zero, one = torch.zeros_like(eye[0]), torch.ones_like(eye[0])
    view = torch.stack([
        torch.stack([x[0], y[0], z[0], zero]),
        torch.stack([x[1], y[1], z[1], zero]),
        torch.stack([x[2], y[2], z[2], zero]),
        torch.stack([-torch.dot(x, eye), -torch.dot(y, eye),
                     -torch.dot(z, eye), one])])
    fov, near, far = cam["fov"], cam["near"], cam["far"]
    h = 1.0 / torch.tan(fov * 0.5)
    w = h / (torch.full_like(h, height) / width)
    rng = far / (far - near)
    proj = torch.stack([
        torch.stack([w, zero, zero, zero]),
        torch.stack([zero, h, zero, zero]),
        torch.stack([zero, zero, rng, one]),
        torch.stack([zero, zero, -rng * near, zero])])
    return view @ proj, view


def transform_points(p, m):
    """[n, 3] points by a row-vector 4x4, no w-divide."""
    return torch.stack([p[:, 0] * m[0, k] + p[:, 1] * m[1, k]
                        + p[:, 2] * m[2, k] + m[3, k] for k in range(3)], -1)


def transform_normals(n, m):
    return torch.stack([n[:, 0] * m[0, k] + n[:, 1] * m[1, k]
                        + n[:, 2] * m[2, k] for k in range(3)], -1)


def primary_origins(pix, width: int, height: int, ortho_scale: float):
    """Clip-space origins ((x - w//2) / s, (y - h//2) / s, 0) of the
    row-major pixels ``pix`` (int64)."""
    px = (pix % width).to(torch.float32)
    py = (pix // width).to(torch.float32)
    s = torch.full((), ortho_scale, dtype=torch.float32, device=pix.device)
    return ((px - (width // 2)) / s, (py - (height // 2)) / s,
            torch.zeros_like(px))


# ---- geometry in ray space ----------------------------------------------

def ray_space(scene: dict, cam: dict, cfg: dict, offsets=None):
    """The frame's triangles in ray space: dict of corner positions
    [nf, 3, 3] (differentiable in ``offsets``), corner normals and uvs,
    and per-face material index; and the light in ray space."""
    wvp, wv = camera_matrices(cam, cfg["width"], cfg["height"])
    verts = scene["verts"] if offsets is None else scene["verts"] + offsets
    idx = scene["indices"].long().reshape(-1, 3)
    pos = transform_points(verts, wvp)[idx]
    nrm = transform_normals(scene["normals"], wv)[idx]
    light = torch.tensor(cfg["light_pos"], dtype=torch.float32,
                         device=verts.device)
    light = transform_points(light[None], wvp)[0]
    return dict(pos=pos, nrm=nrm, uv=scene["uv"][idx],
                mat=scene["mat_index"].long()), light


def _tris(pos):
    """[nf, 3] rows of each triangle's first corner, two edges, and box."""
    p = pos.detach()
    return (p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], p.amin(dim=1),
            p.amax(dim=1))


def _mt(o, d, tri, eps):
    """Moeller-Trumbore on broadcast components -> (ok, t); a triangle
    whose box the ray misses (``_slab``) is not hit.  ``tri``: components
    of the first corner, the edges and the box."""
    v0, e1, e2, lo, hi = tri
    p = cross(d, e2)
    det = dot(e1, p)
    det_ok = torch.abs(det) >= eps
    inv = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    tv = sub(o, v0)
    u = dot(tv, p) * inv
    q = cross(tv, e1)
    v = dot(d, q) * inv
    t = dot(e2, q) * inv
    ok = (det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > eps) & _slab(o, d, lo, hi))
    return ok, t


def _slab(o, d, lo, hi):
    """Whether the ray meets the triangle's box by the slab test, in the
    traversal's stated arithmetic (the program's csrc/walk.cuh and its
    plain walk): per axis (lo - o) * (1 / d) and (hi - o) * (1 / d), the
    entry the largest of the near ones and the exit the smallest of the
    far ones, IEEE min and max that carry a NaN, a hit when 0 <= exit and
    entry <= exit.  A ray the Moeller-Trumbore test takes by rounding but
    whose box it misses is not hit there; and along an axis the ray does
    not move in, an origin exactly in one of the box's planes gives
    0 * inf = NaN, and the box is missed.  A triangle's box lies inside
    every box above it in a tree, so its own test decides."""
    near = far = None
    for k in range(3):
        inv = 1.0 / d[k]
        t0 = (lo[k] - o[k]) * inv
        t1 = (hi[k] - o[k]) * inv
        lo_t, hi_t = torch.minimum(t0, t1), torch.maximum(t0, t1)
        near = lo_t if near is None else torch.maximum(near, lo_t)
        far = hi_t if far is None else torch.minimum(far, hi_t)
    return (0.0 <= far) & (near <= far)


def _key(t, tri):
    """int64 key ordered by (t, tri) for t > 0 (an IEEE float's bits
    order as an integer's when it is positive)."""
    return (t.contiguous().view(torch.int32).long() << 32) | tri


def _unkey(key):
    t = (key >> 32).to(torch.int32).view(torch.float32)
    return t, (key & 0xFFFFFFFF)


def nearest_hits(o, d, pos, eps: float):
    """Nearest hit of every ray ([R] components ``o``, ``d``) against every
    triangle: (hit [R] bool, distance [R], face [R] int64; 0 on a miss)."""
    tris = tuple(comps(x[None, :, :]) for x in _tris(pos))
    nt = pos.shape[0]
    n = o[0].shape[0]
    block = max(1, BLOCK_PAIRS // nt)
    tri = torch.arange(nt, device=o[0].device)[None, :]
    keys = []
    for s in range(0, n, block):
        ob = tuple(c[s:s + block, None] for c in o)
        db = tuple(c[s:s + block, None] for c in d)
        ok, t = _mt(ob, db, tris, eps)
        key = torch.where(ok, _key(t, tri), torch.iinfo(torch.int64).max)
        keys.append(key.min(dim=1).values)
    return _from_keys(torch.cat(keys) if keys else
                      torch.empty(0, dtype=torch.int64, device=o[0].device))


def _from_keys(key):
    hit = key != torch.iinfo(torch.int64).max
    t, tri = _unkey(torch.where(hit, key, 0))
    return hit, torch.where(hit, t, 0.0), torch.where(hit, tri, 0)


def any_hits(o, d, max_t, pos, eps: float):
    """Whether a triangle lies between each ray's origin and ``max_t``
    (the any-hit test of a shadow ray)."""
    tris = tuple(comps(x[None, :, :]) for x in _tris(pos))
    nt = pos.shape[0]
    n = o[0].shape[0]
    block = max(1, BLOCK_PAIRS // nt)
    out = []
    for s in range(0, n, block):
        ob = tuple(c[s:s + block, None] for c in o)
        db = tuple(c[s:s + block, None] for c in d)
        ok, t = _mt(ob, db, tris, eps)
        out.append((ok & (t < max_t[s:s + block, None])).any(dim=1))
    if not out:
        return torch.zeros(0, dtype=torch.bool, device=o[0].device)
    return torch.cat(out)


def primary_hits(pos, cfg: dict):
    """Nearest hit of every pixel's primary ray (origin on the pixel grid,
    direction +z): each triangle is tested against the pixels of its xy
    box (with a pixel of margin), the nearest kept by a scatter-min of
    (distance, face) keys.  -> (hit, distance, face) over the W*H pixels,
    row-major."""
    width, height, s = cfg["width"], cfg["height"], cfg["ortho_scale"]
    eps = cfg["epsilon"]
    tris = _tris(pos)
    dev = pos.device
    lo, hi = tris[3], tris[4]
    ilo = torch.floor(lo[:, 0] * s + width // 2).long() - 1
    ihi = torch.ceil(hi[:, 0] * s + width // 2).long() + 1
    jlo = torch.floor(lo[:, 1] * s + height // 2).long() - 1
    jhi = torch.ceil(hi[:, 1] * s + height // 2).long() + 1
    ilo, ihi = ilo.clamp(0, width - 1), ihi.clamp(-1, width - 1)
    jlo, jhi = jlo.clamp(0, height - 1), jhi.clamp(-1, height - 1)
    nx = (ihi - ilo + 1).clamp(min=0)
    ny = (jhi - jlo + 1).clamp(min=0)
    cnt = (nx * ny).cpu()
    csum = torch.cumsum(cnt, 0)
    best = torch.full((width * height,), torch.iinfo(torch.int64).max,
                      dtype=torch.int64, device=dev)
    # triangles in runs whose (pixel, triangle) pairs fit a block
    first, nt = 0, pos.shape[0]
    while first < nt:
        base = int(csum[first - 1]) if first else 0
        last = int(torch.searchsorted(csum, base + BLOCK_PAIRS, right=True))
        last = max(last, first + 1)
        tri = torch.arange(first, last, device=dev)
        c = cnt[first:last].to(dev)
        first = last
        rep = torch.repeat_interleave(tri, c)
        if rep.numel() == 0:
            continue
        local = (torch.arange(rep.shape[0], device=dev)
                 - torch.repeat_interleave(torch.cumsum(c, 0) - c, c))
        ii = ilo[rep] + local % nx[rep]
        jj = jlo[rep] + local // nx[rep]
        pix = jj * width + ii
        o = primary_origins(pix, width, height, s)
        one = torch.ones_like(o[0])
        d = (torch.zeros_like(one), torch.zeros_like(one), one)
        ok, t = _mt(o, d, tuple(comps(x[rep]) for x in tris), eps)
        key = torch.where(ok, _key(t, rep), torch.iinfo(torch.int64).max)
        best.scatter_reduce_(0, pix, key, reduce="amin")
    return _from_keys(best)


# ---- shading ------------------------------------------------------------

def texture_table(scene: dict, cfg: dict):
    """The texels as the configuration stores them: UNORM8 (round half to
    even, read back as x / 255) for ``texture_dtype`` 'uint8', else as
    given."""
    tex = scene["textures"]
    if cfg["texture_dtype"] == "uint8":
        return torch.round(tex * 255.0) / 255.0
    return tex


def sample_texture(tex, tex_hw, tex_id, u, v):
    """Bilinear sample with wrap addressing (SampleLevel 0); tex_id -1 is
    white."""
    tid = torch.clamp(tex_id, min=0)
    hw = tex_hw[tid]
    h, w = hw[:, 0].to(u.dtype), hw[:, 1].to(u.dtype)
    x = (u - torch.floor(u)) * w - 0.5
    y = (v - torch.floor(v)) * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    wi, hi = hw[:, 1].long(), hw[:, 0].long()
    xi = torch.remainder(x0.long(), wi)
    yi = torch.remainder(y0.long(), hi)
    x1 = torch.remainder(xi + 1, wi)
    y1 = torch.remainder(yi + 1, hi)
    t00, t10 = tex[tid, yi, xi], tex[tid, yi, x1]
    t01, t11 = tex[tid, y1, xi], tex[tid, y1, x1]
    w00 = (1 - fx) * (1 - fy)
    w10 = fx * (1 - fy)
    w01 = (1 - fx) * fy
    w11 = fx * fy
    col = (t00 * w00[:, None] + t10 * w10[:, None] + t01 * w01[:, None]
           + t11 * w11[:, None])
    return torch.where((tex_id >= 0)[:, None], col, torch.ones_like(col))


def barycentric(t0, t1, t2, p):
    v0, v1, v2 = sub(t0, p), sub(t1, p), sub(t2, p)
    a0 = norm(cross(sub(t0, t1), sub(t0, t2)))
    a0 = torch.where(a0 == 0.0, 1.0, a0)
    return (norm(cross(v1, v2)) / a0, norm(cross(v2, v0)) / a0,
            norm(cross(v0, v1)) / a0)


def gather(table, idx):
    """``table[idx]`` whose gradient sums into ``table`` in float64: a
    material's gradient adds up millions of pixels' terms, which float32
    atomics would round by a part in a thousand."""
    if table.requires_grad:
        # index_select's gradient adds with atomics; indexing's sorts its
        # indices, which crawls where millions share a few rows
        return torch.index_select(table.double(), 0, idx).to(table.dtype)
    return table[idx]


def shade(o, d, hit, face, geo, mats, tex, tex_hw, vis=None):
    """A hit's surface from its face: (position, normal, colour [R, 4],
    shininess).  The distance is recomputed by Moeller-Trumbore, as the
    surface is a function of the vertices."""
    f = face
    corners = gather(geo["pos"], f)
    t0, t1, t2 = (comps(corners[:, k]) for k in range(3))
    e1, e2 = sub(t1, t0), sub(t2, t0)
    p = cross(d, e2)
    det = dot(e1, p)
    det_ok = torch.abs(det) >= 1e-12
    inv = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    tv = sub(o, t0)
    u = dot(tv, p) * inv
    q = cross(tv, e1)
    v = dot(d, q) * inv
    t = dot(e2, q) * inv
    ok = (det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > 1e-12))
    t = torch.where(ok, t, -1.0)
    t = torch.where(hit, t, 0.0)
    loc = tuple(o[i] + d[i] * t for i in range(3))
    w0, w1, w2 = barycentric(t0, t1, t2, loc)
    n = geo["nrm"][f]
    normal = tuple(n[:, 0, i] * w0 + n[:, 1, i] * w1 + n[:, 2, i] * w2
                   for i in range(3))
    uv = geo["uv"][f]
    uu = uv[:, 0, 0] * w0 + uv[:, 1, 0] * w1 + uv[:, 2, 0] * w2
    vv = uv[:, 0, 1] * w0 + uv[:, 1, 1] * w1 + uv[:, 2, 1] * w2
    m = geo["mat"][f]
    tex_id = mats["tex_id"][m].long()
    uu = torch.where(hit, uu, 0.0)
    vv = torch.where(hit, vv, 0.0)
    texel = sample_texture(tex, tex_hw, tex_id, uu, vv)
    diffuse = gather(mats["diffuse"], m)
    if vis is not None:
        diffuse = vis[:, None] * diffuse
    color = (torch.clamp(gather(mats["ambient"], m) + diffuse * texel, 0.0,
                         1.0) * gather(mats["specular"], m))
    return loc, normal, color, mats["shininess"][m]


def reflect(d, n):
    s = 2.0 * dot(d, n)
    return (d[0] - s * n[0], d[1] - s * n[1], d[2] - s * n[2])


def shadow_vis(o, d, hit, dist, light, pos, cfg):
    """The shadow factor of each primary hit: ``shadow_factor`` where a
    triangle lies between it and the light."""
    hx = tuple(o[i] + d[i] * dist for i in range(3))
    L = tuple(light[i] - hx[i] for i in range(3))
    ln = norm(L)
    inv = 1.0 / torch.clamp(ln, min=1e-30)
    dirn = tuple(L[i] * inv for i in range(3))
    so = tuple(hx[i] + dirn[i] * cfg["ray_offset"] for i in range(3))
    max_t = ln * (1.0 - 1e-4)
    occ = torch.zeros_like(hit)
    live = torch.nonzero(hit).squeeze(1)
    if live.numel():
        occ[live] = any_hits(tuple(c[live] for c in so),
                             tuple(c[live] for c in dirn), max_t[live], pos,
                             cfg["epsilon"])
    return torch.where(occ, torch.full_like(dist, cfg["shadow_factor"]),
                       torch.ones_like(dist))


def render_pixels(scene: dict, cam: dict, cfg: dict, pixels=None,
                  offsets=None, materials=None, stats=None, shadows=True):
    """Colours [P, 4] of the row-major ``pixels`` (all when None) of the
    frame of ``scene`` seen by ``cam`` under ``cfg`` (the renderer's
    configuration as a dict of its fields).  ``offsets`` (vertex offsets)
    and ``materials`` (a dict replacing the scene's diffuse and specular)
    may require grad: the colours are differentiable in them.  ``stats``,
    a list, receives (hits, distinct faces hit) of each pass that
    shades; ``shadows`` False leaves the shadow rays out (the colours are
    then not the frame's, the passes' hits are)."""
    if cfg.get("camera_mode", "reference") != "reference":
        raise ValueError("the reference renders the 'reference' camera mode")
    if cfg.get("enable_refraction"):
        raise ValueError("the reference has no refraction pass")
    geo, light = ray_space(scene, cam, cfg, offsets)
    mats = dict(scene["materials"])
    if materials is not None:
        mats.update(materials)
    tex = texture_table(scene, cfg)
    tex_hw = scene["tex_hw"].long()
    width, height = cfg["width"], cfg["height"]
    dev = scene["verts"].device
    if pixels is None:
        pixels = torch.arange(width * height, device=dev)
    hit, dist, face = (x[pixels] for x in primary_hits(geo["pos"], cfg))
    o = primary_origins(pixels, width, height, cfg["ortho_scale"])
    one = torch.ones_like(o[0])
    d = (torch.zeros_like(one), torch.zeros_like(one), one)
    bg = torch.tensor(cfg["background"], dtype=torch.float32, device=dev)
    vis = None
    if cfg["enable_shadows"] and shadows:
        vis = shadow_vis(o, d, hit, dist, comps(light), geo["pos"], cfg)
    if stats is not None:
        stats.append(_pass_stats(hit, face))
    loc, normal, hcol, shin = shade(o, d, hit, face, geo, mats, tex, tex_hw,
                                    vis)
    color = torch.where(hit[:, None], hcol, bg)
    intensity = torch.where(hit, shin / 1000.0 * cfg["reflection_decay"],
                            0.0)
    rdir = normalize(reflect(d, normal))
    ro = tuple(torch.where(hit, loc[i] + normal[i] * cfg["ray_offset"], o[i])
               for i in range(3))
    rd = tuple(torch.where(hit, rdir[i], d[i]) for i in range(3))
    for _ in range(cfg["bounces"]):
        color, ro, rd, intensity = _bounce(color, ro, rd, intensity, geo,
                                           mats, tex, tex_hw, bg, cfg, stats)
    return color


def _pass_stats(hit, face):
    return (int(hit.sum()), int(torch.unique(face[hit]).numel()))


def _bounce(color, o, d, intensity, geo, mats, tex, tex_hw, bg, cfg, stats):
    live = intensity > cfg["intensity_min"]
    idx = torch.nonzero(live).squeeze(1)
    hit = torch.zeros_like(live)
    face = torch.zeros_like(live, dtype=torch.int64)
    if idx.numel():
        h, _, f = nearest_hits(tuple(c.detach()[idx] for c in o),
                               tuple(c.detach()[idx] for c in d), geo["pos"],
                               cfg["epsilon"])
        hit[idx] = h
        face[idx] = f
    if stats is not None:
        stats.append(_pass_stats(hit, face))
    loc, normal, hcol, shin = shade(o, d, hit, face, geo, mats, tex, tex_hw)
    target = torch.where(hit[:, None], hcol, bg)
    new_color = torch.where(live[:, None],
                            color + intensity[:, None] * (target - color),
                            color)
    upd = live & hit
    new_int = torch.where(upd, intensity * shin / 1000.0
                          * cfg["reflection_decay"], 0.0)
    ndir = normalize(reflect(d, normal))
    no = tuple(torch.where(upd, loc[i] + normal[i] * cfg["bounce_ray_offset"],
                           o[i]) for i in range(3))
    nd = tuple(torch.where(upd, ndir[i], d[i]) for i in range(3))
    return new_color, no, nd, new_int


def render(scene: dict, cam: dict, cfg: dict, **kw):
    """The whole frame [height, width, 4]."""
    return render_pixels(scene, cam, cfg, **kw).reshape(
        cfg["height"], cfg["width"], 4)

