"""Shading helpers: component vector math, barycentric weights, texture
quad tables and bilinear sampling (the structure-of-arrays half of the
JAX package's ``ops/shade.py`` in torch, op for op, so results match
bit for bit).

Vectors are 3-tuples of [R] component tensors.  Texture sampling reads
one 16-channel quad row per sample (the 2x2 bilinear neighbourhood,
``pack_texture_quads``), in float32 or UNORM8 (``quantize_quads_u8``);
the row gather is kernel K2 (``ops.gather_cuda``).
"""

from __future__ import annotations

import torch

from . import gather_cuda
from .ieee import sqrt
from ..utils import profiling


def cross3(a, b):
    ax, ay, az = a
    bx, by, bz = b
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def norm3(a):
    return sqrt(dot3(a, a))


def normalize3(v, eps=1e-30):
    inv = 1.0 / torch.clamp(norm3(v), min=eps)
    return (v[0] * inv, v[1] * inv, v[2] * inv)


def reflect3(d, n):
    """HLSL reflect on components."""
    s = 2.0 * dot3(d, n)
    return (d[0] - s * n[0], d[1] - s * n[1], d[2] - s * n[2])


def refract3(d, n, eta):
    """HLSL refract on components; (0, 0, 0) on total internal reflection."""
    cosi = dot3(d, n)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    s = eta * cosi + sqrt(torch.clamp(k, min=0.0))
    ok = k >= 0.0
    return tuple(torch.where(ok, eta * d[i] - s * n[i], 0.0) for i in range(3))


def barycentric_weights3(tri0, tri1, tri2, point):
    """Area-ratio weights (w0, w1, w2) at ``point`` (sub-triangle areas
    over the full parallelogram area, as the reference's
    getNromalTexCoord)."""
    v0 = sub3(tri0, point)
    v1 = sub3(tri1, point)
    v2 = sub3(tri2, point)
    e01 = sub3(tri0, tri1)
    e02 = sub3(tri0, tri2)
    a0 = norm3(cross3(e01, e02))
    a0 = torch.where(a0 == 0.0, 1.0, a0)
    w0 = norm3(cross3(v1, v2)) / a0
    w1 = norm3(cross3(v2, v0)) / a0
    w2 = norm3(cross3(v0, v1)) / a0
    return w0, w1, w2


def _texel_dims(tex_hw, tid, dtype):
    """Per-ray texture (h, w): scalars for a one-texture scene, else one
    [R, 2] row gather."""
    if tex_hw.shape[0] == 1:
        return tex_hw[0, 0].to(dtype), tex_hw[0, 1].to(dtype)
    hw = tex_hw[tid]
    return hw[:, 0].to(dtype), hw[:, 1].to(dtype)


def pack_texture_quads(textures, tex_hw):
    """[T, H, W, 4] -> [T*H*W, 16]: row (t, y, x) holds the 2x2 wrap
    neighbourhood {(y, x), (y, x+1), (y+1, x), (y+1, x+1)}, RGBA-major.

    Textures smaller than the padded stack wrap at their true size
    (tex_hw): each texture's wrap column/row is first copied into its
    first padding column/row; a texture filling the stack wraps via the
    roll itself."""
    t, h, w, c = textures.shape
    dev = textures.device
    ht = tex_hw[:, 0].to(torch.int32)[:, None, None, None]
    wt = tex_hw[:, 1].to(torch.int32)[:, None, None, None]
    col = torch.arange(w, dtype=torch.int32, device=dev)[None, None, :, None]
    row = torch.arange(h, dtype=torch.int32, device=dev)[None, :, None, None]
    fixed = torch.where(col == wt, textures[:, :, 0:1, :], textures)
    fixed = torch.where(row == ht, fixed[:, 0:1, :, :], fixed)
    x1 = torch.roll(fixed, -1, dims=2)
    y1 = torch.roll(fixed, -1, dims=1)
    xy1 = torch.roll(x1, -1, dims=1)
    quads = torch.cat([fixed, x1, y1, xy1], dim=-1)  # [T, H, W, 16]
    return quads.reshape(t * h * w, 4 * c)


def quantize_quads_u8(tex_quads):
    """[*, 16] float quads in [0, 1] -> uint8 (UNORM8, round half even).
    Bit-exact with the float path for 8-bit-sourced textures; not
    differentiable."""
    return torch.round(tex_quads * 255.0).to(torch.uint8)


def sample_texture_quads(tex_quads, tex_hw, tex_id, u, v, hmax, wmax,
                         backend: str = "torch"):
    """Bilinear wrap sample via ONE quad-row gather per ray (DirectX
    SampleLevel-0 with wrap addressing); tex_id -1 samples white.

    ``tex_quads`` is the row-major [T*hmax*wmax, 16] table, float32 or
    uint8 (unpacked as ``x / 255``).  The colour's dtype is the uv dtype
    for a uint8 table, else the promotion of the two, as in the JAX
    package.  ``backend`` picks the row gather:
    'torch' (plain indexing) or 'cuda' (kernel K2's wrapper)."""
    tid = torch.clamp(tex_id, min=0)
    h, w = _texel_dims(tex_hw, tid, u.dtype)
    uu = u - torch.floor(u)
    vv = v - torch.floor(v)
    x = uu * w - 0.5
    y = vv * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    xi = x0.to(torch.int32)
    yi = y0.to(torch.int32)
    # u - floor(u) puts x0 in [-1, w-1]: wrap is a select, not a mod
    xi = torch.where(xi < 0, xi + w.to(torch.int32), xi)
    yi = torch.where(yi < 0, yi + h.to(torch.int32), yi)
    flat = (tid * hmax + yi) * wmax + xi
    with profiling.span("gather", flat):
        q = gather_cuda.gather_for(backend)(tex_quads, flat)  # [16, R] f32
    if tex_quads.dtype == torch.uint8:
        # UNORM8 samples take the uv dtype; a float table promotes the
        # colour instead (a float32 table lifts a bfloat16 frame to float32)
        q = q.to(u.dtype)
    w00 = (1 - fx) * (1 - fy)
    w10 = fx * (1 - fy)
    w01 = (1 - fx) * fy
    w11 = fx * fy
    has_tex = tex_id >= 0
    out = []
    for c in range(4):
        col = q[c] * w00 + q[4 + c] * w10 + q[8 + c] * w01 + q[12 + c] * w11
        out.append(torch.where(has_tex, col, torch.ones_like(col)))
    return tuple(out)
