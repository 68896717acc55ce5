"""30-bit Morton codes for triangle centroids (the JAX package's
``ops/morton.py`` in torch).

Codes are held as int32: torch supports few ops on uint32, and 30 bits
fit.  The centroid is the true average of the three transformed
vertices.
"""

from __future__ import annotations

import torch

from .ieee import div

# padding leaves: all 30 payload bits set, so they sort after every leaf
SENTINEL_CODE = 0x3FFFFFFF


def expand_bits10(v):
    """Spread the low 10 bits of each lane to every 3rd bit (the
    reference's byte-mask cascade)."""
    v = v.to(torch.int32) & 0x000003FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _quantize(unit):
    """Unit-cube coordinate -> integer cell in [0, 1023] (truncating)."""
    return torch.clamp(unit * 1024.0, 0.0, 1023.0).to(torch.int32)


def morton_code(p):
    """[..., 3] points in the unit cube -> [...] int32 codes:
    x | y << 1 | z << 2 of the 10-bit cells."""
    q = _quantize(p)
    return (expand_bits10(q[..., 0]) | (expand_bits10(q[..., 1]) << 1)
            | (expand_bits10(q[..., 2]) << 2))


def triangle_leaves(verts_t, indices, scene_min, scene_max):
    """Per-triangle morton codes and AABBs from transformed vertices.

    Returns codes [nf] int32, bbmin [nf, 3], bbmax [nf, 3],
    centroid [nf, 3]."""
    i0, i1, i2 = indices[0::3], indices[1::3], indices[2::3]
    r0, r1, r2 = verts_t[i0], verts_t[i1], verts_t[i2]
    mins, maxs, cens = [], [], []
    for k in range(3):
        c0, c1, c2 = r0[:, k], r1[:, k], r2[:, k]
        mins.append(torch.minimum(torch.minimum(c0, c1), c2))
        maxs.append(torch.maximum(torch.maximum(c0, c1), c2))
        cens.append(div(c0 + c1 + c2, 3.0))
    scaled = [
        _quantize((cens[k] - scene_min[k]) / (scene_max[k] - scene_min[k]))
        for k in range(3)
    ]
    codes = (expand_bits10(scaled[0]) | (expand_bits10(scaled[1]) << 1)
             | (expand_bits10(scaled[2]) << 2))
    return (codes, torch.stack(mins, -1), torch.stack(maxs, -1),
            torch.stack(cens, -1))


def scene_aabb(verts_t):
    """Scene AABB by reduction."""
    return verts_t.amin(dim=0), verts_t.amax(dim=0)
