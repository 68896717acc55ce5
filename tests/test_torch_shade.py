"""The port's shading helpers against the JAX package's ``ops/shade.py``.
Tolerance: exact equality (the same float32 operations in the same
order, run eagerly on both sides)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracebvh_tpu.ops import shade as j_shade
from raytracebvh_tpu_torch.ops import shade as t_shade


def _textures(rng):
    """Two textures of different sizes in one padded stack."""
    from raytracebvh_tpu.core.types import stack_textures

    a = rng.integers(0, 256, (12, 20, 4)) / 255.0
    b = rng.integers(0, 256, (16, 8, 4)) / 255.0
    stack, hw = stack_textures([a.astype(np.float32), b.astype(np.float32)])
    return stack, hw


def _vec(rng, r):
    return tuple(rng.normal(size=r).astype(np.float32) for _ in range(3))


def _j(v):
    return tuple(jnp.asarray(c) for c in v)


def _t(v):
    return tuple(torch.from_numpy(c) for c in v)


def _eq(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_vector_helpers_equal():
    rng = np.random.default_rng(0)
    a, b, c, p = (_vec(rng, 500) for _ in range(4))
    eta = rng.uniform(0.5, 2.0, 500).astype(np.float32)
    _eq(t_shade.cross3(_t(a), _t(b)), j_shade.cross3(_j(a), _j(b)))
    _eq([t_shade.dot3(_t(a), _t(b))], [j_shade.dot3(_j(a), _j(b))])
    _eq(t_shade.normalize3(_t(a)), j_shade.normalize3(_j(a)))
    _eq(t_shade.reflect3(_t(a), _t(b)), j_shade.reflect3(_j(a), _j(b)))
    na, nb = t_shade.normalize3(_t(a)), j_shade.normalize3(_j(a))
    _eq(t_shade.refract3(_t(b), na, torch.from_numpy(eta)),
        j_shade.refract3(_j(b), nb, jnp.asarray(eta)))
    _eq(t_shade.barycentric_weights3(_t(a), _t(b), _t(c), _t(p)),
        j_shade.barycentric_weights3(_j(a), _j(b), _j(c), _j(p)))


def test_pack_and_quantize_quads_equal():
    rng = np.random.default_rng(1)
    stack, hw = _textures(rng)
    jq = j_shade.pack_texture_quads(jnp.asarray(stack), jnp.asarray(hw))
    tq = t_shade.pack_texture_quads(torch.from_numpy(stack),
                                    torch.from_numpy(hw))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(t_shade.quantize_quads_u8(tq).numpy(),
                                  np.asarray(j_shade.quantize_quads_u8(jq)))


@pytest.mark.parametrize("u8", [False, True])
@pytest.mark.parametrize("ntex", [1, 2])
def test_sample_texture_quads_equal(u8, ntex):
    """Row-major quad sampling, float32 and UNORM8, one texture (scalar
    dims) and two (per-ray dims); tex_id -1 samples white."""
    rng = np.random.default_rng(2 + ntex)
    stack, hw = _textures(rng)
    stack, hw = stack[:ntex], hw[:ntex]
    r = 700
    tex_id = rng.integers(-1, ntex, r).astype(np.int32)
    u = rng.uniform(-2.0, 3.0, r).astype(np.float32)
    v = rng.uniform(-2.0, 3.0, r).astype(np.float32)
    hmax, wmax = stack.shape[1], stack.shape[2]
    jq = j_shade.pack_texture_quads(jnp.asarray(stack), jnp.asarray(hw))
    tq = t_shade.pack_texture_quads(torch.from_numpy(stack),
                                    torch.from_numpy(hw))
    if u8:
        jq, tq = j_shade.quantize_quads_u8(jq), t_shade.quantize_quads_u8(tq)
    want = j_shade.sample_texture_quads(
        jq, jnp.asarray(hw), jnp.asarray(tex_id), jnp.asarray(u),
        jnp.asarray(v), hmax, wmax)
    got = t_shade.sample_texture_quads(
        tq, torch.from_numpy(hw), torch.from_numpy(tex_id),
        torch.from_numpy(u), torch.from_numpy(v), hmax, wmax)
    _eq(got, want)
    # the 'cuda' backend on CPU tensors is the same plain gather
    again = t_shade.sample_texture_quads(
        tq, torch.from_numpy(hw), torch.from_numpy(tex_id),
        torch.from_numpy(u), torch.from_numpy(v), hmax, wmax, backend="cuda")
    _eq(again, want)
