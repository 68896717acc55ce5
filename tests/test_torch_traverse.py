"""The port's nearest-hit traversal against the JAX package.

Both sides walk the very tree the JAX build made (``bvh_from_numpy``).
Tolerances: hit and leaf exact.  Distance within rtol 1e-6 of the JAX
``traverse``: the same operations in the same order, but XLA compiles
the while_loop body for the CPU and may contract a*b + c into one FMA,
which PyTorch never does (a last-ulp difference).  Within 2e-5 of the
interpret-mode TPU kernel K1 (``traverse_hbm_pallas``), the bound the
JAX package's own K1 test uses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracebvh_tpu as J
from raytracebvh_tpu.camera import camera_matrices as j_camera_matrices
from raytracebvh_tpu.core.types import Rays as JRays
from raytracebvh_tpu.core.types import scene_to_device
from raytracebvh_tpu.models.procedural import random_triangles
from raytracebvh_tpu.ops.traverse import traverse as j_traverse
from raytracebvh_tpu.ops.traverse_hbm import traverse_hbm_pallas
from raytracebvh_tpu.pipeline import build_bvh as j_build_bvh
from raytracebvh_tpu_torch.core.types import Rays, bvh_from_numpy
from raytracebvh_tpu_torch.ops import traverse as t_traverse
from raytracebvh_tpu_torch.ops import traverse_cuda

EPS = 0.01


def _jax_bvh(num_tris, seed):
    scene = scene_to_device(random_triangles(num_tris, seed=seed))
    cfg = J.RenderConfig(width=16, height=16)
    wvp, wv = j_camera_matrices(J.Camera.default(), 16, 16)
    return jax.jit(lambda s: j_build_bvh(s, wvp, wv, cfg))(scene)


def _random_rays(nrays, seed, lo=-60, hi=60):
    rng = np.random.default_rng(seed)
    origin = rng.uniform(lo, hi, (nrays, 3)).astype(np.float32)
    direction = rng.normal(size=(nrays, 3)).astype(np.float32)
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    return origin, direction


def _on_plane_rays(jb, nrays, seed):
    """Reference-camera rays (direction (0, 0, 1), so 1/d is inf on x and
    y) whose origins lie exactly on a box plane: 0 * inf = NaN in the
    slab test, and the box must be missed, as torch.minimum/maximum (and
    jnp's) propagate the NaN."""
    rng = np.random.default_rng(seed)
    n = jb.n_leaves
    bbmin, bbmax = np.asarray(jb.bbmin), np.asarray(jb.bbmax)
    nodes = rng.integers(n, 2 * n - 1, nrays)  # internal boxes
    lo, hi = bbmin[nodes], bbmax[nodes]
    mid = 0.5 * (lo + hi)
    axis = rng.integers(0, 2, nrays)  # x or y plane
    side = rng.integers(0, 2, nrays)
    origin = mid.copy()
    plane = np.where(side[:, None] == 1, hi, lo)
    origin[np.arange(nrays), axis] = plane[np.arange(nrays), axis]
    origin[:, 2] = lo[:, 2] - 1.0
    direction = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (nrays, 1))
    return origin.astype(np.float32), direction


def _both(origin, direction):
    return (JRays(origin=jnp.asarray(origin), direction=jnp.asarray(direction)),
            Rays(origin=torch.from_numpy(origin),
                 direction=torch.from_numpy(direction)))


def _assert_records_equal(got, want, rtol=0.0, atol=0.0):
    hit = np.asarray(want.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.leaf.numpy(), np.asarray(want.leaf))
    np.testing.assert_allclose(got.distance.numpy()[hit],
                               np.asarray(want.distance)[hit],
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("num_tris,seed,nrays", [(60, 0, 384), (400, 1, 512)])
def test_plain_matches_jax_traverse(num_tris, seed, nrays):
    jb = _jax_bvh(num_tris, seed)
    jr, tr = _both(*_random_rays(nrays, seed + 50))
    want = jax.jit(lambda b, r: j_traverse(b, r, EPS))(jb, jr)
    got = t_traverse.traverse(bvh_from_numpy(jb), tr, EPS)
    assert np.asarray(want.hit).any() and not np.asarray(want.hit).all()
    _assert_records_equal(got, want, rtol=1e-6)


def test_plain_matches_interpret_mode_k1():
    jb = _jax_bvh(300, 2)
    jr, tr = _both(*_random_rays(256, 7))
    want = traverse_hbm_pallas(jb, jr, EPS, win=256, block_rays=256,
                               interpret=True)
    got = t_traverse.traverse(bvh_from_numpy(jb), tr, EPS)
    _assert_records_equal(got, want, rtol=2e-5, atol=2e-5)


def test_on_plane_rays_miss_like_jax():
    jb = _jax_bvh(300, 3)
    origin, direction = _on_plane_rays(jb, 512, 9)
    jr, tr = _both(origin, direction)
    want = jax.jit(lambda b, r: j_traverse(b, r, EPS))(jb, jr)
    got = t_traverse.traverse(bvh_from_numpy(jb), tr, EPS)
    _assert_records_equal(got, want, rtol=1e-6)
    # the slab test really met NaN on these rays
    t = (torch.from_numpy(np.asarray(jb.bbmin))[None, :, 0]
         - torch.from_numpy(origin)[:, None, 0]) * (1.0 / tr.direction[:, :1])
    assert torch.isnan(t).any()
    # and the interpret-mode TPU kernel agrees
    k1 = traverse_hbm_pallas(jb, jr, EPS, win=256, block_rays=256,
                             interpret=True)
    _assert_records_equal(got, k1, rtol=2e-5, atol=2e-5)


def test_steps_and_cap():
    """Per-ray steps: the full walk ends within 4n; a cap of 3 stops
    every ray after three nodes with its best hit so far."""
    jb = _jax_bvh(200, 4)
    _, tr = _both(*_random_rays(256, 11))
    tb = bvh_from_numpy(jb)
    rec, steps = t_traverse.traverse(tb, tr, EPS, return_steps=True)
    assert int(steps.min()) >= 1 and int(steps.max()) <= 4 * tb.n_leaves
    capped, csteps = t_traverse.traverse(tb, tr, EPS, max_steps=3,
                                         return_steps=True)
    assert int(csteps.max()) == 3
    assert not (capped.hit & ~rec.hit).any()


def test_cpu_wrapper_runs_plain_version_without_launching():
    jb = _jax_bvh(120, 5)
    _, tr = _both(*_random_rays(256, 13))
    tb = bvh_from_numpy(jb)
    before = traverse_cuda.launches
    got = traverse_cuda.traverse(tb, tr, EPS)
    want = t_traverse.traverse(tb, tr, EPS)
    assert traverse_cuda.launches == before
    for f in ("hit", "leaf", "distance"):
        assert torch.equal(getattr(got, f), getattr(want, f))


def test_pack_tables_layout():
    """K1's node table carries the boxes and the links as int bits; the
    leaf table v0 and the edges computed as the plain version does."""
    tb = bvh_from_numpy(_jax_bvh(100, 6))
    nodes, leaves = traverse_cuda.pack_tables(tb)
    n = tb.n_leaves
    assert nodes.shape == (2 * n, 8) and leaves.shape == (n, 12)
    assert torch.equal(nodes[:, 0:3], tb.bbmin)
    assert torch.equal(nodes[:, 3:6], tb.bbmax)
    links = nodes[:, 6:8].contiguous().view(torch.int32)
    assert torch.equal(links[:, 0], tb.entry_link)
    assert torch.equal(links[:, 1], tb.skip_link)
    tv = tb.tri_verts
    assert torch.equal(leaves[:, 0:3], tv[:, 0])
    assert torch.equal(leaves[:, 3:6], tv[:, 1] - tv[:, 0])
    assert torch.equal(leaves[:, 6:9], tv[:, 2] - tv[:, 0])
