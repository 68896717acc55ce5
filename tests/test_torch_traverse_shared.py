"""The port's on-chip traversal entry points (kernels K5 and K6,
``ops/traverse_shared_cuda``) against the JAX package's whole-tree-in-VMEM
kernels ``traverse_pallas`` and ``traverse_any_pallas`` in interpret mode,
as ``tests/test_traverse_pallas.py`` runs them; the routing rule of
``auto`` and ``shared``; and a shadowed frame through the on-chip
backends against the JAX frame through ``pallas``.

On CPU tensors the K5/K6 wrappers run the plain walks, which are their
plain versions as they are K1/K4's.  Both sides walk the very tree the JAX
build made (``bvh_from_numpy``).  Tolerances: hit and leaf exact; distance
within rtol 2e-5, the JAX package's own K5 tolerance (the interpret-mode
kernel's compiled loop body may contract a*b + c into FMAs); any-hit flags
exact, with max_t random or 2e-6 (relative) away from hit distances, as
ROADMAP queue 3 says; the frame within atol 1e-4 of the jitted JAX frame,
the shadow rule of ``tests/test_torch_shadows.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracebvh_tpu as J
from raytracebvh_tpu.core.types import scene_to_device
from raytracebvh_tpu.models.procedural import random_triangles as j_random
from raytracebvh_tpu.ops.traverse_pallas import (traverse_any_pallas,
                                                 traverse_pallas)
import raytracebvh_tpu_torch as T
from raytracebvh_tpu_torch import pipeline as tp
from raytracebvh_tpu_torch.core.types import bvh_from_numpy
from raytracebvh_tpu_torch.models.procedural import random_triangles as t_random
from raytracebvh_tpu_torch.ops import traverse_cuda, traverse_shared_cuda

from test_torch_shadows import LIGHT, _max_t, _straddle
from test_torch_traverse import _both, _jax_bvh, _random_rays

EPS = 0.01
H100_SMEM = 232448  # opt-in shared memory a block may use on an H100


def _launches():
    return (traverse_shared_cuda.launches, traverse_shared_cuda.any_launches,
            traverse_cuda.launches, traverse_cuda.any_launches)


@pytest.mark.parametrize("num_tris,seed,nrays", [(60, 0, 384), (700, 1, 512)])
def test_k5_entry_matches_interpret_mode_traverse_pallas(num_tris, seed, nrays):
    jb = _jax_bvh(num_tris, seed)
    jr, tr = _both(*_random_rays(nrays, seed + 50))
    want = traverse_pallas(jb, jr, epsilon=EPS, interpret=True)
    before = _launches()
    got, steps = traverse_shared_cuda.traverse(bvh_from_numpy(jb, "cpu"), tr, EPS,
                                               return_steps=True)
    assert _launches() == before  # CPU tensors: the plain walk
    hit = np.asarray(want.hit)
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.leaf.numpy()[hit],
                                  np.asarray(want.leaf)[hit])
    np.testing.assert_allclose(got.distance.numpy()[hit],
                               np.asarray(want.distance)[hit], rtol=2e-5,
                               atol=2e-5)
    assert int(steps.min()) >= 1


@pytest.mark.parametrize("num_tris,seed,nrays", [(60, 0, 384), (700, 1, 512)])
def test_k6_entry_matches_interpret_mode_traverse_any_pallas(num_tris, seed,
                                                             nrays):
    """Random max_t, and max_t 2e-6 above and below each nearest hit."""
    jb = _jax_bvh(num_tris, seed)
    tb = bvh_from_numpy(jb, "cpu")
    jr, tr = _both(*_random_rays(nrays, seed + 50))
    (hi, lo), hit = _straddle(tb, tr, 2e-6)
    assert hit.any()
    occs = []
    for m in (_max_t(nrays, seed), hi, lo):
        want = np.asarray(traverse_any_pallas(jb, jr, EPS, jnp.asarray(m),
                                              interpret=True))
        before = _launches()
        got = traverse_shared_cuda.traverse_any(tb, tr, EPS,
                                                torch.from_numpy(m))
        assert _launches() == before
        np.testing.assert_array_equal(got.numpy(), want)
        occs.append(want)
    assert occs[0].any() and occs[1][hit].all() and not occs[2][hit].any()


@pytest.mark.parametrize("n_leaves,smem,fits", [
    (3072, H100_SMEM, True),  # the dense scene: 98 272 bytes
    (7168, H100_SMEM, True),  # 229 344 bytes, the largest multiple of 256
    (7265, H100_SMEM, True),  # (n - 1) * 32 == 232 448: at the capacity
    (7266, H100_SMEM, False),  # one leaf above it
    (102400, H100_SMEM, False),  # the large scene
    (32767, None, True),  # the JAX kernel's cap: 2n < 0xFFFF
    (32768, None, False),
    (32767, 1 << 30, True),
    (32768, 1 << 30, False),
    (1, None, False),
])
def test_shared_capacity_rule(n_leaves, smem, fits):
    assert traverse_shared_cuda.fits(n_leaves, smem) is fits
    assert traverse_shared_cuda.shared_bytes(n_leaves) == (n_leaves - 1) * 32


@pytest.mark.parametrize("n_leaves,first", [
    (2, 0),
    (512, 0),
    (3072, 0),  # the dense scene: all 6 143 records, 196 576 bytes
    (3632, 0),  # 7 263 records, 232 416 bytes: the most that fit
    (3633, 3633),  # 232 480 bytes: the internal nodes only
    (7265, 7265),
])
def test_staged_set(n_leaves, first):
    """K5/K6 stage every node record where all 2n - 1 fit an H100 block,
    else the internal nodes (which ``fits`` guarantees)."""
    assert traverse_shared_cuda.staged_first(n_leaves, H100_SMEM) == first
    staged = (2 * n_leaves - 1 - first) * traverse_shared_cuda.NODE_BYTES
    assert staged <= H100_SMEM


@pytest.mark.parametrize("nrays,grid,one_round", [
    (1, 1, True),
    (100, 4, True),  # at least 32 rays a block
    (25600, 132, True),  # a sparse chunk: every SM, not the first 25
    (135168, 132, True),  # one round of 132 x 1 024 threads exactly
    (135169, 132, False),  # above: the work queue's atomics
    (2073600, 132, False),  # the dense frame
])
def test_launch_geometry(nrays, grid, one_round):
    """A block for each of an H100's 132 SMs (at least 32 rays a block),
    so no block is without rays; the kernel's first round, a 32-ray batch
    a warp, covers a launch of up to 132 x 1 024 rays, and only a larger
    one takes batches from the work queue."""
    assert traverse_shared_cuda.launch_geometry(nrays, 132) == grid
    assert (grid - 1) * 32 < nrays
    warps = grid * traverse_shared_cuda.BLOCK // 32
    assert (-(-nrays // 32) <= warps) is one_round


@pytest.mark.parametrize("backend,n_leaves,want", [
    ("auto", 3072, "shared"),
    ("shared", 3072, "shared"),
    ("auto", 32767, "shared"),  # on the CPU only the JAX cap applies
    ("auto", 32768, "cuda"),  # above it, as the JAX auto takes hbm
    ("shared", 32768, "cuda"),  # as the JAX explicit pallas does
    ("cuda", 3072, "cuda"),
    ("torch", 3072, "torch"),
])
def test_resolve_traversal_backend_on_cpu(backend, n_leaves, want):
    cfg = T.RenderConfig(traversal_backend=backend)
    assert tp.resolve_traversal_backend(cfg, n_leaves,
                                        torch.device("cpu")) == want


_FRAME = dict(width=32, height=32, bounces=1, enable_shadows=True,
              light_pos=LIGHT, ortho_scale=1.4)


@pytest.fixture(scope="module")
def onchip_frames():
    """tests/test_torch_shadows.py's 300-triangle scene in a 32x32 frame
    with shadows and a bounce (18% of pixels hit): JAX through pallas /
    pallas / bitonic (interpret mode, jitted, computed once), the port
    through shared / shared / bitonic.  (On the 120-triangle scene of
    tests/test_traverse_pallas.py the jitted frame's FMAs move some
    bounce pixels by up to 2.4e-3 whatever the backends: ROADMAP queue 3.)"""
    kw = dict(seed=7, with_texture=True)
    js = scene_to_device(j_random(300, **kw))
    ts = t_random(300, device="cpu", **kw)
    want = np.asarray(J.render_frame_jit(js, J.Camera.default(), J.RenderConfig(
        **_FRAME, traversal_backend="pallas", shade_gather_backend="pallas",
        sort_backend="bitonic")))
    cfg = T.RenderConfig(**_FRAME, traversal_backend="shared",
                         shade_gather_backend="shared", sort_backend="bitonic")
    got = T.render_frame(ts, T.Camera.default("cpu"), cfg)
    return got, want, ts, cfg


def test_onchip_frame_matches_jax_pallas_frame(onchip_frames):
    got, want, _, _ = onchip_frames
    bg = np.asarray(J.RenderConfig().background, np.float32)
    hits = ~(np.abs(want - bg) < 1e-6).all(-1)
    assert 0.1 < hits.mean() < 0.9
    assert got.shape == (32, 32, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_onchip_frame_equals_default_backends(onchip_frames):
    """On the CPU every backend runs the plain versions: the on-chip
    backends' frame equals the default one bit for bit, and no kernel
    launch is counted."""
    got, _, ts, cfg = onchip_frames
    before = _launches()
    default = T.render_frame(ts, T.Camera.default("cpu"), cfg.replace(
        traversal_backend="auto", shade_gather_backend="auto",
        sort_backend="lax"))
    assert _launches() == before
    assert torch.equal(got, default)
