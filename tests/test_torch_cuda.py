"""Kernels K1, K2 and K4 against their plain PyTorch versions on the GPU.

Marked ``gpu``: they skip without a CUDA device (a CUDA kernel has no
CPU mode; the CPU tests hold the plain versions against the JAX
package).  On a GPU machine, which need not have JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py

Tolerances: K2 exact; K1 hit and leaf exact, distance exact; K4's
occlusion flags exact, max_t one ulp around hit distances included (the
kernels are built with -fmad=false and IEEE division, so they round as
the plain versions' separate PyTorch ops do).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _bvh(dev, num_tris=2000, seed=0):
    import raytracebvh_tpu_torch as T
    from raytracebvh_tpu_torch.camera import camera_matrices
    from raytracebvh_tpu_torch.models.procedural import random_triangles

    scene = random_triangles(num_tris, seed=seed).to(dev)
    wvp, wv = camera_matrices(T.Camera.default(dev), 64, 64)
    return T.build_bvh(scene, wvp, wv, T.RenderConfig(width=64, height=64))


def _rays(dev, nrays, seed):
    from raytracebvh_tpu_torch.core.types import Rays

    rng = np.random.default_rng(seed)
    o = rng.uniform(-150, 150, (nrays, 3)).astype(np.float32)
    d = rng.normal(size=(nrays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return Rays(torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev))


def _assert_same(got, want):
    assert torch.equal(got.hit, want.hit)
    assert torch.equal(got.leaf, want.leaf)
    assert torch.equal(got.distance, want.distance)


def test_k1_matches_plain_random_rays(dev):
    from raytracebvh_tpu_torch.ops import traverse, traverse_cuda

    bvh = _bvh(dev)
    rays = _rays(dev, 20000, 1)
    before = traverse_cuda.launches
    got, steps = traverse_cuda.traverse(bvh, rays, 0.01, return_steps=True)
    want, wsteps = traverse.traverse(bvh, rays, 0.01, return_steps=True)
    assert traverse_cuda.launches == before + 1
    assert 0 < int(want.hit.sum()) < rays.origin.shape[0]
    _assert_same(got, want)
    assert torch.equal(steps, wsteps)


def test_k1_on_plane_rays_miss_like_plain(dev):
    """direction (0, 0, 1) and origins exactly on box planes: the slab
    test meets 0 * inf = NaN and must miss, as torch.minimum does."""
    from raytracebvh_tpu_torch.core.types import Rays
    from raytracebvh_tpu_torch.ops import traverse, traverse_cuda

    bvh = _bvh(dev, 500, 2)
    n = bvh.n_leaves
    gen = torch.Generator(device="cpu").manual_seed(3)
    nodes = torch.randint(0, 2 * n - 1, (4096,), generator=gen).to(dev)
    lo, hi = bvh.bbmin[nodes], bvh.bbmax[nodes]
    o = 0.5 * (lo + hi)
    o[:2048, 0] = lo[:2048, 0]
    o[2048:, 1] = hi[2048:, 1]
    o[:, 2] = lo[:, 2] - 1.0
    o = torch.where(torch.isfinite(o), o, 0.0).contiguous()
    d = torch.tensor([0.0, 0.0, 1.0], device=dev).expand_as(o).contiguous()
    rays = Rays(o, d)
    _assert_same(traverse_cuda.traverse(bvh, rays, 0.01),
                 traverse.traverse(bvh, rays, 0.01))


def test_k1_step_cap_counts_truncated_rays(dev):
    from raytracebvh_tpu_torch.ops import traverse, traverse_cuda

    bvh = _bvh(dev)
    rays = _rays(dev, 4096, 4)
    traverse_cuda.reset_truncated()
    got, steps = traverse_cuda.traverse(bvh, rays, 0.01, max_steps=5,
                                        return_steps=True)
    want = traverse.traverse(bvh, rays, 0.01, max_steps=5)
    _assert_same(got, want)
    full = traverse.traverse(bvh, rays, 0.01, return_steps=True)[1]
    assert traverse_cuda.truncated_rays() == int((full > 5).sum()) > 0
    traverse_cuda.reset_truncated()
    assert traverse_cuda.truncated_rays() == 0


def _max_t(dev, nrays, seed, lo=5.0, hi=300.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(lo, hi, nrays).astype(np.float32)).to(dev)


def test_k4_matches_plain_random_rays(dev):
    """Random max_t, and max_t one ulp above, at, and one ulp below each
    ray's nearest hit distance."""
    from raytracebvh_tpu_torch.ops import traverse, traverse_cuda

    bvh = _bvh(dev)
    rays = _rays(dev, 20000, 5)
    max_t = _max_t(dev, 20000, 6)
    traverse_cuda.reset_truncated()
    before = traverse_cuda.any_launches
    got, steps = traverse_cuda.traverse_any(bvh, rays, 0.01, max_t,
                                            return_steps=True)
    want, wsteps = traverse.traverse_any(bvh, rays, 0.01, max_t,
                                         return_steps=True)
    assert traverse_cuda.any_launches == before + 1
    assert 0 < int(want.sum()) < rays.origin.shape[0]
    assert torch.equal(got, want)
    assert torch.equal(steps, wsteps)
    rec = traverse.traverse(bvh, rays, 0.01)
    t = torch.where(rec.hit, rec.distance, 100.0)
    for m in (torch.nextafter(t, torch.full_like(t, float("inf"))), t,
              torch.nextafter(t, torch.zeros_like(t))):
        occ = traverse_cuda.traverse_any(bvh, rays, 0.01, m.contiguous())
        assert torch.equal(occ, traverse.traverse_any(bvh, rays, 0.01, m))
    assert traverse_cuda.truncated_rays() == 0


def test_k4_on_plane_rays_match_plain(dev):
    """direction (0, 0, 1) and origins exactly on box planes: the slab
    test meets 0 * inf = NaN and must miss, as torch.minimum does."""
    from raytracebvh_tpu_torch.core.types import Rays
    from raytracebvh_tpu_torch.ops import traverse, traverse_cuda

    bvh = _bvh(dev, 500, 2)
    n = bvh.n_leaves
    gen = torch.Generator(device="cpu").manual_seed(7)
    nodes = torch.randint(0, 2 * n - 1, (4096,), generator=gen).to(dev)
    lo, hi = bvh.bbmin[nodes], bvh.bbmax[nodes]
    o = 0.5 * (lo + hi)
    o[:2048, 0] = lo[:2048, 0]
    o[2048:, 1] = hi[2048:, 1]
    o[:, 2] = lo[:, 2] - 1.0
    o = torch.where(torch.isfinite(o), o, 0.0).contiguous()
    d = torch.tensor([0.0, 0.0, 1.0], device=dev).expand_as(o).contiguous()
    rays = Rays(o, d)
    max_t = torch.full((4096,), 1e3, device=dev)
    got = traverse_cuda.traverse_any(bvh, rays, 0.01, max_t)
    want = traverse.traverse_any(bvh, rays, 0.01, max_t)
    assert torch.equal(got, want)
    assert bool(want.any())


def test_k4_step_cap_counts_truncated_rays(dev):
    from raytracebvh_tpu_torch.ops import traverse, traverse_cuda

    bvh = _bvh(dev)
    rays = _rays(dev, 4096, 8)
    max_t = _max_t(dev, 4096, 9)
    traverse_cuda.reset_truncated()
    got = traverse_cuda.traverse_any(bvh, rays, 0.01, max_t, max_steps=5)
    assert torch.equal(got, traverse.traverse_any(bvh, rays, 0.01, max_t,
                                                  max_steps=5))
    occ, full = traverse.traverse_any(bvh, rays, 0.01, max_t,
                                      return_steps=True)
    # cut: rays whose full walk is longer than 5 steps
    assert traverse_cuda.truncated_rays() == int((full > 5).sum()) > 0
    traverse_cuda.reset_truncated()
    assert traverse_cuda.truncated_rays() == 0


@pytest.mark.parametrize("dtype,channels", [(torch.float32, 40),
                                            (torch.float32, 16),
                                            (torch.uint8, 16)])
def test_k2_matches_plain_with_out_of_range_rows(dev, dtype, channels):
    from raytracebvh_tpu_torch.ops import gather_cuda

    gen = torch.Generator(device="cpu").manual_seed(channels)
    if dtype == torch.uint8:
        tbl = torch.randint(0, 256, (5000, channels), generator=gen,
                            dtype=torch.uint8)
    else:
        tbl = torch.randn(5000, channels, generator=gen)
    idx = torch.randint(-100, 5100, (30001,), generator=gen, dtype=torch.int32)
    tbl, idx = tbl.to(dev), idx.to(dev)
    before = gather_cuda.launches
    got = gather_cuda.gather_rows(tbl, idx)
    assert gather_cuda.launches == before + 1
    want = gather_cuda.gather_rows_torch(tbl, idx)
    assert torch.equal(got, want)
    bad = (idx < 0) | (idx >= 5000)
    assert bad.any() and (got[:, bad] == 0).all()


def test_k2_refuses_a_table_that_needs_grad(dev):
    from raytracebvh_tpu_torch.ops import gather_cuda

    tbl = torch.randn(64, 40, device=dev, requires_grad=True)
    idx = torch.zeros(8, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="K3"):
        gather_cuda.gather_rows(tbl, idx)
    with torch.no_grad():
        assert gather_cuda.gather_rows(tbl, idx).shape == (40, 8)
