"""Kernels K1 to K8 against their plain PyTorch versions on the GPU.

Marked ``gpu``: they skip without a CUDA device (a CUDA kernel has no
CPU mode; the CPU tests hold the plain versions against the JAX
package).  On a GPU machine, which need not have JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py

Tolerances: K2 and K7 exact; K1 and K5 hit and leaf exact, distance
exact; K4's and K6's occlusion flags exact, K4's with max_t one ulp around
hit distances included; the walks' step counts exact (the kernels are
built with -fmad=false and IEEE division, so they round as the plain
versions' separate PyTorch ops do);
K8's (sorted_codes, order) exact against torch.sort(stable=True) and its
plain network, at every size and on every input.  K3 sums blocks in float64
and adds them in fixed point: it is held to the float64 sum within 1e-6 of
each row's largest |value|, and to its own bits on a second launch, on
coherent and random ids and on every ray into one row.
"""

import os

import numpy as np
import pytest
import torch

from gathered_blocks import block_takers
from walk_edge_rays import corner_edge_rays

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _bvh(dev, num_tris=2000, seed=0, leaf_pad_multiple=256):
    import raytracebvh_tpu_torch as T
    from raytracebvh_tpu_torch.camera import camera_matrices
    from raytracebvh_tpu_torch.models.procedural import random_triangles

    scene = random_triangles(num_tris, seed=seed, device=dev)
    wvp, wv = camera_matrices(T.Camera.default(dev), 64, 64)
    return T.build_bvh(scene, wvp, wv, T.RenderConfig(
        width=64, height=64, leaf_pad_multiple=leaf_pad_multiple))


def test_scene_constructors_default_to_the_card(dev, tmp_path):
    """random_triangles, sphere_grid and load_obj build their Scene on the
    CUDA device when no device is given."""
    from raytracebvh_tpu_torch.io.obj import load_obj
    from raytracebvh_tpu_torch.models.procedural import (random_triangles,
                                                         sphere_grid)

    obj = tmp_path / "tri.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    for scene in (random_triangles(20, seed=1), sphere_grid(1, 1, 2),
                  load_obj(str(obj))):
        tensors = [v for v in (*vars(scene).values(),
                               *vars(scene.materials).values())
                   if isinstance(v, torch.Tensor)]
        assert tensors and all(t.device.type == "cuda" for t in tensors)


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


def _launch_rays(dev, bvh, case, seed, any_hit=False):
    """(rays, max_t) of one launch: ``case`` random rays and random max_t,
    or 'mixed': 2 304 rays whose lanes take turns at a dead ray (origin
    1e30, one step), a short walk (at most 5 steps) and a long one (100
    steps or more) of the nearest-hit walk, or of the any-hit walk with
    ``any_hit``, so every warp holds all three."""
    from raytracebvh_tpu_torch.core.types import Rays
    from raytracebvh_tpu_torch.ops import traverse

    if case != "mixed":
        return _rays(dev, case, seed), _max_t(dev, case, seed + 1)
    pool, max_t = _rays(dev, 20000, seed), _max_t(dev, 20000, seed + 1)
    if any_hit:
        steps = traverse.traverse_any(bvh, pool, 0.01, max_t,
                                      return_steps=True)[1]
    else:
        steps = traverse.traverse(bvh, pool, 0.01, return_steps=True)[1]
    short = (steps <= 5).nonzero().squeeze(1)[:768]
    long = (steps >= 100).nonzero().squeeze(1)[:768]
    assert short.numel() == long.numel() == 768
    idx = torch.stack([short, short, long], 1).reshape(-1)
    o = pool.origin[idx].clone()
    o[::3] = 1.0e30
    return (Rays(o.contiguous(), pool.direction[idx].contiguous()),
            max_t[idx].contiguous())


def _check_mixed(case, wsteps):
    """The mixed launch's lanes walk as _launch_rays chose them."""
    if case == "mixed":
        assert int(wsteps[0::3].max()) == 1
        assert int(wsteps[1::3].max()) <= 5 and int(wsteps[2::3].min()) >= 100


# launch sizes: one ray, a warp less and more one ray, a 1080p frame and
# one ray more, and lanes of dead, short and long walks in every warp
LAUNCHES = [20000, 1, 31, 33, 2073601, "mixed"]


@pytest.mark.parametrize("case", LAUNCHES)
def test_k1_matches_plain_random_rays(dev, case):
    from raytracebvh_tpu_torch.ops import traverse, traverse_cuda

    bvh = _bvh(dev)
    rays = _launch_rays(dev, bvh, case, 1)[0]
    traverse_cuda.reset_truncated()
    before = traverse_cuda.launches
    got, steps = traverse_cuda.traverse(bvh, rays, 0.01, return_steps=True)
    want, wsteps = traverse.traverse(bvh, rays, 0.01, return_steps=True)
    assert traverse_cuda.launches == before + 1
    nrays = rays.origin.shape[0]
    if nrays >= 1000:
        assert 0 < int(want.hit.sum()) < nrays
    _assert_same(got, want)
    assert torch.equal(steps, wsteps)
    assert traverse_cuda.truncated_rays() == 0
    _check_mixed(case, wsteps)


def _slab_zero_rays(dev, bvh, kind, seed):
    """Rays whose slab test meets distances of exactly 0: 'plane',
    direction (0, 0, 1) from origins exactly on an x or y plane of a box
    (0 * inf = NaN, and the box must be missed, as torch.minimum does),
    or corner_edge_rays' 'corner' and 'edge'."""
    from raytracebvh_tpu_torch.core.types import Rays

    if kind != "plane":
        o, d = corner_edge_rays(bvh.bbmin.cpu().numpy(),
                                bvh.bbmax.cpu().numpy(), 4096, seed, kind)
        return Rays(torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev))
    n = bvh.n_leaves
    gen = torch.Generator(device="cpu").manual_seed(seed)
    nodes = torch.randint(0, 2 * n - 1, (4096,), generator=gen).to(dev)
    lo, hi = bvh.bbmin[nodes], bvh.bbmax[nodes]
    o = 0.5 * (lo + hi)
    o[:2048, 0] = lo[:2048, 0]
    o[2048:, 1] = hi[2048:, 1]
    o[:, 2] = lo[:, 2] - 1.0
    o = torch.where(torch.isfinite(o), o, 0.0).contiguous()
    d = torch.tensor([0.0, 0.0, 1.0], device=dev).expand_as(o).contiguous()
    return Rays(o, d)


SLAB_ZERO = ["plane", "corner", "edge"]


@pytest.mark.parametrize("kind", SLAB_ZERO)
def test_k1_on_plane_rays_miss_like_plain(dev, kind):
    """Origins on box planes, corners and edges (_slab_zero_rays): hit,
    leaf, distance and steps equal to the plain walk's."""
    from raytracebvh_tpu_torch.ops import traverse, traverse_cuda

    bvh = _bvh(dev, 500, 2)
    rays = _slab_zero_rays(dev, bvh, kind, 3)
    got, steps = traverse_cuda.traverse(bvh, rays, 0.01, return_steps=True)
    want, wsteps = traverse.traverse(bvh, rays, 0.01, return_steps=True)
    _assert_same(got, want)
    assert torch.equal(steps, wsteps)
    if kind != "plane":
        assert 0 < int(want.hit.sum()) < rays.origin.shape[0]


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


@pytest.mark.parametrize("case", LAUNCHES)
def test_k4_matches_plain_random_rays(dev, case):
    """Random max_t, and max_t one ulp above, at, and one ulp below each
    ray's nearest hit distance, on every launch size of LAUNCHES."""
    from raytracebvh_tpu_torch.ops import traverse, traverse_cuda

    bvh = _bvh(dev)
    rays, max_t = _launch_rays(dev, bvh, case, 5, any_hit=True)
    nrays = rays.origin.shape[0]
    traverse_cuda.reset_truncated()
    before = traverse_cuda.any_launches
    got, steps = traverse_cuda.traverse_any(bvh, rays, 0.01, max_t,
                                            return_steps=True)
    want, wsteps = traverse.traverse_any(bvh, rays, 0.01, max_t,
                                         return_steps=True)
    assert traverse_cuda.any_launches == before + 1
    if nrays >= 1000:
        assert 0 < int(want.sum()) < nrays
    assert torch.equal(got, want)
    assert torch.equal(steps, wsteps)
    _check_mixed(case, wsteps)
    rec = traverse.traverse(bvh, rays, 0.01)
    t = torch.where(rec.hit, rec.distance, 100.0)
    for m in (torch.nextafter(t, torch.full_like(t, float("inf"))), t,
              torch.nextafter(t, torch.zeros_like(t))):
        occ = traverse_cuda.traverse_any(bvh, rays, 0.01, m.contiguous())
        assert torch.equal(occ, traverse.traverse_any(bvh, rays, 0.01, m))
    assert traverse_cuda.truncated_rays() == 0


@pytest.mark.parametrize("kind", SLAB_ZERO)
def test_k4_on_plane_rays_match_plain(dev, kind):
    """Origins on box planes, corners and edges (_slab_zero_rays):
    occlusion and steps equal to the plain walk's."""
    from raytracebvh_tpu_torch.ops import traverse, traverse_cuda

    bvh = _bvh(dev, 500, 2)
    rays = _slab_zero_rays(dev, bvh, kind, 7)
    max_t = torch.full((4096,), 1e3, device=dev)
    got, steps = traverse_cuda.traverse_any(bvh, rays, 0.01, max_t,
                                            return_steps=True)
    want, wsteps = traverse.traverse_any(bvh, rays, 0.01, max_t,
                                         return_steps=True)
    assert torch.equal(got, want)
    assert torch.equal(steps, wsteps)
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


def _coherent_ids(gen, rows, nrays, lo=-50, hi=None):
    """Clustered runs of row ids, as tiled rays over morton-sorted leaves
    give, with some ids outside [0, rows)."""
    hi = rows + 50 if hi is None else hi
    base = torch.randint(0, rows, (nrays // 64 + 1,), generator=gen)
    ids = base.repeat_interleave(64)[:nrays] + torch.randint(
        0, 8, (nrays,), generator=gen)
    wild = torch.rand(nrays, generator=gen) < 0.02
    ids = torch.where(wild, torch.randint(lo, hi, (nrays,), generator=gen), ids)
    return ids.to(torch.int32)


def _f64_sum(g, idx, rows):
    valid = (idx >= 0) & (idx < rows)
    return torch.zeros((rows, g.shape[0]), dtype=torch.float64,
                       device=g.device).index_add_(
        0, idx[valid].long(), g.t()[valid].double())


def _row_rel_err(got, want):
    err = (got.double() - want).abs().amax(1)
    scale = want.abs().amax(1)
    return float(torch.where(scale > 0, err / scale.clamp(min=1e-300),
                             err).max())


def _k3_ids(gen, kind, rows, nrays):
    if kind == "coherent":
        return _coherent_ids(gen, rows, nrays)
    if kind == "random":  # a block's 256 rays on ~256 rows: g read twice
        return torch.randint(-50, rows + 50, (nrays,), generator=gen,
                             dtype=torch.int32)
    return torch.full((nrays,), rows // 2, dtype=torch.int32)  # one row


@pytest.mark.parametrize("rows,nrays,kind", [
    (3072, 200003, "coherent"), (40000, 65536, "coherent"),
    (7, 1000, "coherent"), (3072, 2073600, "coherent"),
    (3072, 200003, "random"), (2073600, 2073600, "random"),
    (3072, 200003, "one row"), (3072, 2073600, "one row")])
def test_k3_matches_float64_sum_and_repeats_bits(dev, rows, nrays, kind):
    """K3 within 1e-6 of each row's largest |value| of the float64 sum
    (its fixed-point error bound, csrc/scatter.cu, plus one float32
    rounding), and the same bits on a second launch; rows above the JAX
    package's 32 768-row cap included; coherent ids (blocks that keep
    their partials), random ones (blocks of more rows than K3 keeps
    partials of, which read g again) and every ray into one row; the 1080p
    shape [40, 2 073 600] into 3 072 rows."""
    from raytracebvh_tpu_torch.ops import gather_cuda

    gen = torch.Generator(device="cpu").manual_seed(rows + nrays)
    g = torch.randn(40, nrays, generator=gen) * torch.logspace(
        -6, 2, 40)[:, None]
    idx = _k3_ids(gen, kind, rows, nrays)
    g, idx = g.to(dev), idx.to(dev)
    before = gather_cuda.scatter_launches
    got = gather_cuda.scatter_add_rows(g, idx, rows)
    again = gather_cuda.scatter_add_rows(g, idx, rows)
    assert gather_cuda.scatter_launches == before + 2
    assert got.shape == (rows, 40) and got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    want = _f64_sum(g, idx, rows)
    assert _row_rel_err(got, want) <= 1e-6
    # the plain float32 version, within its own float32 summation error:
    # a row of at most a few thousand terms within 1e-4, one row of up to
    # 2 M terms within 1e-3 (chip_smoke.py's K3_PLAIN_TOL says why)
    plain = gather_cuda.scatter_add_rows_torch(g, idx, rows)
    assert _row_rel_err(plain, want) <= (1e-3 if kind == "one row" else 1e-4)


def test_k3_out_of_range_ids_and_empty(dev):
    from raytracebvh_tpu_torch.ops import gather_cuda

    g = torch.ones(40, 6, device=dev)
    idx = torch.tensor([-1, 5, 5, 1 << 30, -(1 << 30), 0], dtype=torch.int32,
                       device=dev)
    got = gather_cuda.scatter_add_rows(g, idx, 5)
    want = torch.zeros(5, 40, device=dev)
    want[0] = 1.0
    assert torch.equal(got, want)
    before = gather_cuda.scatter_launches
    empty = gather_cuda.scatter_add_rows(
        torch.zeros(40, 0, device=dev),
        torch.zeros(0, dtype=torch.int32, device=dev), 9)
    assert torch.equal(empty, torch.zeros(9, 40, device=dev))
    assert gather_cuda.scatter_launches == before  # nothing to launch


@pytest.mark.parametrize("spread", [0, 300])
def test_k3_non_finite_cells_as_ieee_sums(dev, spread):
    """A NaN, or +inf and -inf together, make a cell NaN; one infinity
    makes it that infinity; other cells stay exact.  With ``spread`` more
    rays, each on a row of its own, the block has more rows than K3 keeps
    partials of, and its sums are taken again from g."""
    from raytracebvh_tpu_torch.ops import gather_cuda

    inf, nan = float("inf"), float("nan")
    g = torch.tensor([[1.0, inf, 2.0, -inf, 3.0, nan, 4.0],
                      [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]])
    g = torch.cat([g, torch.zeros(2, 7)])  # C = 4
    idx = torch.tensor([0, 0, 1, 1, 2, 2, 3], dtype=torch.int32)
    idx[3] = 0  # row 0 gets +inf and -inf
    g = torch.cat([g, torch.ones(4, spread)], 1)
    idx = torch.cat([idx, torch.arange(4, 4 + spread, dtype=torch.int32)])
    rows = 4 + spread
    got = gather_cuda.scatter_add_rows(g.to(dev).contiguous(), idx.to(dev),
                                       rows).cpu()
    want = torch.zeros(rows, 4, dtype=torch.float64).index_add_(
        0, idx.long(), g.t().double()).float()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert torch.equal(got[ok], want[ok])


def test_gather_rows_gradient_is_k3(dev):
    """Autograd through K2 on CUDA: its backward is K3, and the table's
    gradient matches the plain gather's within K3's float64 limit."""
    from raytracebvh_tpu_torch.ops import gather_cuda

    gen = torch.Generator(device="cpu").manual_seed(11)
    tbl = torch.randn(3072, 40, generator=gen).to(dev).requires_grad_()
    idx = _coherent_ids(gen, 3072, 100000).to(dev)
    w = torch.randn(40, 100000, generator=gen).to(dev)
    k2, k3 = gather_cuda.launches, gather_cuda.scatter_launches
    (gather_cuda.gather_rows(tbl, idx) * w).sum().backward()
    assert (gather_cuda.launches, gather_cuda.scatter_launches) == (k2 + 1, k3 + 1)
    got = tbl.grad.clone()
    tbl.grad = None
    (gather_cuda.gather_rows_torch(tbl, idx) * w).sum().backward()
    want = _f64_sum(w, idx, 3072)
    assert _row_rel_err(got, want) <= 1e-6
    assert _row_rel_err(tbl.grad, want) <= 1e-4


def test_loss_and_grads_64x64_kernels_match_plain(dev):
    """loss_fn + backward() at 64x64 through K1, K2 and K3 against every
    backend 'torch': the loss bit-equal (K1 and K2 are), each gradient
    within 1e-5 of its tensor's largest |grad| (float32 sums in another
    order)."""
    import raytracebvh_tpu_torch as T
    from raytracebvh_tpu_torch.models.inverse import init_params, loss_fn
    from raytracebvh_tpu_torch.models.procedural import random_triangles
    from raytracebvh_tpu_torch.ops import gather_cuda

    scene = random_triangles(300, seed=6, with_texture=True, device=dev)
    cam = T.Camera.default(dev)
    cfg = T.RenderConfig(width=64, height=64, bounces=1, ortho_scale=2.0,
                         ray_tile=16, texture_dtype="uint8")
    target = torch.zeros((64, 64, 4), device=dev)
    out = []
    for c in (cfg, cfg.replace(traversal_backend="torch",
                               shade_gather_backend="torch",
                               texture_gather_backend="torch")):
        params = init_params(scene)
        k3 = gather_cuda.scatter_launches
        loss = loss_fn(params, scene, cam, target, c)
        loss.backward()
        out.append((loss.detach(), [p.grad for p in params],
                    gather_cuda.scatter_launches - k3))
    (loss, grads, n), (loss_p, grads_p, n_p) = out
    assert (n, n_p) == (2, 0)
    assert torch.equal(loss, loss_p)
    for g, gp in zip(grads, grads_p):
        scale = float(gp.abs().max())
        assert scale > 0 and bool(torch.isfinite(g).all())
        assert float((g - gp).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("gather", ["cuda", "shared"], ids=["K2", "K7"])
def test_gathered_rows_have_one_backward_node_on_the_card(dev, monkeypatch,
                                                         gather):
    """On K2's and K7's routes each shading call's gathered [40, R] block
    reaches the loss through one UnbindBackward0 alone (two calls: the
    primary and one bounce), and K3 takes the stacked gradient once a
    call."""
    import raytracebvh_tpu_torch as T
    from raytracebvh_tpu_torch.models.inverse import init_params, loss_fn
    from raytracebvh_tpu_torch.models.procedural import random_triangles
    from raytracebvh_tpu_torch.ops import gather_cuda

    scene = random_triangles(300, seed=6, with_texture=True, device=dev)
    cfg = T.RenderConfig(width=64, height=64, bounces=1, ortho_scale=2.0,
                         ray_tile=16, texture_dtype="uint8",
                         shade_gather_backend=gather)
    target = torch.zeros((64, 64, 4), device=dev)
    params = init_params(scene)
    loss, takers = block_takers(monkeypatch, lambda: loss_fn(
        params, scene, T.Camera.default(dev), target, cfg))
    assert takers == [["UnbindBackward0"]] * 2
    k3 = gather_cuda.scatter_launches
    loss.backward()
    assert gather_cuda.scatter_launches - k3 == 2
    assert all(bool(torch.isfinite(p.grad).all()) for p in params)


def _dead_and_live(dev, nrays, seed):
    """Random rays, a quarter of them dead (origin 1e30, as the pipeline
    parks rays that stopped bouncing)."""
    rays = _rays(dev, nrays, seed)
    o = rays.origin.clone()
    o[::4] = 1.0e30
    return type(rays)(o.contiguous(), rays.direction)


def test_k5_k6_match_plain_random_and_dead_rays(dev):
    """K5 and K6 bit-equal to the plain walks (and so to K1 and K4): hit,
    leaf, distance, occlusion and steps."""
    from raytracebvh_tpu_torch.ops import traverse, traverse_shared_cuda

    bvh = _bvh(dev)
    rays = _dead_and_live(dev, 20000, 21)
    max_t = _max_t(dev, 20000, 22)
    before = (traverse_shared_cuda.launches, traverse_shared_cuda.any_launches)
    got, steps = traverse_shared_cuda.traverse(bvh, rays, 0.01,
                                               return_steps=True)
    occ, osteps = traverse_shared_cuda.traverse_any(bvh, rays, 0.01, max_t,
                                                    return_steps=True)
    assert (traverse_shared_cuda.launches,
            traverse_shared_cuda.any_launches) == (before[0] + 1, before[1] + 1)
    want, wsteps = traverse.traverse(bvh, rays, 0.01, return_steps=True)
    wocc, wosteps = traverse.traverse_any(bvh, rays, 0.01, max_t,
                                          return_steps=True)
    assert 0 < int(want.hit.sum()) < rays.origin.shape[0]
    assert 0 < int(wocc.sum()) < rays.origin.shape[0]
    _assert_same(got, want)
    assert torch.equal(steps, wsteps) and torch.equal(occ, wocc)
    assert torch.equal(osteps, wosteps)
    assert int(wsteps[::4].max()) == 1  # dead rays miss the root


@pytest.mark.parametrize("kind", SLAB_ZERO)
def test_k5_k6_on_plane_rays_match_plain(dev, kind):
    """Origins on box planes, corners and edges (_slab_zero_rays): K5 and
    K6 run the same walk as K1 and K4."""
    from raytracebvh_tpu_torch.ops import traverse, traverse_shared_cuda

    bvh = _bvh(dev, 500, 2)
    rays = _slab_zero_rays(dev, bvh, kind, 23)
    got, steps = traverse_shared_cuda.traverse(bvh, rays, 0.01,
                                               return_steps=True)
    want, wsteps = traverse.traverse(bvh, rays, 0.01, return_steps=True)
    _assert_same(got, want)
    assert torch.equal(steps, wsteps)
    max_t = torch.full((4096,), 1e3, device=dev)
    want = traverse.traverse_any(bvh, rays, 0.01, max_t)
    assert bool(want.any())
    assert torch.equal(traverse_shared_cuda.traverse_any(bvh, rays, 0.01,
                                                         max_t), want)


@pytest.mark.parametrize("num_tris", [2000, 7000])
def test_k5_k6_step_cap_counts_truncated_rays(dev, num_tris):
    """max_steps=5 with every node record staged (2 048 leaves) and with
    the internal nodes only (7 168 leaves)."""
    from raytracebvh_tpu_torch.ops import (traverse, traverse_cuda,
                                           traverse_shared_cuda)

    bvh = _bvh(dev, num_tris)
    rays = _rays(dev, 4096, 24)
    max_t = _max_t(dev, 4096, 25)
    full = traverse.traverse(bvh, rays, 0.01, return_steps=True)[1]
    full_any = traverse.traverse_any(bvh, rays, 0.01, max_t,
                                     return_steps=True)[1]
    traverse_cuda.reset_truncated()
    got = traverse_shared_cuda.traverse(bvh, rays, 0.01, max_steps=5)
    _assert_same(got, traverse.traverse(bvh, rays, 0.01, max_steps=5))
    assert traverse_cuda.truncated_rays() == int((full > 5).sum()) > 0
    traverse_cuda.reset_truncated()
    occ = traverse_shared_cuda.traverse_any(bvh, rays, 0.01, max_t,
                                            max_steps=5)
    assert torch.equal(occ, traverse.traverse_any(bvh, rays, 0.01, max_t,
                                                  max_steps=5))
    assert traverse_cuda.truncated_rays() == int((full_any > 5).sum()) > 0
    traverse_cuda.reset_truncated()


_TREES = {}


def _tree(dev, num_tris):
    """A random tree of exactly ``num_tris`` leaves (no padding), built once
    per test run."""
    if num_tris not in _TREES:
        _TREES[num_tris] = _bvh(dev, num_tris, 30 + num_tris,
                                leaf_pad_multiple=1)
    return _TREES[num_tris]


def _aimed_rays(dev, bvh, nrays, seed):
    """Rays from random origins, half of them aimed at the centroid of a
    random triangle of ``bvh`` (so even a 2-leaf tree is hit), a quarter
    random and a quarter dead (origin 1e30)."""
    from raytracebvh_tpu_torch.core.types import Rays

    gen = torch.Generator(device="cpu").manual_seed(seed)
    o = (torch.rand(nrays, 3, generator=gen) * 300 - 150).to(dev)
    d = torch.randn(nrays, 3, generator=gen).to(dev)
    tri = torch.randint(0, bvh.n_leaves, (nrays,), generator=gen).to(dev)
    aim = bvh.tri_verts[tri.long()].mean(1) - o
    half = torch.arange(nrays, device=dev) % 4 < 2
    d = torch.where(half[:, None], aim, d)
    d = d / d.norm(dim=1, keepdim=True)
    o[torch.arange(nrays, device=dev) % 4 == 3] = 1.0e30
    return Rays(o.contiguous(), d.contiguous())


@pytest.mark.parametrize("nrays", [1, 100, 25600, 2073600])
@pytest.mark.parametrize("num_tris", [2, 3, 500, 3072, 7000])
def test_k5_k6_tree_and_launch_sizes_match_plain(dev, num_tris, nrays):
    """K5 and K6 bit-equal to the plain walks (hit, leaf, distance,
    occlusion, steps) and no ray truncated, on trees whose node records
    all fit shared memory (2 to 3 072 leaves) and one whose internal nodes
    only fit (7 000), on launches of one ray, fewer rays than SMs and a
    sparse chunk (one round of 32-ray batches) and a 1080p frame (the
    work queue)."""
    from raytracebvh_tpu_torch.ops import (traverse, traverse_cuda,
                                           traverse_shared_cuda)

    bvh = _tree(dev, num_tris)
    assert bvh.n_leaves == num_tris
    rays = _aimed_rays(dev, bvh, nrays, num_tris + nrays)
    max_t = _max_t(dev, nrays, nrays)
    before = (traverse_shared_cuda.launches, traverse_shared_cuda.any_launches)
    traverse_cuda.reset_truncated()
    got, steps = traverse_shared_cuda.traverse(bvh, rays, 0.01,
                                               return_steps=True)
    occ, osteps = traverse_shared_cuda.traverse_any(bvh, rays, 0.01, max_t,
                                                    return_steps=True)
    assert traverse_cuda.truncated_rays() == 0
    assert (traverse_shared_cuda.launches,
            traverse_shared_cuda.any_launches) == (before[0] + 1, before[1] + 1)
    want, wsteps = traverse.traverse(bvh, rays, 0.01, return_steps=True)
    wocc, wosteps = traverse.traverse_any(bvh, rays, 0.01, max_t,
                                          return_steps=True)
    if nrays >= 100:
        assert 0 < int(want.hit.sum()) < nrays
    _assert_same(got, want)
    assert torch.equal(steps, wsteps) and torch.equal(occ, wocc)
    assert torch.equal(osteps, wosteps)
    assert int(wsteps.max()) < 4 * num_tris  # the default cap cut no walk


@pytest.mark.parametrize("num_tris,kernel", [(7000, "K5"), (7300, "K1")])
def test_shared_capacity_on_the_card(dev, num_tris, kernel):
    """7 000 triangles pad to 7 168 leaves, whose 229 344 bytes of
    internal nodes fit an H100 block: 'auto' runs K5.  7 300 pad to
    7 424, over the 232 448 bytes: 'auto' takes K1, and K5 called
    directly refuses the tree."""
    import raytracebvh_tpu_torch as T
    from raytracebvh_tpu_torch import pipeline
    from raytracebvh_tpu_torch.ops import (traverse, traverse_cuda,
                                           traverse_shared_cuda)

    bvh = _bvh(dev, num_tris, 26)
    smem = traverse_shared_cuda.smem_per_block(dev)
    fits = traverse_shared_cuda.fits(bvh.n_leaves, smem)
    assert fits == (kernel == "K5")
    backend = pipeline.resolve_traversal_backend(
        T.RenderConfig(), bvh.n_leaves, dev)
    assert backend == ("shared" if fits else "cuda")
    rays = _rays(dev, 8192, 27)
    if fits:
        before = traverse_shared_cuda.launches
        got = traverse_shared_cuda.traverse(bvh, rays, 0.01)
        assert traverse_shared_cuda.launches == before + 1
        _assert_same(got, traverse.traverse(bvh, rays, 0.01))
    else:
        with pytest.raises(ValueError, match="does not fit"):
            traverse_shared_cuda.traverse(bvh, rays, 0.01)
        _assert_same(traverse_cuda.traverse(bvh, rays, 0.01),
                     traverse.traverse(bvh, rays, 0.01))


@pytest.mark.parametrize("width,nrays,offset", [
    (3072, 30001, 0), (7, 30001, 0), (3072, 1, 0), (3072, 3, 0),
    (3072, 5, 0), (3072, 2073601, 0), (3072, 2073600, 0), (3072, 30000, 1)])
def test_k7_matches_plain_with_out_of_range_ids(dev, width, nrays, offset):
    """K7 exact against its plain version, with ids outside [0, width);
    ray counts that are not a multiple of its four rays a thread, and ids
    that are not 16-byte aligned (``offset``), take its scalar path."""
    from raytracebvh_tpu_torch.ops import gather_cols_cuda

    gen = torch.Generator(device="cpu").manual_seed(width + nrays)
    tbl = torch.randn(40, width, generator=gen).to(dev)
    idx = torch.randint(-100, width + 100, (nrays + offset,), generator=gen,
                        dtype=torch.int32).to(dev)[offset:]
    idx[0] = -1  # out of range in every case
    before = gather_cols_cuda.launches
    got = gather_cols_cuda.gather_cols(tbl, idx)
    assert gather_cols_cuda.launches == before + 1
    assert torch.equal(got, gather_cols_cuda.gather_cols_torch(tbl, idx))
    bad = (idx < 0) | (idx >= width)
    assert bad.any() and (got[:, bad] == 0).all()


def test_k7_gradient_is_k3(dev):
    """Autograd through K7: its backward is K3 on the same g and ids, the
    same bits as K2's backward on the row-major table."""
    from raytracebvh_tpu_torch.ops import gather_cols_cuda, gather_cuda

    gen = torch.Generator(device="cpu").manual_seed(28)
    rows = torch.randn(3072, 40, generator=gen).to(dev)
    idx = _coherent_ids(gen, 3072, 100000).to(dev)
    w = torch.randn(40, 100000, generator=gen).to(dev)
    a = rows.clone().requires_grad_()
    k7, k3 = gather_cols_cuda.launches, gather_cuda.scatter_launches
    (gather_cols_cuda.gather_cols(a.t().contiguous(), idx) * w).sum().backward()
    assert (gather_cols_cuda.launches, gather_cuda.scatter_launches) == (
        k7 + 1, k3 + 1)
    b = rows.clone().requires_grad_()
    (gather_cuda.gather_rows(b, idx) * w).sum().backward()
    assert torch.equal(a.grad, b.grad)
    assert _row_rel_err(a.grad, _f64_sum(w, idx, 3072)) <= 1e-6


@pytest.mark.parametrize("n,high", [(3072, 1 << 30), (3072, 7),
                                    (102400, 1 << 30), (102400, 50),
                                    (16384, 1 << 30), (16385, 3)])
def test_k8_both_routes_match_stable_sort(dev, n, high):
    """3 072 and 16 384 codes (one block, one launch) and 102 400 and
    16 385 (4 096-code tiles, then merge passes), heavy duplicates and the
    sentinel padding included."""
    from raytracebvh_tpu_torch.ops import sort_cuda

    gen = torch.Generator(device="cpu").manual_seed(n + high)
    codes = torch.randint(0, high, (n,), generator=gen, dtype=torch.int32)
    codes[-n // 8:] = 0x3FFFFFFF
    codes = codes.to(dev)
    before = sort_cuda.launches
    got_c, got_o = sort_cuda.bitonic_sort_by_code(codes)
    assert sort_cuda.launches == before + 1
    want_c, want_o = torch.sort(codes, stable=True)
    assert got_c.dtype == torch.int32 and got_o.dtype == torch.int32
    assert torch.equal(got_c, want_c) and torch.equal(got_o.long(), want_o)
    keys, idx = sort_cuda._padded(codes)
    plain_c, plain_o = sort_cuda.bitonic_network_torch(keys, idx)
    assert torch.equal(got_c, plain_c[:n]) and torch.equal(got_o, plain_o[:n])


def _edge_codes(case, n):
    gen = torch.Generator(device="cpu").manual_seed(n)
    if case == "equal":
        return torch.full((n,), 12345, dtype=torch.int32)
    if case == "sorted":
        return torch.arange(n, dtype=torch.int32) * 3
    if case == "reversed":
        return torch.arange(n, 0, -1, dtype=torch.int32) * 3
    return torch.randint(-(1 << 31), (1 << 31) - 1, (n,), generator=gen,
                         dtype=torch.int32)


@pytest.mark.parametrize("n", [1, 2, 1023, 1024, 4097, 16384, 16385, 131073])
@pytest.mark.parametrize("case", ["equal", "sorted", "reversed", "signed"])
def test_k8_edge_sizes_match_stable_sort(dev, n, case):
    """K8 against torch.sort(stable=True) and its plain network at the edges
    of its routes (one launch up to 16 384 codes, tiles and merges above)
    on all-equal, sorted and reversed codes, and on codes of either sign."""
    from raytracebvh_tpu_torch.ops import sort_cuda

    codes = _edge_codes(case, n).to(dev)
    before = sort_cuda.launches
    got_c, got_o = sort_cuda.bitonic_sort_by_code(codes)
    assert sort_cuda.launches == before + 1
    want_c, want_o = torch.sort(codes, stable=True)
    assert torch.equal(got_c, want_c) and torch.equal(got_o.long(), want_o)
    plain_c, plain_o = sort_cuda.bitonic_network_torch(
        *sort_cuda._padded(codes))
    assert torch.equal(got_c, plain_c[:n]) and torch.equal(got_o, plain_o[:n])


def test_onchip_backends_frame_equals_kernel_frame(dev):
    """A 64x64 shadowed frame through shared / shared / bitonic (K5, K6,
    K7, K8) equals the frame through cuda / cuda / lax (K1, K4, K2) bit for
    bit, each launch counted."""
    import raytracebvh_tpu_torch as T
    from raytracebvh_tpu_torch.models.procedural import random_triangles
    from raytracebvh_tpu_torch.ops import (gather_cols_cuda, sort_cuda,
                                           traverse_shared_cuda)

    scene = random_triangles(300, seed=7, with_texture=True, device=dev)
    cam = T.Camera.default(dev)
    cfg = T.RenderConfig(width=64, height=64, bounces=1, ortho_scale=1.4,
                         enable_shadows=True, light_pos=(10.0, 80.0, -40.0))
    counts = lambda: (traverse_shared_cuda.launches,
                      traverse_shared_cuda.any_launches,
                      gather_cols_cuda.launches, sort_cuda.launches)
    before = counts()
    got = T.render_frame(scene, cam, cfg.replace(
        traversal_backend="shared", shade_gather_backend="shared",
        sort_backend="bitonic"))
    assert all(a > b for a, b in zip(counts(), before))
    want = T.render_frame(scene, cam, cfg.replace(
        traversal_backend="cuda", shade_gather_backend="cuda",
        sort_backend="lax"))
    assert torch.equal(got, want)


@pytest.mark.parametrize("backends", [
    {}, {"traversal_backend": "cuda"},
    {"traversal_backend": "shared", "shade_gather_backend": "shared"}])
def test_bfloat16_frame_through_the_kernels(dev, monkeypatch, backends):
    """RenderConfig(dtype='bfloat16') renders on the card through the
    kernels (the default backends: K5/K6 and K2; K1/K4 and K2; K5/K6 and
    K7): the wrappers cast rays and max_t to float32 and gather bfloat16
    tables as float32, as the JAX kernels do.  The float32 image is finite
    and equals the plain path given the same casts (the plain walks on
    float32 rays and tree) on at least 99.99% of pixels within 1e-4, the
    dense frame's MATCH_MIN in chip_smoke.py."""
    import raytracebvh_tpu_torch as T
    from raytracebvh_tpu_torch.models.procedural import random_triangles
    from raytracebvh_tpu_torch.ops import traverse as plain
    from raytracebvh_tpu_torch.ops.traverse_cuda import float32_walk

    scene = random_triangles(300, seed=7, with_texture=True, device=dev)
    cam = T.Camera.default(dev)
    cfg = T.RenderConfig(width=128, height=96, bounces=1, ortho_scale=0.8,
                         enable_shadows=True, light_pos=(10.0, 80.0, -40.0),
                         dtype="bfloat16", **backends)
    got = T.render_frame(scene, cam, cfg)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    bg = torch.tensor(cfg.background, device=dev)
    assert bool((got - bg).abs().gt(1e-6).any(-1).any())
    monkeypatch.setattr(plain, "traverse", float32_walk(plain.traverse))
    monkeypatch.setattr(plain, "traverse_any",
                        float32_walk(plain.traverse_any))
    want = T.render_frame(scene, cam, cfg.replace(
        traversal_backend="torch", shade_gather_backend="torch",
        texture_gather_backend="torch"))
    frac = float((got - want).abs().amax(-1).le(1e-4).float().mean())
    assert frac >= 0.9999, frac


def test_sharded_frames_over_nccl_world_one(dev):
    """render_geo_sharded and render_sharded over a world-1 NCCL group
    equal render_frame at 64x64, bit for bit (shadows: K1, K2 and K4)."""
    import torch.distributed as dist

    import raytracebvh_tpu_torch as T
    from raytracebvh_tpu_torch.models.procedural import random_triangles
    from raytracebvh_tpu_torch.parallel import mesh, render

    scene = random_triangles(300, seed=7, with_texture=True, device=dev)
    cam = T.Camera.default(dev)
    cfg = T.RenderConfig(width=64, height=64, bounces=1, enable_shadows=True,
                         light_pos=(10.0, 80.0, -40.0), ortho_scale=2.0)
    want = T.render_frame(scene, cam, cfg)
    mesh.initialize_distributed()
    try:
        assert dist.get_backend() == "nccl"
        flat = mesh.make_mesh()
        assert torch.equal(render.render_geo_sharded(scene, cam, cfg, flat),
                           want)
        assert torch.equal(render.render_sharded(scene, cam, cfg, flat), want)
    finally:
        mesh.destroy_distributed()


def _graph_frame_args(dev, **kw):
    import raytracebvh_tpu_torch as T
    from raytracebvh_tpu_torch.models.procedural import random_triangles

    scene = random_triangles(300, seed=7, with_texture=True, device=dev)
    cfg = T.RenderConfig(**dict(dict(width=64, height=64, bounces=1,
                                     ortho_scale=1.4), **kw))
    return scene, T.Camera.default(dev), cfg


@pytest.mark.parametrize("kw", [
    dict(ray_tile=16, texture_dtype="uint8", traversal_backend="cuda"),
    dict(enable_shadows=True, light_pos=(10.0, 80.0, -40.0),
         shade_gather_backend="shared", sort_backend="bitonic"),
    dict(ray_chunk=512, enable_shadows=True, light_pos=(10.0, 80.0, -40.0)),
    dict(enable_refraction=True, dtype="bfloat16", ray_tile=16),
], ids=["k1_tiled_u8", "onchip_shadows", "culled_chunks", "refract_bf16"])
def test_graphed_frame_equals_eager_and_follows_the_camera(dev, kw):
    """render_frame_jit at 64x64 gives render_frame's bits; a replay with
    an orbited camera gives the eager frame's bits there (inputs are
    copied in, not baked in), without a second capture; the first image
    is the caller's: later replays leave it as it was."""
    import raytracebvh_tpu_torch as T
    from raytracebvh_tpu_torch import pipeline
    from raytracebvh_tpu_torch.camera import orbit

    scene, cam, cfg = _graph_frame_args(dev, **kw)
    pipeline.FRAME_GRAPHS.clear()
    got = T.render_frame_jit(scene, cam, cfg)
    want = T.render_frame(scene, cam, cfg)
    assert got.dtype == want.dtype and torch.equal(got, want)
    cam2 = orbit(cam, 0.3, 0.1)
    got2 = T.render_frame_jit(scene, cam2, cfg)
    assert torch.equal(got2, T.render_frame(scene, cam2, cfg))
    assert not torch.equal(got2, got)
    assert len(pipeline.FRAME_GRAPHS.entries) == 1
    assert torch.equal(got, want)
    pipeline.FRAME_GRAPHS.clear()


def _graph_bodies(graph) -> dict:
    """Graph id -> kernel nodes of a kept CUDA graph (``debug_dump``'s DOT
    numbers the captured graph 0 and each conditional node's body graph
    after it)."""
    import re
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.dot")
        graph.debug_dump(path)
        with open(path) as f:
            dot = f.read()
    per = {}
    for node in re.findall(r'"graph_\d+_node_\d+"\[.*?\];', dot, re.DOTALL):
        if 'label="{KERNEL' in node:
            g = int(re.match(r'"graph_(\d+)_', node).group(1))
            per[g] = per.get(g, 0) + 1
    return per


def _chunk_hits(scene, cam, cfg):
    """[chunks] bool: whether any primary ray of each ray chunk hits (the
    chunk loop's flags, pipeline.trace_chunks)."""
    from raytracebvh_tpu_torch import pipeline

    bvh, rays, _ = pipeline.frame_inputs(scene, cam, cfg)
    rays = pipeline.tile_frame_rays(rays, cfg, cfg.width, cfg.height)
    bvh = pipeline.shade_setup(scene, bvh, cfg)[0]
    return pipeline.trace_chunks(bvh, rays, cfg)[1]


def test_graphed_culled_frame_is_one_graph_the_device_steers(dev):
    """A culled chunked frame is one graph with one loop body (a WHILE
    node's): its replays read nothing back (sync-debug mode "error"), and
    the loop follows the copied-in camera, which the capture did not see:
    some, none and every chunk hit, each replay render_frame's bits, its
    trip counter the hit chunks, with one capture a config."""
    import raytracebvh_tpu_torch as T
    from raytracebvh_tpu_torch import graphs, pipeline

    # 75% of the 256-ray chunks hit at ortho_scale 3, all at 1.4
    scene, cam, cfg = _graph_frame_args(dev, ray_chunk=256, ortho_scale=3.0)
    away = cam.replace(at=torch.tensor([0.0, 5.0, -200.0], device=dev))
    pipeline.FRAME_GRAPHS.clear()
    pipeline.FRAME_GRAPHS.debug = True
    shares = []
    try:
        for c, ortho in ((cam, 3.0), (away, 3.0), (cam, 1.4), (cam, 3.0)):
            run = cfg.replace(ortho_scale=ortho)
            want = T.render_frame(scene, c, run)
            T.render_frame_jit(scene, c, run)  # a capture an ortho_scale
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = T.render_frame_jit(scene, c, run)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            assert torch.equal(got, want)
            hit = _chunk_hits(scene, c, run)
            shares.append(float(hit.float().mean()))
            entry = pipeline.FRAME_GRAPHS.entries[
                graphs.signature(run, scene, c)]
            assert [int(t) for t in entry.trips] == [int(hit.sum())]
            # the captured graph (the primary walks) and one loop body
            assert len(_graph_bodies(entry.graph)) == 2
    finally:
        pipeline.FRAME_GRAPHS.debug = False
    assert 0 < shares[0] < 1 and shares[1] == 0 and shares[2] == 1, shares
    assert len(pipeline.FRAME_GRAPHS.entries) == 2
    assert all(isinstance(e, graphs.Captured)
               for e in pipeline.FRAME_GRAPHS.entries.values())
    pipeline.FRAME_GRAPHS.clear()


def test_captured_cond_steers_by_the_device(dev):
    """graphs.cond captured: two IF nodes on a 0-d CUDA bool that the
    graph reads at each replay (csrc/cond.cu), each replay the branch
    the copied-in predicate picks; its gradient, captured too, the
    branch's."""
    from raytracebvh_tpu_torch import graphs

    x0 = torch.arange(1.0, 7.0, device=dev)

    def fn(x, pred):
        a = x.detach().requires_grad_(True)
        out = graphs.cond(pred, lambda v: (v * v).sin(), lambda v: v.exp(),
                          (a,))
        (grad,) = torch.autograd.grad(out.sum(), a)
        return out.detach(), grad

    stream = torch.cuda.Stream(dev)
    captured = graphs.Captured(fn, (x0, torch.tensor(True, device=dev)),
                               stream)
    for pred in (True, False, True):
        p = torch.tensor(pred, device=dev)
        got = [t.clone() for t in captured(x0 + 1.0, p)]
        want = fn(x0 + 1.0, pred)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), pred
        assert not captured.trips


def test_profiled_culled_replays_after_traces(dev):
    """torch.profiler over culled graphs in one process, in the order that
    faulted the card with IF nodes: chip_smoke.py's 1080p sparse and
    sparse_shadows frames captured and a replay of each traced, then the
    culled training step captured and three of its replays traced.  Each
    traced replay (a trace a replay, no retry) runs the eager call's
    hand-written kernels (``chip_smoke.culled_replay_routes``: the trace
    records a loop body's kernels at every trip, or once a replay for a
    graph captured before the first trace, and the loop's trip counter
    gives its trips), the trip counters are the hit chunks after every
    replay, every frame replay gives the eager frame's bits, and the
    step's losses (the last replay unprofiled) the eager steps' with the
    same capturable Adam."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    import raytracebvh_tpu_torch as T
    from raytracebvh_tpu_torch import pipeline
    from raytracebvh_tpu_torch.models import inverse

    frames = cs.frames_on(dev)
    nchunks = cs.W * cs.H // cs.SPARSE_CHUNK
    for name in ("sparse", "sparse_shadows"):
        scene, cam, cfg = frames[name]
        with torch.inference_mode():
            want_img, want = cs.counted(
                lambda: T.render_frame(scene, cam, cfg))
        pipeline.FRAME_GRAPHS.clear()

        def call():
            with torch.inference_mode():
                img = T.render_frame_jit(scene, cam, cfg)
            assert torch.equal(img, want_img), name

        call()
        (entry,) = pipeline.FRAME_GRAPHS.entries.values()
        ran, trips, _ = cs.culled_replay_routes(call, entry, name, want,
                                                tries=1)
        assert ran == want and 0 < trips[0] < nchunks, (name, ran, trips)
    pipeline.FRAME_GRAPHS.clear()

    name = "sparse_train_culled"
    scene, cam, cfg = cs.train_frames(frames)[name]
    target = torch.zeros((cs.H, cs.W, 4), device=dev)
    pe = inverse.init_params(scene)
    oe = inverse.make_optimizer(pe, 1e-2, capturable=True)
    eager = []
    eager.append(cs.counted(lambda: inverse.train_step(
        pe, oe, scene, cam, target, cfg))[0])
    want = cs.read_counts()
    params = inverse.init_params(scene)
    opt = inverse.make_optimizer(params, 1e-2, capturable=True)
    losses = []

    def step():
        losses.append(inverse.train_step_jit(params, opt, scene, cam,
                                             target, cfg, lr=1e-2))

    step()
    (entry,) = inverse.step_graphs(opt).entries.values()
    for _ in range(3):
        ran, trips, _ = cs.culled_replay_routes(step, entry.captured, name,
                                                want, tries=1)
        assert ran == want and trips == [want["K3"] // 2] * 2, (ran, trips)
    step()
    assert cs.check_trips(name, entry.captured, name, want)
    while len(eager) < len(losses):
        eager.append(inverse.train_step(pe, oe, scene, cam, target, cfg))
    assert all(torch.equal(a, b) for a, b in zip(losses, eager))


def test_culled_graph_gives_its_memory_back(dev):
    """A culled frame's graph allocates from two pools, its own and its
    loop body's (graphs._Bodies), and dropping the graph gives both back: once
    the cache is cleared, the device memory reserved is what it was
    before the capture."""
    import gc

    import raytracebvh_tpu_torch as T
    from raytracebvh_tpu_torch import pipeline

    scene, cam, cfg = _graph_frame_args(dev, ray_chunk=256, ortho_scale=3.0)
    pipeline.FRAME_GRAPHS.clear()
    T.render_frame(scene, cam, cfg)  # the eager frame's lazy constants
    gc.collect()  # what earlier tests left in reference cycles
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    T.render_frame_jit(scene, cam, cfg)
    (entry,) = pipeline.FRAME_GRAPHS.entries.values()
    held = torch.cuda.memory_reserved()
    assert entry.pool_bytes > 0 and held > before
    del entry
    pipeline.FRAME_GRAPHS.clear()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() == before, (before, held)


def _walk_launches() -> dict:
    from raytracebvh_tpu_torch.ops import traverse_cuda, traverse_shared_cuda

    return {"K1": traverse_cuda.launches, "K4": traverse_cuda.any_launches,
            "K5": traverse_shared_cuda.launches,
            "K6": traverse_shared_cuda.any_launches}


def _walks_since(start: dict) -> dict:
    """The walk kernels launched since ``start`` (``_walk_launches``),
    those launched at all."""
    return {k: v - start[k] for k, v in _walk_launches().items()
            if v != start[k]}


@pytest.mark.parametrize("backend,walk", [("cuda", "K1"), ("shared", "K5")])
def test_traversal_chunk_frame_is_the_unchunked_frame(dev, backend, walk):
    """A kernel route walks each pass in one launch and ignores
    traversal_chunk, as the JAX package's Pallas walks do: at 64x64 with a
    bounce, a chunk that divides the 4 096 rays (512) and one that does
    not (1 000) give the unchunked frame's bits, eager (two walk launches:
    primary and bounce) and through render_frame_jit (its capture four:
    warm-up and graph; its replay the same bits).  The plain walk still
    refuses the chunk that does not divide."""
    import raytracebvh_tpu_torch as T
    from raytracebvh_tpu_torch import pipeline

    scene, cam, cfg = _graph_frame_args(dev, traversal_backend=backend)
    want = T.render_frame(scene, cam, cfg)
    for chunk in (512, 1000):
        run = cfg.replace(traversal_chunk=chunk)
        start = _walk_launches()
        got = T.render_frame(scene, cam, run)
        assert torch.equal(got, want) and _walks_since(start) == {walk: 2}
        pipeline.FRAME_GRAPHS.clear()
        start = _walk_launches()
        got = T.render_frame_jit(scene, cam, run)
        assert torch.equal(got, want) and _walks_since(start) == {walk: 4}
        assert torch.equal(T.render_frame_jit(scene, cam, run), want)
        assert _walks_since(start) == {walk: 4}
    pipeline.FRAME_GRAPHS.clear()
    with pytest.raises(ValueError, match="must divide"):
        T.render_frame(scene, cam, cfg.replace(traversal_backend="torch",
                                               traversal_chunk=1000))


def test_culled_frame_walks_its_chunks_in_one_launch(dev):
    """trace_chunks walks every ray chunk in one K5 launch, with the plain
    walk's records a chunk bit for bit; a culled frame with a bounce then
    launches K5 once and once a shaded chunk (its bounce)."""
    import raytracebvh_tpu_torch as T
    from raytracebvh_tpu_torch import pipeline

    scene, cam, cfg = _graph_frame_args(dev, ray_chunk=256, ortho_scale=3.0)
    bvh, rays, _ = pipeline.frame_inputs(scene, cam, cfg)
    bvh = pipeline.shade_setup(scene, bvh, cfg)[0]
    want, want_hit = pipeline.trace_chunks(
        bvh, rays, cfg.replace(traversal_backend="torch"))
    start = _walk_launches()
    got, hit = pipeline.trace_chunks(bvh, rays, cfg)
    assert _walks_since(start) == {"K5": 1}
    _assert_same(got, want)
    assert torch.equal(hit, want_hit)
    shaded = int(hit.sum())
    assert 0 < shaded < hit.shape[0]
    start = _walk_launches()
    T.render_frame(scene, cam, cfg)
    assert _walks_since(start) == {"K5": 1 + shaded}


def test_step_graph_goes_with_its_optimizer(dev):
    """train_step_jit's graph is held by its optimizer: once the caller
    drops the optimizer and its parameters, a collection gives back every
    byte reserved for the capture (the graph's pool and its loops'
    bodies'), as test_culled_graph_gives_its_memory_back has it for a
    frame; a culled step, so that both pools are made.  A first
    optimizer's capture makes what the capture stream keeps for the
    process (its cuBLAS workspace), so a second one is measured."""
    import gc
    import weakref

    import raytracebvh_tpu_torch as T
    from raytracebvh_tpu_torch.models import inverse
    from raytracebvh_tpu_torch.models.procedural import random_triangles

    scene = random_triangles(40, seed=11, extent=8.0, tri_size=2.0,
                             with_texture=True, device=dev)
    cam = T.Camera.default(dev)
    cfg = T.RenderConfig(width=64, height=64, bounces=1, ortho_scale=1.0,
                         ray_chunk=32)
    target = T.render_frame(scene, cam, cfg) * 0.8

    def reserved():
        gc.collect()  # the optimizer's cycle with its graphs
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved()

    def capture():
        """A step graph for a new optimizer: (a weak reference to the
        optimizer, the bytes reserved while the caller holds it)."""
        params = inverse.init_params(scene)
        opt = inverse.make_optimizer(params, 1e-2, capturable=True)
        inverse.train_step_jit(params, opt, scene, cam, target, cfg, lr=1e-2)
        (entry,) = inverse.step_graphs(opt).entries.values()
        assert entry.captured.pool_bytes > 0 and entry.captured.trips
        return weakref.ref(opt), reserved()

    gone, _ = capture()
    before = reserved()
    assert gone() is None
    gone, held = capture()
    after = reserved()
    assert gone() is None
    assert held > before and after == before, (before, held, after)


def test_graphed_frame_recaptures_on_a_new_size(dev):
    import raytracebvh_tpu_torch as T
    from raytracebvh_tpu_torch import pipeline

    pipeline.FRAME_GRAPHS.clear()
    for w, h in ((64, 64), (96, 48), (64, 64)):
        scene, cam, cfg = _graph_frame_args(dev, width=w, height=h,
                                            ray_tile=16)
        got = T.render_frame_jit(scene, cam, cfg)
        assert got.shape == (h, w, 4)
        assert torch.equal(got, T.render_frame(scene, cam, cfg))
    assert len(pipeline.FRAME_GRAPHS.entries) == 2
    pipeline.FRAME_GRAPHS.clear()


def test_failed_capture_raises(dev, monkeypatch):
    """A frame that reads a value back to the host cannot be captured:
    render_frame_jit raises and caches nothing, rather than render the
    frame eagerly."""
    import raytracebvh_tpu_torch as T
    from raytracebvh_tpu_torch import pipeline

    scene, cam, cfg = _graph_frame_args(dev)
    # the leaf gather: every shading pass calls it, on the shading kernels'
    # route and the plain one alike
    real = pipeline._leaf_block

    def reads_back(bvh, rec, cfg):
        int(rec.hit.sum())  # a host read: fine eagerly, not in a capture
        return real(bvh, rec, cfg)

    pipeline.FRAME_GRAPHS.clear()
    monkeypatch.setattr(pipeline, "_leaf_block", reads_back)
    with pytest.raises(RuntimeError):
        T.render_frame_jit(scene, cam, cfg)
    assert not pipeline.FRAME_GRAPHS.entries
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert torch.equal(T.render_frame_jit(scene, cam, cfg),
                       T.render_frame(scene, cam, cfg))
    pipeline.FRAME_GRAPHS.clear()


@pytest.mark.parametrize("chunk", [0, 32], ids=["unchunked", "culled"])
def test_graphed_steps_match_eager_steps(dev, chunk):
    """Three train_step_jit calls at 64x64 equal three eager train_steps
    with the same capturable Adam from the same start, bit for bit, also
    where the frame culls 32-ray chunks (shaded and differentiated in the
    graph's two WHILE nodes, each counting the hit chunks' trips); with
    make_optimizer's default Adam the first
    loss is bit-equal and the parameters after one step are within 1e-6
    (the capturable Adam's float32 bias corrections: chip_smoke.py's
    GRAPHED_STEP1_TOL).  lr is read at each call: a step at lr 0 moves
    nothing, without a second capture.  A default (not capturable) Adam
    is refused."""
    import raytracebvh_tpu_torch as T
    from raytracebvh_tpu_torch import pipeline
    from raytracebvh_tpu_torch.models import inverse
    from raytracebvh_tpu_torch.models.procedural import random_triangles

    scene = random_triangles(40, seed=11, extent=8.0, tri_size=2.0,
                             with_texture=True, device=dev)
    cam = T.Camera.default(dev)
    cfg = T.RenderConfig(width=64, height=64, bounces=1, ortho_scale=1.0,
                         ray_chunk=chunk)
    target = T.render_frame(scene, cam, cfg) * 0.8
    if chunk:
        assert pipeline.culls_chunks(cfg, 64 * 64)
        chunk_hits = _chunk_hits(scene, cam, cfg)
        assert bool(chunk_hits.any()) and not bool(chunk_hits.all())

    def run(step, capturable, n=3, **kw):
        params = inverse.init_params(scene)
        opt = inverse.make_optimizer(params, 1e-2, capturable)
        losses = [step(params, opt, scene, cam, target, cfg, **kw)
                  for _ in range(n)]
        return params, opt, losses

    pg, og, lg = run(inverse.train_step_jit, True, lr=1e-2)
    pc, _, lc = run(inverse.train_step, True)
    assert all(torch.equal(a, b) for a, b in zip(lg, lc))
    assert all(torch.equal(a, b) for a, b in zip(pg, pc))
    assert float(lg[2]) < float(lg[0])
    p1, o1, l1 = run(inverse.train_step_jit, True, n=1, lr=1e-2)
    # one step, at the scene's own vertices: each loop ran a trip a hit
    # chunk of the frame there
    (step,) = inverse.step_graphs(o1).entries.values()
    trips = [int(t) for t in step.captured.trips]
    assert trips == ([int(chunk_hits.sum())] * 2 if chunk else []), trips
    pe, oe, le = run(inverse.train_step, False, n=1)
    assert torch.equal(l1[0], le[0])
    for a, b in zip(p1, pe):
        assert float((a.detach() - b.detach()).abs().max()) <= 1e-6
    before = [p.detach().clone() for p in pg]
    inverse.train_step_jit(pg, og, scene, cam, target, cfg, lr=0.0)
    assert all(torch.equal(p.detach(), b) for p, b in zip(pg, before))
    assert len(inverse.step_graphs(og).entries) == 1
    with pytest.raises(ValueError, match="capturable"):
        inverse.train_step_jit(pe, oe, scene, cam, target, cfg)


def test_graph_replays_after_an_eager_launch_lowers_the_smem_limit(dev):
    """K5's and K8's C entries set their kernel's dynamic shared-memory
    limit to each launch's need (cudaFuncSetAttribute, accepted inside a
    capture): a graph captured with a large need still replays right
    after an eager launch has set a smaller one (K5 on 6 912 then 256
    leaves, K8 on 8 192 then 1 024 codes)."""
    from raytracebvh_tpu_torch.camera import reference_rays
    from raytracebvh_tpu_torch.ops import sort_cuda, traverse_cuda
    from raytracebvh_tpu_torch.ops import traverse_shared_cuda

    big = traverse_cuda.with_tables(_bvh(dev, num_tris=6912, seed=1))
    small = traverse_cuda.with_tables(_bvh(dev, num_tris=200, seed=2))
    rays = reference_rays(256, 128, 4.0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    c8k = torch.randint(0, 1 << 30, (8192,), dtype=torch.int32, device=dev,
                        generator=gen)
    c1k = c8k[:1024].clone()
    for run, lower in (
            (lambda: traverse_shared_cuda.traverse(big, rays, 0.01),
             lambda: traverse_shared_cuda.traverse(small, rays, 0.01)),
            (lambda: sort_cuda.bitonic_sort_by_code(c8k),
             lambda: sort_cuda.bitonic_sort_by_code(c1k))):
        want = run()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            run()
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out = run()
        lower()
        graph.replay()
        torch.cuda.synchronize()
        want = want if isinstance(want, tuple) else (want.hit, want.distance,
                                                     want.leaf)
        out = out if isinstance(out, tuple) else (out.hit, out.distance,
                                                  out.leaf)
        assert all(torch.equal(a, b) for a, b in zip(out, want))


@pytest.mark.parametrize("kw", [dict(ray_tile=16), dict(ray_chunk=1024)],
                         ids=["one_graph", "culled_chunks"])
def test_graphed_stage_times(dev, kw):
    """stage_times on the card: the JAX function's keys, every stage a
    replayed graph with a finite positive time; trace_shade's graph (the
    culled loop's WHILE node inside it) gives shade_rays' bits."""
    from raytracebvh_tpu_torch import pipeline
    from raytracebvh_tpu_torch.utils import profiling

    scene, cam, cfg = _graph_frame_args(dev, **kw)
    assert pipeline.culls_chunks(cfg, 64 * 64) == ("ray_chunk" in kw)
    times = profiling.stage_times(scene, cam, cfg, iters=2)
    assert list(times) == ["morton", "sort", "topology", "fit", "links",
                           "build_total", "trace_shade", "frame_total"]
    assert all(np.isfinite(v) and v > 0 for v in times.values()), times
    with torch.no_grad():
        stages = profiling._graphed_stages(scene, cam, cfg)
        eager, (s, bvh, rays) = profiling._eager_stages(scene, cam, cfg)
        got = stages["trace_shade"]().clone()
        assert torch.equal(got, pipeline.shade_rays(s, bvh, rays, cfg))
        topo = stages["topology"]()
        assert all(torch.equal(a, b)
                   for a, b in zip(topo, eager["topology"]()))
    pipeline.FRAME_GRAPHS.clear()


def test_graphed_depth_image_equals_eager(dev):
    """render_depth_bmp on the card replays one graph a signature: every
    replay is the eager image's bytes, and a new stride captures anew."""
    from raytracebvh_tpu_torch.models.procedural import random_triangles
    from raytracebvh_tpu_torch.ref import refimage

    scene = random_triangles(150, seed=4, device=dev)
    refimage.DEPTH_GRAPHS.clear()
    for stride in (4, 4, 2, 4):
        got = refimage.render_depth_bmp(scene, 64, 64, stride)
        with torch.no_grad():
            want = refimage._depth_image(
                *refimage._depth_walk(scene, 64, 64, stride)(scene), 64, 64,
                stride)
        assert got.shape == want.shape and (got == want).all()
    assert len(refimage.DEPTH_GRAPHS.entries) == 2
    refimage.DEPTH_GRAPHS.clear()


def test_graphed_sharded_frames_and_step_world_one(dev):
    """render_sharded, render_geo_sharded and train_step_sharded over a
    world-1 NCCL group replay CUDA graphs with the collectives inside:
    each call equals the eager body (frames bit for bit, also a culled
    chunked frame; the step's loss bit for bit and its gradients within
    1e-6 of the largest |grad|, with grad_chunks 1 and 2, and a step
    whose rays cull chunks), a second call replays without a new capture
    (the graphs are the mesh's), and the parameters stay as they were.
    destroy_distributed drops the mesh's graphs and ends the group."""
    import raytracebvh_tpu_torch as T
    from raytracebvh_tpu_torch.models.inverse import apply_params, init_params
    from raytracebvh_tpu_torch.parallel import mesh, render

    scene, cam, cfg = _graph_frame_args(
        dev, enable_shadows=True, light_pos=(10.0, 80.0, -40.0))
    mesh.initialize_distributed()
    try:
        flat = mesh.make_mesh()
        cache = mesh.mesh_graphs(flat)
        assert cache is mesh.mesh_graphs(flat)
        assert cache is not mesh.mesh_graphs(mesh.make_mesh())
        cases = ((render.render_sharded, render._render_sharded, cfg),
                 (render.render_geo_sharded, render._render_geo_sharded, cfg),
                 (render.render_sharded, render._render_sharded,
                  cfg.replace(ray_chunk=512)))
        for fn, body, c in cases:
            want = T.render_frame(scene, cam, c)
            assert torch.equal(body(scene, cam, c, flat), want)
            for _ in range(2):
                assert torch.equal(fn(scene, cam, c, flat), want)
        assert len(cache.entries) == 3
        cfg_bwd = cfg.replace(enable_shadows=False, ray_tile=16)
        target = torch.zeros((64, 64, 4), device=dev)
        params = init_params(scene)
        before = [p.clone() for p in params]
        for chunks, c in ((1, cfg_bwd), (2, cfg_bwd),
                          (1, cfg_bwd.replace(ray_chunk=512))):
            loss_e, grads_e = render._train_step_sharded(
                params, apply_params, scene, cam, target, c, flat, chunks)
            for _ in range(2):
                loss, grads = render.train_step_sharded(
                    params, apply_params, scene, cam, target, c, flat,
                    chunks)
                assert torch.equal(loss, loss_e)
                for g, ge in zip(grads, grads_e):
                    tol = 1e-6 * float(ge.abs().max())
                    assert float((g - ge).abs().max()) <= tol
        assert all(torch.equal(p, b) for p, b in zip(params, before))
        assert len(cache.entries) == 6
    finally:
        mesh.destroy_distributed()
    assert not cache.entries


SHARDED_RANK = """
import os
import torch
import raytracebvh_tpu_torch as T
import torch.distributed as dist
from raytracebvh_tpu_torch.models.inverse import apply_params, init_params
from raytracebvh_tpu_torch.models.procedural import random_triangles
from raytracebvh_tpu_torch.parallel import mesh, render

torch.backends.cuda.matmul.allow_tf32 = False
mesh.initialize_distributed()
dev = torch.device("cuda", torch.cuda.current_device())
scene = random_triangles(300, seed=7, with_texture=True, device=dev)
cam = T.Camera.default(dev)
cfg = T.RenderConfig(width=64, height=64, bounces=1, ortho_scale=1.4,
                     enable_shadows=True, light_pos=(10.0, 80.0, -40.0))
flat, geo = mesh.make_mesh(), mesh.make_mesh(geo=2)
for fn, body, m, c in (
        (render.render_sharded, render._render_sharded, flat, cfg),
        (render.render_sharded, render._render_sharded, geo, cfg),
        (render.render_geo_sharded, render._render_geo_sharded, geo, cfg),
        (render.render_sharded, render._render_sharded, geo,
         cfg.replace(ray_chunk=512))):
    want = T.render_frame(scene, cam, c)
    assert torch.equal(body(scene, cam, c, m), want)
    for _ in range(2):
        assert torch.equal(fn(scene, cam, c, m), want), (fn.__name__, c)
assert len(mesh.mesh_graphs(flat).entries) == 1
assert len(mesh.mesh_graphs(geo).entries) == 3
cfg_bwd = cfg.replace(enable_shadows=False, ray_tile=16)
target = torch.zeros((64, 64, 4), device=dev)
params = init_params(scene)
for chunks, c in ((1, cfg_bwd), (2, cfg_bwd),
                  (1, cfg_bwd.replace(ray_chunk=512))):
    loss_e, grads_e = render._train_step_sharded(
        params, apply_params, scene, cam, target, c, geo, chunks)
    for _ in range(2):
        loss, grads = render.train_step_sharded(
            params, apply_params, scene, cam, target, c, geo, chunks)
        assert abs(float(loss - loss_e)) <= 1e-6 * abs(float(loss_e))
        for g, ge in zip(grads, grads_e):
            assert float((g - ge).abs().max()) <= 1e-6 * float(ge.abs().max())
assert len(mesh.mesh_graphs(geo).entries) == 6
caches = mesh.mesh_graphs(flat), mesh.mesh_graphs(geo)
mesh.destroy_distributed()  # with the meshes alive
assert not dist.is_initialized()
assert not any(c.entries for c in caches)
print("rank", os.environ["RANK"], "passed")
"""


@pytest.mark.parametrize("world", [2, 4])
def test_graphed_sharded_frames_and_step_across_ranks(dev, world, tmp_path):
    """The graphed sharded entry points at ``world`` ranks over NCCL, one
    card each (skips with fewer cards): on the flat (world x 1) and geo=2
    meshes, render_sharded (also a culled chunked frame) and
    render_geo_sharded equal the eager bodies and render_frame bit for bit
    on every call, and train_step_sharded (grad_chunks 1 and 2, and a
    culled chunked step: at 2 ranks the culled frame and step's case) its
    eager body within 1e-6 of the loss and of each gradient's largest |grad|
    (NCCL's sums across cards; the world-one test holds the bits).  Each
    rank then ends with destroy_distributed, its meshes still alive: it
    drops their graphs, which hold the communicators, before the group
    (destroy_process_group alone waits for them forever), and the rank
    exits cleanly within the timeout."""
    import socket
    import subprocess
    import sys

    from raytracebvh_tpu_torch import _kernels

    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA devices")
    _kernels.build()  # once, before the ranks load it
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    script = tmp_path / "rank.py"
    script.write_text(SHARDED_RANK)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, str(script)], cwd=root,
        env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                 LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                 PYTHONPATH=root),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"rank {r} passed" in out, out[-4000:]
