"""The port's shadow rays against the JAX package: the plain any-hit walk
(kernel K4's plain version), ``light_in_ray_space``, ``_shadow_vis`` and
whole shadowed frames.

Both sides walk the very tree the JAX build made (``bvh_from_numpy``).
Tolerances:
  * any-hit flags are compared exactly, against the jitted JAX
    ``traverse_any`` and the interpret-mode TPU kernel K4
    (``traverse_any_hbm_pallas``).  Both run a compiled loop body, in which
    XLA may contract a*b + c into one FMA, so their triangle distance can
    differ from the port's in the last ulp: a ray whose max_t lies within
    an ulp of a hit distance may flip (measured: up to 19 of 512 rays at
    one ulp, none at 2e-6 relative).  So the JAX comparisons set max_t at
    least 2e-6 (relative) away from hit distances; the one-ulp cases are
    held to the exact answer instead (``test_max_t_one_ulp_around_a_hit``).
  * ``light_in_ray_space`` and ``_shadow_vis`` exactly against eager JAX
    (op by op, no contraction).
  * frames within atol 1e-4 of the jitted JAX frame: the shading is the
    same sequence of operations, but XLA contracts some of it into FMAs
    (measured max |diff| 3.5e-5).  A shadow that differs changes its
    pixel by (1 - shadow_factor) * diffuse * texel > 0.1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracebvh_tpu as J
from raytracebvh_tpu.camera import camera_matrices as j_camera_matrices
from raytracebvh_tpu.core.types import scene_to_device
from raytracebvh_tpu.models.procedural import random_triangles as j_random
from raytracebvh_tpu.ops.traverse import traverse_any as j_traverse_any
from raytracebvh_tpu.ops.traverse_hbm import traverse_any_hbm_pallas
from raytracebvh_tpu import pipeline as jp
import raytracebvh_tpu_torch as T
from raytracebvh_tpu_torch import pipeline as tp
from raytracebvh_tpu_torch.core.types import HitRecord, bvh_from_numpy
from raytracebvh_tpu_torch.models.procedural import random_triangles as t_random
from raytracebvh_tpu_torch.ops import traverse as t_traverse
from raytracebvh_tpu_torch.ops import traverse_cuda

from test_torch_traverse import _both, _jax_bvh, _on_plane_rays, _random_rays

EPS = 0.01
LIGHT = (10.0, 80.0, -40.0)  # tests/test_shadows.py's light


def _max_t(nrays, seed, lo=5.0, hi=150.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, nrays).astype(np.float32)


def _straddle(tb, tr, rel):
    """max_t = (1 +- rel) x each ray's nearest hit distance (hi, lo), and
    the hit mask; 100 on missing rays."""
    rec = t_traverse.traverse(tb, tr, EPS)
    hit, t = rec.hit.numpy(), rec.distance.numpy()
    out = []
    for s in (1.0 + rel, 1.0 - rel):
        out.append(np.where(hit, t * np.float32(s), 100.0).astype(np.float32))
    return out, hit


def _jit_any(jb, jr, max_t):
    return np.asarray(jax.jit(lambda b, r, m: j_traverse_any(b, r, EPS, m))(
        jb, jr, jnp.asarray(max_t)))


def _k4(jb, jr, max_t):
    return np.asarray(traverse_any_hbm_pallas(
        jb, jr, EPS, jnp.asarray(max_t), block_rays=256, win=256,
        interpret=True))


@pytest.mark.parametrize("num_tris,seed,nrays", [(60, 0, 384), (400, 1, 512)])
def test_plain_any_matches_jax_traverse_any(num_tris, seed, nrays):
    jb = _jax_bvh(num_tris, seed)
    tb = bvh_from_numpy(jb, "cpu")
    jr, tr = _both(*_random_rays(nrays, seed + 50))
    max_t = _max_t(nrays, seed)
    got = t_traverse.traverse_any(tb, tr, EPS, torch.from_numpy(max_t))
    want = _jit_any(jb, jr, max_t)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()
    # max_t just above and just below each nearest hit
    (hi, lo), hit = _straddle(tb, tr, 2e-6)
    assert hit.any()
    for m in (hi, lo):
        np.testing.assert_array_equal(
            t_traverse.traverse_any(tb, tr, EPS, torch.from_numpy(m)).numpy(),
            _jit_any(jb, jr, m))


def test_plain_any_matches_interpret_mode_k4():
    """Random rays, max_t 2e-6 above and below hit distances, and on-plane
    rays (0 * inf = NaN in the slab test), against the TPU kernel as the
    JAX package's own test runs it (tests/test_traverse_hbm.py)."""
    jb = _jax_bvh(300, 2)
    tb = bvh_from_numpy(jb, "cpu")
    jr, tr = _both(*_random_rays(512, 7))
    cases = [(jr, tr, _max_t(512, 3, hi=500.0))]
    (hi, lo), hit = _straddle(tb, tr, 2e-6)
    cases += [(jr, tr, hi), (jr, tr, lo)]
    pjr, ptr = _both(*_on_plane_rays(jb, 512, 9))
    cases.append((pjr, ptr, np.full(512, 1e3, np.float32)))
    occs = []
    for j_rays, t_rays, m in cases:
        got = t_traverse.traverse_any(tb, t_rays, EPS, torch.from_numpy(m))
        np.testing.assert_array_equal(got.numpy(), _k4(jb, j_rays, m))
        occs.append(got.numpy())
    assert occs[1][hit].all() and not occs[2][hit].any()
    assert 0 < occs[3].mean() < 1  # some on-plane rays are occluded


def test_max_t_one_ulp_around_a_hit():
    """On every ray that hits, max_t one ulp above its nearest hit
    distance is occluded (t < max_t), and max_t equal to it or one ulp
    below is not: no triangle is nearer, and t < max_t is strict."""
    jb = _jax_bvh(400, 1)
    tb = bvh_from_numpy(jb, "cpu")
    _, tr = _both(*_random_rays(512, 51))
    rec = t_traverse.traverse(tb, tr, EPS)
    hit, t = rec.hit.numpy(), rec.distance.numpy()
    assert hit.sum() > 20
    for m, want in ((np.nextafter(t, np.float32(np.inf)), True), (t, False),
                    (np.nextafter(t, np.float32(0)), False)):
        occ = t_traverse.traverse_any(tb, tr, EPS, torch.from_numpy(m))
        assert (occ.numpy()[hit] == want).all()


def test_any_steps_and_cap():
    """Per-ray steps: the full walk ends within 4n; a cap of 3 stops every
    ray after three nodes, and a capped ray is occluded only if the full
    walk says so."""
    jb = _jax_bvh(200, 4)
    _, tr = _both(*_random_rays(256, 11))
    tb = bvh_from_numpy(jb, "cpu")
    max_t = torch.from_numpy(_max_t(256, 4, hi=400.0))
    occ, steps = t_traverse.traverse_any(tb, tr, EPS, max_t,
                                         return_steps=True)
    assert int(steps.min()) >= 1 and int(steps.max()) <= 4 * tb.n_leaves
    capped, csteps = t_traverse.traverse_any(tb, tr, EPS, max_t, max_steps=3,
                                             return_steps=True)
    assert int(csteps.max()) == 3
    assert not (capped & ~occ).any()


def test_cpu_any_wrapper_runs_plain_version_without_launching():
    jb = _jax_bvh(120, 5)
    _, tr = _both(*_random_rays(256, 13))
    tb = bvh_from_numpy(jb, "cpu")
    max_t = torch.from_numpy(_max_t(256, 5, hi=400.0))
    before = traverse_cuda.any_launches, traverse_cuda.launches
    got = traverse_cuda.traverse_any(tb, tr, EPS, max_t)
    want = t_traverse.traverse_any(tb, tr, EPS, max_t)
    assert (traverse_cuda.any_launches, traverse_cuda.launches) == before
    assert torch.equal(got, want)
    assert traverse_cuda.traverse_any_for("torch") is t_traverse.traverse_any
    assert traverse_cuda.traverse_any_for("cuda") is traverse_cuda.traverse_any


def _shadow_inputs(camera_mode):
    """The JAX side's bvh, rays, primary hits and light for a 48x48 frame
    of tests/test_shadows.py's scene, and the port's copies of them."""
    cfg = J.RenderConfig(width=48, height=48, bounces=0, enable_shadows=True,
                         light_pos=LIGHT, camera_mode=camera_mode)
    js = scene_to_device(j_random(300, seed=7, with_texture=True))
    cam = J.Camera.default()
    wvp, wv = j_camera_matrices(cam, 48, 48)
    if camera_mode == "perspective":
        wvp = wv = jnp.eye(4, dtype=jnp.float32)
    jb = jax.jit(lambda s: jp.build_bvh(s, wvp, wv, cfg))(js)
    jrays = jp.make_rays(cam, cfg)
    jrec = jp._traverse_ids(jb, jrays, cfg)
    tcfg = T.RenderConfig(**{f: getattr(cfg, f) for f in (
        "width", "height", "bounces", "enable_shadows", "light_pos",
        "camera_mode")})
    trec = HitRecord(hit=_torch(jrec.hit), distance=_torch(jrec.distance),
                     leaf=_torch(jrec.leaf))
    o, d = _torch(jrays.origin), _torch(jrays.direction)
    return (cfg, jb, jrays, jrec, wvp), (tcfg, bvh_from_numpy(jb, "cpu"), o, d, trec,
                                         _torch(wvp))


def _torch(x):
    return torch.from_numpy(np.array(x))  # an own, writable copy


@pytest.mark.parametrize("camera_mode", ["reference", "perspective"])
def test_light_and_shadow_vis_match_jax(camera_mode):
    (cfg, jb, jrays, jrec, wvp), (tcfg, tb, o, d, trec, twvp) = \
        _shadow_inputs(camera_mode)
    jl = jp.light_in_ray_space(cfg, wvp, jnp.float32)
    tl = tp.light_in_ray_space(tcfg, twvp, torch.float32)
    np.testing.assert_array_equal(np.array([float(x) for x in tl]),
                                  np.array([float(x) for x in jl]))
    jo3, jd3 = jp._split_rays(jrays)
    want = np.asarray(jp._shadow_vis(jb, jo3, jd3, jrec, jl, cfg))
    got = tp._shadow_vis(tb, tuple(o[:, k] for k in range(3)),
                         tuple(d[:, k] for k in range(3)), trec, tl, tcfg)
    np.testing.assert_array_equal(got.numpy(), want)
    hit = np.asarray(jrec.hit)
    shadowed = (want < 1.0)[hit].mean()
    assert 0 < shadowed < 1, shadowed
    assert (want[~hit] == 1.0).all()


def _render_both(**kw):
    kw = dict(dict(width=48, height=48, bounces=1, enable_shadows=True,
                   light_pos=LIGHT), **kw)
    js = scene_to_device(j_random(300, seed=7, with_texture=True))
    ts = t_random(300, device="cpu", seed=7, with_texture=True)
    want = np.asarray(J.render_frame_jit(js, J.Camera.default(),
                                         J.RenderConfig(**kw)))
    got = T.render_frame(ts, T.Camera.default("cpu"), T.RenderConfig(**kw))
    return got.numpy(), want


@pytest.mark.parametrize("kw", [
    dict(ortho_scale=2.0),
    dict(ortho_scale=2.0, ray_tile=16, texture_dtype="uint8"),
    dict(ortho_scale=2.0, ray_chunk=96),  # chunk loop with culling
    dict(ortho_scale=2.0, bounces=0),  # the bench's shadow config
], ids=["plain", "tiled_u8", "chunked_culled", "no_bounce"])
def test_shadowed_frame_matches_jax(kw):
    got, want = _render_both(**kw)
    bg = np.asarray(J.RenderConfig().background, np.float32)
    hits = ~(np.abs(want - bg) < 1e-6).all(-1)
    assert 0.05 < hits.mean() < 0.95
    if "ray_chunk" in kw:
        chunk_hits = hits.reshape(-1, kw["ray_chunk"]).any(-1)
        assert chunk_hits.any() and not chunk_hits.all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the shadows are really there: the frame differs from the unshadowed
    unshadowed = T.render_frame(
        t_random(300, device="cpu", seed=7, with_texture=True),
        T.Camera.default("cpu"),
        T.RenderConfig(**dict(dict(width=48, height=48, bounces=1,
                                   light_pos=LIGHT), **kw)))
    assert np.abs(got - unshadowed.numpy()).max() > 0.1


def test_shadow_rays_skip_culled_chunks(monkeypatch):
    """One any-hit walk per shaded chunk, none for a culled one: the
    chunk loop fires shadow rays only where a primary ray hit."""
    ts = t_random(300, device="cpu", seed=7, with_texture=True)
    cfg = T.RenderConfig(width=48, height=48, bounces=0, enable_shadows=True,
                         light_pos=LIGHT, ortho_scale=2.0, ray_chunk=96)
    calls = []
    real = t_traverse.traverse_any

    def counting(bvh, rays, *a, **k):
        calls.append(rays.origin.shape[0])
        return real(bvh, rays, *a, **k)

    monkeypatch.setattr(t_traverse, "traverse_any", counting)
    img = T.render_frame(ts, T.Camera.default("cpu"), cfg)
    bg = torch.tensor(cfg.background)
    shaded = (~(img - bg).abs().lt(1e-6).all(-1)).reshape(-1, 96).any(-1)
    assert len(calls) == int(shaded.sum()) > 0 and set(calls) == {96}
