"""The port's training step (``models/inverse.py``) against the JAX
package's: ``loss_fn`` values and gradients against
``jax.value_and_grad``, finite differences, chunking and culling, and
Adam against ``optax.adam``.

Both sides get the same scene (the procedural generators are copies,
seeded alike) and the same parameters (``params_from_numpy`` of the JAX
``init_params``).  Tolerances:
  * float64: loss rtol 1e-12, gradients 1e-10 of each tensor's largest
    |grad| (measured: 1e-16 and 8e-15);
  * float32: loss rtol 1e-6, gradients 1e-5 of each tensor's largest
    |grad| (measured: 7e-8 and 3e-6), against JAX run op by op: under one
    jit XLA contracts some a*b + c into FMAs, which the port does not, and
    the vertex gradient moves by 3.5e-5;
  * finite differences on the port in float64: rtol 1e-4, as
    tests/test_grad.py;
  * chunked and culled gradients against unchunked and unculled ones:
    tests/test_ray_chunk.py's rtol 1e-6 with atol 1e-7 and 1e-8; the
    culled chunk loop's against the unculled one's bit for bit (the
    trips add the tables' gradients in chunk order, and a culled chunk's
    are zeros, which a sum leaves as it is);
  * Adam against optax on the same gradients: atol 5e-7 on parameters
    of magnitude up to ~4 (two float32 ulps; the two round the update's
    terms in another order) at lr 1e-2; the
    parameters after one train_step against JAX's: atol 1e-7; after two:
    atol 1e-5, since the second gradient is taken where the two sides'
    first updates already differ (measured: 1.3e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import raytracebvh_tpu as J
from raytracebvh_tpu.core.types import scene_to_device
from raytracebvh_tpu.models import inverse as ji
from raytracebvh_tpu.models.procedural import random_triangles as j_random
import raytracebvh_tpu_torch as T
from raytracebvh_tpu_torch.models import inverse as ti
from raytracebvh_tpu_torch.models.procedural import random_triangles as t_random

from gathered_blocks import block_takers

FIELDS = ti.InverseParams._fields
# tests/test_grad.py's scene: the 24x24 window sees ~1/3 hit pixels, and
# the texture makes vertex positions matter (through the uv lookup)
GRAD_SCENE = dict(num_tris=40, seed=11, extent=8.0, tri_size=2.0,
                  with_texture=True)


def _scenes(dtype="float32", num_tris=40, **kw):
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    js = scene_to_device(j_random(num_tris, **kw), dtype=jdt)
    ts = t_random(num_tris, device="cpu", **kw)
    if dtype == "float64":
        ts = _float64(ts)
    return js, ts


def _float64(ts):
    m = ts.materials
    return ts.replace(
        verts=ts.verts.double(), normals=ts.normals.double(),
        uv=ts.uv.double(), textures=ts.textures.double(),
        materials=m.replace(**{f: getattr(m, f).double() for f in (
            "ambient", "diffuse", "specular", "shininess",
            "optical_density", "alpha")}))


def _jax_value_and_grad(js, cfg, target, dtype=jnp.float32, jit=False):
    fn = jax.value_and_grad(ji.loss_fn)
    if jit:
        fn = jax.jit(fn, static_argnames=("cfg",))
    loss, g = fn(ji.init_params(js), js, J.Camera.default(dtype),
                 jnp.asarray(target, dtype), cfg)
    return float(loss), [np.asarray(getattr(g, f)) for f in FIELDS]


def _port_value_and_grad(params, ts, cfg, target):
    cam = T.Camera.default("cpu", dtype=params.diffuse.dtype)
    loss = ti.loss_fn(params, ts, cam, torch.as_tensor(target), cfg)
    loss.backward()
    return float(loss), [getattr(params, f).grad.numpy() for f in FIELDS]


def _assert_grads(got, want, rel):
    for f, a, b in zip(FIELDS, got, want):
        scale = np.abs(b).max()
        assert scale > 0, f
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale, err_msg=f)


def test_value_and_grad_match_jax_float64():
    cfg_kw = dict(width=24, height=24, bounces=1, dtype="float64",
                  texture_dtype="float32")
    target = np.zeros((24, 24, 4))
    with jax.enable_x64(True):
        js, ts = _scenes("float64", **GRAD_SCENE)
        want_loss, want = _jax_value_and_grad(
            js, J.RenderConfig(**cfg_kw), target, jnp.float64, jit=True)
        params = ti.params_from_numpy(ji.init_params(js), device="cpu")
    assert params.diffuse.dtype == torch.float64
    loss, got = _port_value_and_grad(params, ts, T.RenderConfig(**cfg_kw),
                                     target)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-12)
    _assert_grads(got, want, 1e-10)


def test_value_and_grad_match_jax_kernel_backward_float32():
    """float32, the JAX side through its windowed gather, whose backward
    is the TPU scatter kernel K3 (interpret mode); the port's through its
    CPU path.  Both bounces' gathers carry gradient."""
    js, ts = _scenes(**GRAD_SCENE)
    cfg_kw = dict(width=24, height=24, bounces=1)
    target = np.zeros((24, 24, 4), np.float32)
    want_loss, want = _jax_value_and_grad(
        js, J.RenderConfig(**cfg_kw, shade_gather_backend="windowed"),
        target)
    params = ti.params_from_numpy(ji.init_params(js), device="cpu")
    loss, got = _port_value_and_grad(params, ts, T.RenderConfig(**cfg_kw),
                                     target)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    _assert_grads(got, want, 1e-5)


def _fd_setup():
    _, ts = _scenes("float64", **GRAD_SCENE)
    cfg = T.RenderConfig(width=24, height=24, bounces=1, dtype="float64")
    target = torch.zeros((24, 24, 4), dtype=torch.float64)
    cam = T.Camera.default("cpu", dtype=torch.float64)
    params = ti.init_params(ts)

    def loss_of(p):
        with torch.no_grad():
            return float(ti.loss_fn(p, ts, cam, target, cfg))

    ti.loss_fn(params, ts, cam, target, cfg).backward()
    return params, loss_of


def _moved(params, field, i, j, eps):
    p = {f: getattr(params, f).detach().clone() for f in FIELDS}
    p[field][i, j] += eps
    return ti.InverseParams(**p)


def test_grad_diffuse_matches_finite_differences():
    params, loss_of = _fd_setup()
    g = params.diffuse.grad.numpy()
    assert np.isfinite(g).all()
    rng = np.random.default_rng(0)
    eps, checked = 1e-6, 0
    for _ in range(6):
        i, j = int(rng.integers(0, g.shape[0])), int(rng.integers(0, 3))
        fd = (loss_of(_moved(params, "diffuse", i, j, eps))
              - loss_of(_moved(params, "diffuse", i, j, -eps))) / (2 * eps)
        if abs(fd) < 1e-12:
            continue
        np.testing.assert_allclose(g[i, j], fd, rtol=1e-4)
        checked += 1
    assert checked >= 2


def test_grad_verts_matches_finite_differences():
    params, loss_of = _fd_setup()
    g = params.vert_offsets.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    eps = 1e-7
    for k in np.argsort(-np.abs(g).ravel())[:8]:
        i, j = divmod(int(k), 3)
        fd = (loss_of(_moved(params, "vert_offsets", i, j, eps))
              - loss_of(_moved(params, "vert_offsets", i, j, -eps))) / (2 * eps)
        np.testing.assert_allclose(g[i, j], fd, rtol=1e-4)


def _port_grads(ts, cfg, target):
    params = ti.init_params(ts)
    ti.loss_fn(params, ts, T.Camera.default("cpu"), target, cfg).backward()
    return [getattr(params, f).grad.numpy() for f in FIELDS]


@pytest.mark.parametrize("bounces", [0, 1])
def test_gathered_rows_have_one_backward_node(bounces, monkeypatch):
    """Each shading call's gathered [40, R] leaf-row block reaches the
    loss through one UnbindBackward0 alone, whose backward stacks the
    rows' gradients once, and through no SelectBackward0 a row, whose
    backward fills and adds a whole block's gradient: one block a pass,
    the primary and each bounce."""
    _, ts = _scenes(**GRAD_SCENE)
    cfg = T.RenderConfig(width=24, height=24, bounces=bounces)
    target = torch.zeros((24, 24, 4))
    _, takers = block_takers(monkeypatch, lambda: ti.loss_fn(
        ti.init_params(ts), ts, T.Camera.default("cpu"), target, cfg))
    assert takers == [["UnbindBackward0"]] * (bounces + 1)


def test_ray_chunk_grads_match():
    """tests/test_ray_chunk.py::test_ray_chunk_grads_match on the port."""
    ts = t_random(100, device="cpu", seed=10)
    target = torch.zeros((16, 16, 4))
    base = T.RenderConfig(width=16, height=16, bounces=1, ortho_scale=0.2)
    g0 = _port_grads(ts, base, target)
    g1 = _port_grads(ts, base.replace(ray_chunk=64), target)
    assert max(np.abs(a).max() for a in g0) > 0
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_cull_empty_chunks_grads_identical():
    """tests/test_ray_chunk.py::test_cull_empty_chunks_identical's
    gradients on the port: shadows on, most chunks all-miss.  The culled
    loop's equal the unculled loop's bit for bit: both add the chunks'
    gradients in chunk order, the culled chunks' zeros left out."""
    ts = t_random(60, device="cpu", seed=11, with_texture=True)
    target = torch.zeros((32, 32, 4))
    base = T.RenderConfig(width=32, height=32, bounces=2, ortho_scale=0.05,
                          enable_shadows=True, ray_chunk=128)
    g0 = _port_grads(ts, base.replace(cull_empty_chunks=False), target)
    g1 = _port_grads(ts, base.replace(cull_empty_chunks=True), target)
    assert max(np.abs(a).max() for a in g0) > 0
    for a, b in zip(g0, g1):
        np.testing.assert_array_equal(a, b)
    g2 = _port_grads(ts, base.replace(ray_chunk=0), target)
    for a, b in zip(g2, g1):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-8)


def _chunk_loop_grads_against_jax(dtype, cull):
    """The chunk loop's gradients (pipeline._ChunkMap: each chunk's
    shading recomputed in a second loop and its vector-Jacobian product;
    with ``cull`` the hit chunks alone) and JAX's jax.grad through lax.map
    (of lax.cond with ``cull``), on tests/test_ray_chunk.py::
    test_cull_empty_chunks_identical's scene and config, at that test's
    rtol 1e-6 and atol 1e-8."""
    cfg_kw = dict(width=32, height=32, bounces=2, ortho_scale=0.05,
                  enable_shadows=True, ray_chunk=128, dtype=dtype,
                  texture_dtype="float32", cull_empty_chunks=cull)
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    target = np.zeros((32, 32, 4))
    with jax.enable_x64(dtype == "float64"):
        js, ts = _scenes(dtype, num_tris=60, seed=11, with_texture=True)
        jcfg = J.RenderConfig(**cfg_kw)
        g = jax.grad(lambda p: ji.loss_fn(p, js, J.Camera.default(jdt),
                                          jnp.asarray(target, jdt), jcfg))(
            ji.init_params(js))
        want = [np.asarray(getattr(g, f)) for f in FIELDS]
        params = ti.params_from_numpy(ji.init_params(js), device="cpu")
    tcfg = T.RenderConfig(**cfg_kw)
    with torch.no_grad():
        img = T.render_frame(ts, T.Camera.default("cpu", params.diffuse.dtype),
                             tcfg)
    bg = torch.tensor(tcfg.background, dtype=img.dtype)
    chunk_hits = (img - bg).abs().ge(1e-6).any(-1).reshape(-1, 128).any(-1)
    assert chunk_hits.any() and not chunk_hits.all()
    _, got = _port_value_and_grad(params, ts, tcfg,
                                  target.astype(np.dtype(dtype)))
    assert max(np.abs(a).max() for a in want) > 0
    for f, a, b in zip(FIELDS, got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-8, err_msg=f)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_culled_chunk_vjp_matches_jax_grad(dtype):
    """The culled chunk loop's gradient against JAX's through lax.map of
    lax.cond (``_chunk_loop_grads_against_jax``)."""
    _chunk_loop_grads_against_jax(dtype, cull=True)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_unculled_chunk_vjp_matches_jax_grad(dtype):
    """The unculled chunk loop's gradient (every chunk a trip of both
    loops) against JAX's through lax.map (``_chunk_loop_grads_against_jax``)."""
    _chunk_loop_grads_against_jax(dtype, cull=False)


@pytest.mark.parametrize("cull", [False, True], ids=["unculled", "culled"])
def test_chunk_loop_ray_gradients_match_unchunked(cull):
    """The chunk loop's gradient with respect to the rays themselves (each
    trip writes its chunk's rows; a culled chunk's stay zero) against the
    unchunked frame's, in float64: a ray's gradient takes only its own
    operations, so they agree to rtol 1e-12."""
    from raytracebvh_tpu_torch import pipeline as tp

    ts = _float64(t_random(60, device="cpu", seed=11, with_texture=True))
    cfg = T.RenderConfig(width=32, height=32, bounces=1, ortho_scale=0.05,
                         ray_chunk=128, dtype="float64",
                         texture_dtype="float32", cull_empty_chunks=cull)
    cam = T.Camera.default("cpu", torch.float64)
    bvh, rays, _ = tp.frame_inputs(ts, cam, cfg)
    w = torch.randn(32 * 32, 4, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(5))
    out = []
    for run in (cfg, cfg.replace(ray_chunk=0)):
        o, d = (x.detach().clone().requires_grad_(True)
                for x in (rays.origin, rays.direction))
        color = tp.shade_rays(ts, bvh, T.Rays(o, d), run)
        (color * w).sum().backward()
        out.append((color.detach(), o.grad, d.grad))
    (c1, o1, d1), (c0, o0, d0) = out
    assert torch.equal(c1, c0)
    hit = (c0 - torch.tensor(cfg.background, dtype=c0.dtype)).abs().ge(
        1e-6).any(-1)
    assert bool(hit.any()) and float(o0[hit].abs().max()) > 0
    for a, b in ((o1, o0), (d1, d0)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=0)


# tests/test_grad.py::test_train_step_lr_takes_effect's scene and frame
STEP_SCENE = dict(num_tris=12, seed=3, extent=8.0, tri_size=2.0,
                  with_texture=True)
STEP_CFG = dict(width=16, height=16, bounces=0)


def test_adam_matches_optax_on_the_same_gradients():
    """make_optimizer's Adam against optax.adam over three updates with
    the same gradients, tiny ones (below eps) included."""
    rng = np.random.default_rng(7)
    start = [rng.normal(size=(5, 4)).astype(np.float32) for _ in FIELDS]
    grads = [[(rng.normal(size=(5, 4)) * 10.0 ** rng.integers(-10, 1, (5, 4)))
              .astype(np.float32) for _ in FIELDS] for _ in range(3)]
    params = ti.params_from_numpy(ji.InverseParams(*start), device="cpu")
    opt = ti.make_optimizer(params, 1e-2)
    jparams = ji.InverseParams(*map(jnp.asarray, start))
    jopt = optax.adam(1e-2)
    state = jopt.init(jparams)
    for gs in grads:
        for p, g in zip(params, gs):
            p.grad = torch.from_numpy(g)
        opt.step()
        upd, state = jopt.update(ji.InverseParams(*map(jnp.asarray, gs)),
                                 state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for p, q in zip(params, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(q),
                                       rtol=0, atol=5e-7)


def test_train_steps_match_jax_train_step():
    """One and two steps of train_step (torch.optim.Adam) against the JAX
    train_step (optax.adam), from the same parameters."""
    js, ts = _scenes(**STEP_SCENE)
    target = np.zeros((16, 16, 4), np.float32)
    jparams = ji.init_params(js)
    opt_state = optax.adam(1e-2).init(jparams)
    params = ti.params_from_numpy(jparams, device="cpu")
    opt = ti.make_optimizer(params, 1e-2)
    tcfg, jcfg = T.RenderConfig(**STEP_CFG), J.RenderConfig(**STEP_CFG)
    for step in range(2):
        jparams, opt_state, jloss = ji.train_step(
            jparams, opt_state, js, J.Camera.default(), jnp.asarray(target),
            jcfg, 1e-2)
        loss = ti.train_step(params, opt, ts, T.Camera.default("cpu"),
                             torch.from_numpy(target), tcfg)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
        for f in FIELDS:
            got = getattr(params, f).detach().numpy()
            np.testing.assert_allclose(got, np.asarray(getattr(jparams, f)),
                                       rtol=0, atol=(1e-7, 1e-5)[step],
                                       err_msg=f"{f}, step {step + 1}")
    assert np.abs(params.diffuse.detach().numpy()
                  - np.asarray(ji.init_params(js).diffuse)).max() > 0


def test_train_step_lr_takes_effect():
    """tests/test_grad.py::test_train_step_lr_takes_effect on the port:
    the optimizer's lr drives the update."""
    _, ts = _scenes(**STEP_SCENE)
    target = torch.zeros((16, 16, 4))
    start = ti.init_params(ts).diffuse.detach()
    moves = []
    for lr in (1e-2, 1e-4):
        params = ti.init_params(ts)
        ti.train_step(params, ti.make_optimizer(params, lr), ts,
                      T.Camera.default("cpu"), target, T.RenderConfig(**STEP_CFG))
        moves.append(float((params.diffuse.detach() - start).abs().max()))
    da, db = moves
    assert da > 0 and db > 0
    # adam's first step is ~lr * sign(g): the two lrs must differ ~100x
    assert da > db * 10


def test_params_from_numpy_round_trips():
    js, ts = _scenes(**STEP_SCENE)
    jparams = ji.init_params(js)
    params = ti.params_from_numpy(jparams, device="cpu")
    mine = ti.init_params(ts)
    for f in FIELDS:
        p = getattr(params, f)
        assert p.is_leaf and p.requires_grad and p.device.type == "cpu"
        want = np.asarray(getattr(jparams, f))
        np.testing.assert_array_equal(p.detach().numpy(), want)
        assert p.dtype == torch.from_numpy(want).dtype
        np.testing.assert_array_equal(getattr(mine, f).detach().numpy(), want)
    # and back through numpy
    again = ti.params_from_numpy(ti.InverseParams(
        *(getattr(params, f).detach().numpy() for f in FIELDS)), device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(again, f), getattr(params, f))


def test_gradients_survive_scene_to_device():
    """apply_params then .to(device): the moved scene's tensors keep their
    graph, so the gradient reaches the parameters."""
    _, ts = _scenes(**STEP_SCENE)
    params = ti.init_params(ts)
    moved = ti.apply_params(params, ts).to("cpu")
    assert moved.verts.requires_grad and moved.materials.diffuse.requires_grad
    (moved.verts.sum() + moved.materials.diffuse.sum()).backward()
    assert float(params.vert_offsets.grad.abs().min()) == 1.0
    assert float(params.diffuse.grad.abs().min()) == 1.0
