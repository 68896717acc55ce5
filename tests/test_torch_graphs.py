"""The port's compiled entry points on the CPU: ``render_frame_jit``,
``models.inverse.train_step_jit`` and the capture helpers of ``graphs``.

On CPU tensors ``render_frame_jit`` is ``render_frame`` and
``train_step_jit`` is ``train_step`` (the CUDA graphs run only on the
card: ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 11).  What
the CPU can show is held here:

  * ``render_frame_jit`` against the JAX package's jitted frame at 48x32
    and 48x48 (atol 1e-4: XLA contracts some of the jitted frame into
    FMAs, ROADMAP queue 3), against the eager JAX frame for refraction
    (atol 1e-5: the jitted FMAs move refracted directions by an ulp,
    which a textured bounce amplifies);
  * the culled chunk loop's two passes bit for bit against the one-pass
    loop they replace (``_one_pass_shade_rays``), with some, none and
    every chunk hitting, and its trips (``chunk_order``) against the
    chunks' hit flags;
  * ``graphs.while_loop`` eagerly for 0, 1 and n trips (at least one
    under ``warming``);
  * the capture-safe constants bit for bit against the host literals
    they replace, in float32, bfloat16 and float16;
  * the unchunked frame issuing no host read and no tensor literal
    outside the plain walks (a ``TorchDispatchMode`` guard), and the
    culled frame and step none but the chunk loop's count;
  * ``train_step_jit`` equal to ``train_step`` (also culled), a
    capturable Adam's state through ``adam_state`` /
    ``optimizer_from_numpy``, and its captures held by the optimizer,
    freed with it (``inverse.step_graphs``).
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

import raytracebvh_tpu as J
from raytracebvh_tpu.core.types import scene_to_device
from raytracebvh_tpu.models.procedural import random_triangles as j_random
from raytracebvh_tpu.pipeline import render_frame as j_render_frame
import raytracebvh_tpu_torch as T
from raytracebvh_tpu_torch import camera as tcam
from raytracebvh_tpu_torch import graphs
from raytracebvh_tpu_torch import pipeline as tp
from raytracebvh_tpu_torch.core.types import Rays
from raytracebvh_tpu_torch.models import inverse
from raytracebvh_tpu_torch.models.procedural import random_triangles as t_random
from raytracebvh_tpu_torch.ops import traverse as t_traverse

LIGHT = (10.0, 80.0, -40.0)  # tests/test_shadows.py's light
GLASS = dict(alpha=0.4, optical_density=0.7)  # tests/test_refraction.py:21


def _bg_mask(img):
    bg = np.asarray(J.RenderConfig().background, np.float32)
    return ~(np.abs(img - bg) < 1e-6).all(-1)


@pytest.mark.parametrize("scene_kw,kw,jitted,atol", [
    (dict(num=300, seed=6, with_texture=True),
     dict(width=48, height=32, bounces=1, ortho_scale=2.0, ray_tile=16,
          texture_dtype="uint8"), True, 1e-4),
    (dict(num=300, seed=7, with_texture=True),
     dict(width=48, height=48, bounces=1, ortho_scale=2.0,
          enable_shadows=True, light_pos=LIGHT), True, 1e-4),
    (dict(num=200, seed=11, with_texture=True, **GLASS),
     dict(width=48, height=48, bounces=1, ortho_scale=0.2, ray_tile=16,
          texture_dtype="uint8", enable_refraction=True), False, 1e-5),
    (dict(num=300, seed=6, with_texture=True),
     dict(width=48, height=32, bounces=1, ortho_scale=2.0, ray_chunk=96),
     True, 1e-4),
    (dict(num=300, seed=7, with_texture=True),
     dict(width=48, height=48, bounces=0, ortho_scale=2.0, ray_chunk=96,
          enable_shadows=True, light_pos=LIGHT), True, 1e-4),
], ids=["plain", "shadowed", "refract", "culled_chunks",
        "culled_chunks_shadows"])
def test_render_frame_jit_matches_jax(scene_kw, kw, jitted, atol):
    scene_kw = dict(scene_kw)
    n = scene_kw.pop("num")
    js = scene_to_device(j_random(n, **scene_kw))
    ts = t_random(n, device="cpu", **scene_kw)
    jax_frame = J.render_frame_jit if jitted else j_render_frame
    want = np.asarray(jax_frame(js, J.Camera.default(), J.RenderConfig(**kw)))
    got = T.render_frame_jit(ts, T.Camera.default("cpu"), T.RenderConfig(**kw))
    assert got.shape == want.shape and got.dtype == torch.float32
    hits = _bg_mask(want)
    assert 0.02 < hits.mean() < 0.95
    if "ray_chunk" in kw:
        chunk_hits = hits.reshape(-1, kw["ray_chunk"]).any(-1)
        assert chunk_hits.any() and not chunk_hits.all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    # on the CPU it is render_frame, bit for bit
    assert torch.equal(got, T.render_frame(ts, T.Camera.default("cpu"),
                                           T.RenderConfig(**kw)))


def _one_pass_shade_rays(scene, bvh, rays, cfg, light3=None):
    """The culled chunk loop before its two passes: each chunk traced,
    then shaded or replaced by the background, one chunk after another,
    with a host read a chunk."""
    bvh, tex_quads = tp.shade_setup(scene, bvh, cfg)
    chunk = cfg.ray_chunk
    dtype = cfg.torch_dtype
    if tex_quads.dtype != torch.uint8:
        dtype = torch.promote_types(dtype, tex_quads.dtype)
    bg = torch.tensor(cfg.background, dtype=dtype).expand(chunk, 4)
    out = []
    for s in range(0, rays.origin.shape[0], chunk):
        r = Rays(rays.origin[s:s + chunk], rays.direction[s:s + chunk])
        rec = tp._traverse_ids(bvh, r, cfg)
        if not bool(rec.hit.any()):
            out.append(bg)
            continue
        out.append(tp._shade_rays_one(scene, bvh, r, cfg, tex_quads, light3,
                                      rec))
    return torch.cat(out)


@pytest.mark.parametrize("share,ortho_scale,away", [
    ("some", 0.05, False), ("none", 2.0, True), ("all", 10.0, False)])
@pytest.mark.parametrize("extra", [
    dict(), dict(enable_shadows=True, light_pos=LIGHT, bounces=0),
    dict(dtype="bfloat16"),
    dict(enable_refraction=True, ray_tile=16, texture_dtype="uint8")],
    ids=["plain", "shadows", "bf16", "refract_tiled_u8"])
def test_two_pass_chunk_loop_equals_one_pass(share, ortho_scale, away,
                                             extra):
    """shade_rays' culled loop (every chunk's primary walk, one host read,
    then the hit chunks' shading) gives the one-pass loop's bits, whether
    some, no (the camera looks away) or every chunk hits."""
    scene = t_random(300, device="cpu", seed=6, with_texture=True, **GLASS)
    cam = T.Camera.default("cpu")
    if away:
        cam = cam.replace(at=torch.tensor([0.0, 5.0, -200.0]))
    cfg = T.RenderConfig(**dict(dict(width=48, height=32, bounces=1,
                                     ray_chunk=96, ortho_scale=ortho_scale),
                                **extra))
    bvh, rays, light3 = tp.frame_inputs(scene, cam, cfg)
    rays = tp.tile_frame_rays(rays, cfg, cfg.width, cfg.height)
    got = tp.shade_rays(scene, bvh, rays, cfg, light3)
    want = _one_pass_shade_rays(scene, bvh, rays, cfg, light3)
    assert got.dtype == want.dtype and torch.equal(got, want)
    _, any_hit = tp.trace_chunks(tp.shade_setup(scene, bvh, cfg)[0], rays,
                                 cfg)
    hit = any_hit.tolist()
    assert {"some": any(hit) and not all(hit), "none": not any(hit),
            "all": all(hit)}[share], hit


def test_trace_chunks_flags_are_the_chunks_any_hit():
    scene = t_random(300, device="cpu", seed=6, with_texture=True)
    cfg = T.RenderConfig(width=48, height=32, bounces=1, ray_chunk=96,
                         ortho_scale=2.0)
    bvh, rays, _ = tp.frame_inputs(scene, T.Camera.default("cpu"), cfg)
    recs, any_hit = tp.trace_chunks(bvh, rays, cfg)
    whole = tp._traverse_ids(bvh, rays, cfg)
    assert any_hit.dtype == torch.bool and any_hit.shape == (16,)
    for f in ("hit", "distance", "leaf"):
        assert getattr(recs, f).shape == (16, 96)
        assert torch.equal(getattr(recs, f).reshape(-1), getattr(whole, f))
    assert torch.equal(any_hit, whole.hit.reshape(16, 96).any(-1))


@pytest.mark.parametrize("n", [0, 1, 5])
def test_while_loop_runs_its_body_count_times(n):
    """graphs.while_loop eagerly: body(j) for j = 0 .. n - 1 in order, j a
    0-d int32 tensor on the count's device, for an int count and a 0-d
    integer tensor; the returned counter holds the trips run; under
    warming() a loop of 0 trips runs its body once (j = 0)."""
    for count in (n, torch.tensor(n), torch.tensor(n, dtype=torch.int32)):
        seen = []

        def body(j):
            assert j.dim() == 0 and j.dtype == torch.int32
            seen.append(int(j))

        trips = graphs.while_loop(count, body, "cpu")
        assert seen == list(range(n))
        assert trips.dtype == torch.int32 and int(trips) == n
        seen.clear()
        with graphs.warming():
            trips = graphs.while_loop(count, body, "cpu")
        assert seen == list(range(max(n, 1))) and int(trips) == max(n, 1)
    with pytest.raises(ValueError, match="needs a device"):
        graphs.while_loop(n, lambda j: None)
    with pytest.raises(ValueError, match="0-d integer"):
        graphs.while_loop(torch.tensor([n]), lambda j: None)


@pytest.mark.parametrize("flags", [
    [False, True, True, False, False, True, False, False],
    [False] * 8, [True] * 8], ids=["some", "none", "all"])
def test_chunk_order_is_the_hit_chunks_first(flags):
    """The chunk loop's trips: culled, the hit chunks in chunk order, then
    the rest (which no trip visits), and their number as a 0-d int32
    tensor; unculled, every chunk in order and their number as an int."""
    hit = torch.tensor(flags)
    order, count = tp.chunk_order(hit, cull=True)
    hits = [i for i, f in enumerate(flags) if f]
    misses = [i for i, f in enumerate(flags) if not f]
    assert order.tolist() == hits + misses
    assert count.dtype == torch.int32 and count.dim() == 0
    assert int(count) == len(hits)
    order, count = tp.chunk_order(hit, cull=False)
    assert order.tolist() == list(range(8)) and count == 8


def test_culls_chunks():
    cfg = T.RenderConfig(ray_chunk=96)
    assert tp.culls_chunks(cfg, 1536)
    assert not tp.culls_chunks(cfg, 96)  # one chunk: the whole frame
    assert not tp.culls_chunks(cfg.replace(cull_empty_chunks=False), 1536)
    assert not tp.culls_chunks(cfg.replace(ray_chunk=0), 1536)
    with pytest.raises(ValueError, match="must divide"):
        tp.culls_chunks(cfg, 1000)


DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.mark.parametrize("dtype", DTYPES)
def test_capture_safe_constants_keep_their_bits(dtype):
    """The constants now made on the device (torch.full, new_full, a
    fill) equal the host literals they replace, bit for bit."""
    cam = T.Camera.default("cpu", dtype=dtype)
    for w, h in ((1920, 1080), (48, 32), (17, 9)):
        wvp, wv = tcam.camera_matrices(cam, w, h)
        view = tcam.look_at_lh(cam.eye, cam.at, cam.up)
        aspect = torch.tensor(h, dtype=dtype) / torch.tensor(w, dtype=dtype)
        proj = tcam.perspective_fov_lh(cam.fov, aspect, cam.near, cam.far)
        assert torch.equal(wvp, view @ proj) and torch.equal(wv, view)

        rays = tcam.reference_rays(w, h, 4.0, dtype, "cpu")
        xs, ys = torch.arange(w, dtype=dtype), torch.arange(h, dtype=dtype)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        hx, hy = torch.tensor(w // 2, dtype=dtype), torch.tensor(h // 2,
                                                                 dtype=dtype)
        four = torch.tensor(4.0, dtype=dtype)
        origin = torch.stack([(gx - hx) / four, (gy - hy) / four,
                              torch.zeros_like(gx)], -1).reshape(-1, 3)
        direction = torch.tensor([0.0, 0.0, 1.0], dtype=dtype).expand(
            origin.shape)
        assert torch.equal(rays.origin, origin)
        assert torch.equal(rays.direction, direction)
        assert rays.direction.is_contiguous()

    for light_pos in (LIGHT, (0.0, 60.0, -60.0), (0.1, -3.3, 1e-3)):
        cfg = T.RenderConfig(light_pos=light_pos)
        for mode in ("reference", "perspective"):
            cfg = cfg.replace(camera_mode=mode)
            got = tp.light_in_ray_space(cfg, wvp, dtype)
            light = torch.tensor(light_pos, dtype=dtype)
            if mode == "reference":
                light = tcam.transform_points(light[None], wvp.to(dtype))[0]
            assert all(torch.equal(g, light[i]) for i, g in enumerate(got))

    for tex_dtype in (torch.uint8, torch.float32):
        cfg = T.RenderConfig(ray_chunk=64, dtype=str(dtype).split(".")[1],
                             background=(0.5, 0.25, 0.1, 1.0))
        got = tp.chunk_background(cfg, torch.zeros(1, 16, dtype=tex_dtype),
                                  "cpu")
        want_dtype = dtype if tex_dtype == torch.uint8 else \
            torch.promote_types(dtype, tex_dtype)
        want = torch.tensor(cfg.background, dtype=want_dtype).expand(64, 4)
        assert got.dtype == want_dtype and torch.equal(got, want)


def test_tile_permutation_is_tile_order_on_the_device():
    perm, inv = tcam.tile_permutation(40, 24, 16, torch.device("cpu"))
    p, i = tcam.tile_order(40, 24, 16)
    assert perm.dtype == torch.int64 and torch.equal(perm, torch.from_numpy(p))
    assert torch.equal(inv, torch.from_numpy(i))
    # made once a frame size and tile
    assert tcam.tile_permutation(40, 24, 16, torch.device("cpu"))[0] is perm


class _NoHostReads(TorchDispatchMode):
    """Fails on what a CUDA graph cannot replay: a read of a tensor's value
    on the host (``_local_scalar_dense``: ``.item()``, ``bool()``) and a
    tensor literal copied from host memory (``lift_fresh``)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.name()
        if "_local_scalar_dense" in name or "lift_fresh" in name:
            raise AssertionError(f"host read or tensor literal: {name}")
        return func(*args, **(kwargs or {}))


def _unguarded(walk):
    def run(*args, **kw):
        with _disable_current_modes():
            return walk(*args, **kw)
    return run


@pytest.mark.parametrize("kw", [
    dict(width=48, height=32, ray_tile=16, texture_dtype="uint8"),
    dict(width=40, height=24, ray_tile=16),  # the permutation tile path
    dict(width=48, height=48, enable_shadows=True, light_pos=LIGHT,
         enable_refraction=True),
    dict(width=48, height=32, ray_chunk=96, cull_empty_chunks=False,
         traversal_chunk=48),
    dict(width=48, height=32, sort_backend="bitonic",
         traversal_backend="shared", shade_gather_backend="shared"),
], ids=["tiled_u8", "permuted_tiles", "shadows_refract", "chunks_unculled",
        "onchip_backends"])
def test_unchunked_frame_reads_nothing_back(monkeypatch, kw):
    """Outside the plain walks (CPU only: their loop asks the host whether
    a lane is live), a frame whose work the device decides alone makes no
    host read and no tensor literal, so a CUDA graph can hold it."""
    monkeypatch.setattr(t_traverse, "traverse",
                        _unguarded(t_traverse.traverse))
    monkeypatch.setattr(t_traverse, "traverse_any",
                        _unguarded(t_traverse.traverse_any))
    scene = t_random(300, device="cpu", seed=6, with_texture=True, **GLASS)
    cam = T.Camera.default("cpu")
    cfg = T.RenderConfig(bounces=1, ortho_scale=2.0, **kw)
    want = T.render_frame(scene, cam, cfg)  # warm: the tile permutations
    with _NoHostReads():
        got = T.render_frame(scene, cam, cfg)
    assert torch.equal(got, want)


def _count_on_the_host(while_loop):
    """graphs.while_loop with its count, a 0-d device tensor, read on the
    host outside the guard (what the graph's WHILE node reads on the
    card); the body runs under the guard."""
    def run(count, body, device=None):
        assert isinstance(count, torch.Tensor) and count.dim() == 0, count
        with _disable_current_modes():
            n = int(count)
        return while_loop(n, body, count.device)
    return run


@pytest.mark.parametrize("kw", [
    dict(width=48, height=32, ray_chunk=96, ortho_scale=0.05),
    dict(width=48, height=48, ray_chunk=96, ortho_scale=0.05, bounces=0,
         enable_shadows=True, light_pos=LIGHT, ray_tile=16),
], ids=["culled", "culled_shadows_tiled"])
def test_culled_frame_and_step_read_nothing_back_outside_the_loop(
        monkeypatch, kw):
    """The culled chunk loop's frame and its training step (loss and
    backward: two loops) make no host read and no tensor literal outside
    the plain walks but their loops' trip counts, each a 0-d device
    tensor, and give the eager frame's bits and loss: nothing but the
    loop's count decides on the host, and a captured loop's WHILE node
    reads it on the card."""
    monkeypatch.setattr(t_traverse, "traverse",
                        _unguarded(t_traverse.traverse))
    monkeypatch.setattr(t_traverse, "traverse_any",
                        _unguarded(t_traverse.traverse_any))
    scene = t_random(300, device="cpu", seed=6, with_texture=True)
    cam = T.Camera.default("cpu")
    cfg = T.RenderConfig(**dict(dict(bounces=1), **kw))
    assert tp.culls_chunks(cfg, cfg.width * cfg.height)
    want = T.render_frame(scene, cam, cfg)
    hits = _bg_mask(want.numpy()).reshape(-1, cfg.ray_chunk).any(-1)
    assert hits.any() and not hits.all()
    target = torch.zeros_like(want)
    want_loss = inverse.loss_fn(inverse.init_params(scene), scene, cam,
                                target, cfg)
    loops = []
    counted = _count_on_the_host(graphs.while_loop)
    monkeypatch.setattr(graphs, "while_loop",
                        lambda *a: loops.append(a[0]) or counted(*a))
    params = inverse.init_params(scene)
    with _NoHostReads():
        got = T.render_frame(scene, cam, cfg)
        loss = inverse.loss_fn(params, scene, cam, target, cfg)
        loss.backward()
    assert torch.equal(got, want) and torch.equal(loss, want_loss)
    bvh, rays, _ = tp.frame_inputs(scene, cam, cfg)
    rays = tp.tile_frame_rays(rays, cfg, cfg.width, cfg.height)
    _, any_hit = tp.trace_chunks(tp.shade_setup(scene, bvh, cfg)[0], rays,
                                 cfg)
    assert [int(c) for c in loops] == [int(any_hit.sum())] * 3
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in params)


@pytest.mark.parametrize("stage", [
    "morton", "sort", "topology", "fit", "links", "build_total",
    "trace_shade", "depth_image"])
def test_graphed_bodies_read_nothing_back(monkeypatch, stage):
    """What utils.profiling.stage_times captures a stage at a time on the
    card, and what ref.refimage.render_depth_bmp captures (the build, the
    rays, the walk), make no host read and no tensor literal outside the
    plain walks, so a CUDA graph can hold each.  The stages' inputs and the
    depth image's camera are made before, outside the guard."""
    from raytracebvh_tpu_torch.ref import refimage
    from raytracebvh_tpu_torch.utils import profiling

    monkeypatch.setattr(t_traverse, "traverse",
                        _unguarded(t_traverse.traverse))
    scene = t_random(300, device="cpu", seed=6, with_texture=True)
    cam = T.Camera.default("cpu")
    cfg = T.RenderConfig(width=48, height=32, bounces=1, ortho_scale=2.0,
                         ray_tile=16, sort_backend="bitonic")
    if stage == "depth_image":
        fn = refimage._depth_walk(scene, 48, 32, 2)
        call = lambda: fn(scene)  # noqa: E731
    else:
        stages, _ = profiling._eager_stages(scene, cam, cfg)
        call = stages[stage]
    want = graphs.tensors(call())
    with _NoHostReads():
        got = graphs.tensors(call())
    assert len(got) == len(want) and all(
        torch.equal(a, b) for a, b in zip(got, want))


def test_guard_catches_host_reads():
    with pytest.raises(AssertionError, match="_local_scalar_dense"):
        with _NoHostReads():
            bool(torch.ones(3).any())
    with pytest.raises(AssertionError, match="lift_fresh"):
        with _NoHostReads():
            torch.tensor([1.0, 2.0])


def test_render_frame_jit_refuses_gradients():
    scene = t_random(50, device="cpu", seed=2, with_texture=True)
    scene = scene.replace(verts=scene.verts.clone().requires_grad_(True))
    cfg = T.RenderConfig(width=8, height=8, bounces=0)
    with pytest.raises(ValueError, match="does not differentiate"):
        T.render_frame_jit(scene, T.Camera.default("cpu"), cfg)
    with torch.no_grad():
        img = T.render_frame_jit(scene, T.Camera.default("cpu"), cfg)
    assert img.shape == (8, 8, 4) and not img.requires_grad


def _train_setup():
    # tests/test_torch_inverse.py's GRAD_SCENE: 35% of the pixels hit
    scene = t_random(40, device="cpu", seed=11, extent=8.0, tri_size=2.0,
                     with_texture=True)
    cfg = T.RenderConfig(width=16, height=16, bounces=1, ortho_scale=1.0)
    cam = T.Camera.default("cpu")
    target = T.render_frame(scene, cam, cfg) * 0.8
    return scene, cam, target, cfg


@pytest.mark.parametrize("culled", [False, True])
def test_train_step_jit_on_cpu_is_train_step(culled):
    """train_step_jit on CPU tensors is train_step, also where the frame
    culls ray chunks (some of its 8-ray chunks, half rows, miss)."""
    scene, cam, target, cfg = _train_setup()
    if culled:
        cfg = cfg.replace(ray_chunk=8)
        assert tp.culls_chunks(cfg, 256)
        hits = _bg_mask(T.render_frame(scene, cam, cfg).numpy())
        chunk_hits = hits.reshape(-1, 8).any(-1)
        assert chunk_hits.any() and not chunk_hits.all()
    runs = []
    for step in (inverse.train_step, inverse.train_step_jit):
        params = inverse.init_params(scene)
        opt = inverse.make_optimizer(params, 0.05)
        kw = {} if step is inverse.train_step else dict(lr=0.05)
        losses = [step(params, opt, scene, cam, target, cfg, **kw)
                  for _ in range(3)]
        runs.append((losses, [p.detach() for p in params],
                     inverse.adam_state(opt, params)))
    (l0, p0, s0), (l1, p1, s1) = runs
    assert l0[0] > l0[-1] > 0  # it trains
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert s0[0].count == s1[0].count == 3
    assert all(torch.equal(a, b) for a, b in zip(s0[0].mu, s1[0].mu))


def test_train_step_jit_takes_lr_at_each_call():
    """lr is an argument of the step, as in the jitted JAX train_step."""
    scene, cam, target, cfg = _train_setup()
    moves = []
    for lr in (0.0, 0.1):
        params = inverse.init_params(scene)
        opt = inverse.make_optimizer(params, 0.05)
        start = [p.detach().clone() for p in params]
        inverse.train_step_jit(params, opt, scene, cam, target, cfg, lr=lr)
        moves.append(max(float((p.detach() - s).abs().max())
                         for p, s in zip(params, start)))
    assert moves[0] == 0.0 and moves[1] > 0.0


def test_capturable_optimizer_state_round_trips():
    """A capturable Adam (what train_step_jit steps on the card) holds its
    learning rate and step count as tensors on the parameters' device;
    its state goes through optax's layout and back unchanged."""
    scene, cam, target, cfg = _train_setup()
    params = inverse.init_params(scene)
    opt = inverse.make_optimizer(params, 0.05)
    for _ in range(2):
        inverse.train_step(params, opt, scene, cam, target, cfg)
    state = inverse.adam_state(opt, params)
    cap = inverse.optimizer_from_numpy(params, state, 0.05, device="cpu",
                                       capturable=True)
    group = cap.param_groups[0]
    assert group["capturable"] and isinstance(group["lr"], torch.Tensor)
    assert float(group["lr"]) == np.float32(0.05)
    for p in params:
        st = cap.state[p]
        assert st["step"].dtype == torch.float32
        assert st["step"].device == p.device and float(st["step"]) == 2.0
    back = inverse.adam_state(cap, params)
    assert back[0].count == state[0].count == 2
    for a, b in zip(back[0].mu + back[0].nu, state[0].mu + state[0].nu):
        assert torch.equal(a, b)
    fresh = inverse.make_optimizer(params, 0.05, capturable=True)
    count = inverse.adam_state(fresh, params)[0].count
    assert count == 0 and count.dtype == np.int32


def test_step_graphs_let_their_optimizer_die():
    """train_step_jit's captures are held by their optimizer
    (``inverse.step_graphs``): an entry that closes over the optimizer, as
    a captured step does, does not keep it alive once the caller drops
    it; each optimizer has a cache of its own."""
    import gc
    import weakref

    params = inverse.init_params(t_random(20, device="cpu", seed=1))
    opt = inverse.make_optimizer(params, 0.05, capturable=True)
    cache = inverse.step_graphs(opt)

    def step_of(optimizer):
        return lambda: optimizer.param_groups

    entry = cache.get("step", lambda: step_of(opt))
    assert inverse.step_graphs(opt) is cache and entry() is opt.param_groups
    other = inverse.make_optimizer(params, 0.05, capturable=True)
    assert inverse.step_graphs(other) is not cache
    gone, held = weakref.ref(opt), weakref.ref(entry)
    del opt, cache, entry
    gc.collect()
    assert gone() is None and held() is None


def test_graph_signature_keys_like_jit():
    scene = t_random(20, device="cpu", seed=1)
    cam = T.Camera.default("cpu")
    cfg = T.RenderConfig(width=8, height=8)
    key = graphs.signature(cfg, scene, cam)
    assert key == graphs.signature(cfg, scene.to("cpu"),
                                   T.Camera.default("cpu"))
    assert hash(key) == hash(graphs.signature(cfg, scene, cam))
    assert key != graphs.signature(cfg.replace(width=16), scene, cam)
    assert key != graphs.signature(cfg, t_random(21, device="cpu", seed=1),
                                   cam)
    assert key != graphs.signature(
        cfg, scene, T.Camera.default("cpu", dtype=torch.float64))
    assert key != graphs.signature(cfg, scene, None)


def test_static_copy_and_copy_into():
    scene = t_random(20, device="cpu", seed=1, with_texture=True)
    with torch.inference_mode():
        static = graphs.static_copy((scene, T.Camera.default("cpu")))
    leaves = graphs.tensors(static)
    assert len(leaves) == 14 + 6 and not any(t.is_inference() for t in leaves)
    other = t_random(20, device="cpu", seed=2, with_texture=True)
    cam = T.Camera.default("cpu").replace(eye=torch.tensor([1.0, 2.0, 3.0]))
    graphs.copy_into(static, (other, cam))
    assert all(torch.equal(a, b) for a, b in
               zip(graphs.tensors(static), graphs.tensors((other, cam))))
    assert all(a.data_ptr() != b.data_ptr() for a, b in
               zip(graphs.tensors(static), graphs.tensors((other, cam))))


def test_graph_cache_drops_the_least_recently_used():
    cache = graphs.Cache()
    cache.max_entries = 2
    made = []
    get = lambda k: cache.get(k, lambda: made.append(k) or k)  # noqa: E731
    assert [get(k) for k in "abab"] == list("abab") and made == ["a", "b"]
    get("c")  # drops a, the least recently used
    assert list(cache.entries) == ["b", "c"]
    get("a")
    assert made == ["a", "b", "c", "a"] and list(cache.entries) == ["c", "a"]
    cache.clear()
    assert not cache.entries


def test_check_no_grad():
    t = torch.ones(2, requires_grad=True)
    with pytest.raises(ValueError, match="f does not differentiate"):
        graphs.check_no_grad((t,), "f")
    with torch.no_grad():
        graphs.check_no_grad((t,), "f")
    graphs.check_no_grad((t.detach(),), "f")
