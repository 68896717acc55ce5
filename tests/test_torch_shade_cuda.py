"""The frames' shading kernels (``ops/shade_cuda.py``, ``csrc/shade.cu``).

On the CPU: the rule that routes a shading pass to the kernels, as a pure
function of the config and the pass's input tensors (the kernels' C entry
points are held to ``_kernels._SIGNATURES`` in ``test_torch_kernels.py``).

Marked ``gpu`` (they skip without a CUDA device; a CUDA kernel has no CPU
mode): the kernel route against the plain route on the same inputs, bit
for bit on every returned tensor (NaN where NaN, every other value's
bits), for the launch, bounce and refraction passes, shadowed and not,
K2 and K7 leaf blocks, float32 and UNORM8 quad tables of one texture and
of several, with miss lanes, dead bounce lanes, random leaves that fail
Moeller-Trumbore, zero rows and degenerate triangles (det and area 0);
whole frames of the benchmark's traffic at a test size, eager and
graphed, the culled chunked frame, and the chunked step's loss and
gradients (its forward on the kernels, its recomputed backward plain).
Each case checks ``shade_cuda.launches``.  On a GPU machine, which need
not have JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_shade_cuda.py
"""

import contextlib
import dataclasses
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from raytracebvh_tpu_torch import pipeline
from raytracebvh_tpu_torch.config import RenderConfig
from raytracebvh_tpu_torch.ops import shade_cuda


def _fake(device="cuda", dtype=torch.float32, requires_grad=False):
    """What ``engages`` reads of a tensor, on any device type (the CPU
    build can name a CUDA device but not make a tensor there)."""
    return SimpleNamespace(device=torch.device(device), dtype=dtype,
                           requires_grad=requires_grad)


def _pass_inputs(**kw):
    """A shading pass's inputs as ``engages`` sees them: the leaf table,
    a UNORM8 quad table, six ray components, a shadow factor, None."""
    return [_fake(**kw), _fake(dtype=torch.uint8)] + [
        _fake() for _ in range(7)] + [None]


@pytest.mark.parametrize("gather", ["auto", "cuda", "shared"])
def test_kernel_route_on_the_card_without_gradients(gather):
    cfg = RenderConfig(shade_gather_backend=gather)
    assert shade_cuda.engages(cfg, _pass_inputs())
    with torch.no_grad():
        assert shade_cuda.engages(cfg, _pass_inputs(requires_grad=True))


@pytest.mark.parametrize("case", [
    "cpu", "torch_gather", "bfloat16", "grad", "float64_table"])
def test_plain_route(case):
    """The plain shading runs on CPU tensors, on the plain leaf gather, in
    bfloat16, where an input requires grad under grad mode, and on a
    table the kernels do not read."""
    cfg = RenderConfig()
    inputs = _pass_inputs()
    if case == "cpu":
        inputs = _pass_inputs(device="cpu")
    elif case == "torch_gather":
        cfg = cfg.replace(shade_gather_backend="torch")
    elif case == "bfloat16":
        cfg = cfg.replace(dtype="bfloat16")
    elif case == "grad":
        inputs = _pass_inputs(requires_grad=True)
    else:
        inputs = _pass_inputs(dtype=torch.float64)
    with torch.enable_grad():
        assert not shade_cuda.engages(cfg, inputs)


def test_cpu_frame_takes_the_plain_shading():
    """A CPU frame on the kernel routes' config shades in plain PyTorch:
    no kernel launch is counted."""
    from raytracebvh_tpu_torch import Camera, render_frame
    from raytracebvh_tpu_torch.models.procedural import random_triangles

    scene = random_triangles(60, seed=2, with_texture=True, device="cpu")
    cfg = RenderConfig(width=16, height=16, bounces=1, ortho_scale=1.4,
                       enable_shadows=True, enable_refraction=True)
    before = shade_cuda.launches
    img = render_frame(scene, Camera.default("cpu"), cfg)
    assert shade_cuda.launches == before
    assert bool(torch.isfinite(img).all())


# ---------------------------------------------------------------- the card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _plain():
    """Within it, every shading pass takes the plain PyTorch path."""
    return mock.patch.object(shade_cuda, "engages", return_value=False)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for y in x for t in _tensors(y)]


def _assert_same_bits(got, want):
    got, want = _tensors(got), _tensors(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        gn, wn = torch.isnan(g), torch.isnan(w)
        assert torch.equal(gn, wn)
        assert torch.equal(g[~gn].view(torch.int32), w[~wn].view(torch.int32))


def _scene(dev, textures: str):
    """300 random triangles on eight materials (shininess, alpha and
    optical density apart: some rays reflect totally inside), uvs over
    [-2, 3] (the sample wraps), and three degenerate faces (a point, a
    line: det and area 0).  ``textures``: 'one' (the checker on every
    material) or 'several' (three sizes in one padded stack, two
    materials untextured)."""
    from raytracebvh_tpu_torch.core.types import stack_textures
    from raytracebvh_tpu_torch.models.procedural import random_triangles

    scene = random_triangles(300, seed=3, num_materials=8, with_texture=True,
                             device=dev)
    verts = scene.verts.clone()
    verts[0:3] = verts[0]
    verts[3:6] = verts[3]
    verts[5] = verts[3] + 1.0
    verts[9:12] = verts[9] + torch.arange(3, device=dev)[:, None] * 0.5
    f32 = dict(dtype=torch.float32, device=dev)
    mats = dataclasses.replace(
        scene.materials,
        shininess=torch.tensor([500.0, 37.0, 1000.0, 3.0, 123.4, 77.7, 999.0,
                                0.5], **f32),
        alpha=torch.tensor([1.0, 0.4, 0.75, 0.1, 0.3, 0.9, 0.55, 0.2], **f32),
        optical_density=torch.tensor([0.0, 0.7, 1.5, 2.4, 1.1, 0.9, 1.33,
                                      3.0], **f32))
    scene = dataclasses.replace(scene, verts=verts, uv=scene.uv * 5.0 - 2.0,
                                materials=mats)
    if textures == "several":
        rng = np.random.default_rng(4)
        stack, hw = stack_textures([
            (rng.integers(0, 256, s + (4,)) / 255.0).astype(np.float32)
            for s in ((64, 64), (16, 40), (8, 8))])
        scene = dataclasses.replace(
            scene, textures=torch.from_numpy(stack).to(dev),
            tex_hw=torch.from_numpy(hw).to(dev),
            materials=dataclasses.replace(mats, tex_id=torch.tensor(
                [-1, 0, 1, 2, 0, 1, 2, -1], dtype=torch.int32, device=dev)))
    return scene


def _pass_setup(dev, gather, table, textures, seed=0):
    """(scene, bvh, tex_quads, cfg, o3, d3, rec, light3) at 64x64: the
    primary rays' record, with a third of its lanes replaced by random
    leaves and flags, a few zero rows (leaf -1 and past the table), and
    two lanes on a triangle of leaf row 1 set to det = 1e-12 (kept) and
    det = 0.  Material 7's ambient alpha is NaN (torch.clamp keeps it).
    The config shadows the launch (``light3``), takes ``gather`` for the
    leaf block and a ``table`` quad table, and decays both spawns."""
    from raytracebvh_tpu_torch import Camera
    from raytracebvh_tpu_torch.core.types import HitRecord, Rays

    scene = _scene(dev, textures)
    ambient = scene.materials.ambient.clone()
    ambient[7, 3] = float("nan")
    scene = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, ambient=ambient))
    cfg = RenderConfig(width=64, height=64, bounces=1, ortho_scale=1.2,
                       shade_gather_backend=gather, texture_dtype=table,
                       enable_shadows=True, light_pos=(10.0, 80.0, -40.0),
                       reflection_decay=0.8, refraction_decay=0.9)
    bvh, rays, light3 = pipeline.frame_inputs(scene, Camera.default(dev), cfg)
    bvh, tex_quads = pipeline.shade_setup(scene, bvh, cfg)
    rec = pipeline._traverse_ids(bvh, rays, cfg)
    g = torch.Generator(device="cpu").manual_seed(seed)
    n = rays.origin.shape[0]
    mixed = torch.rand(n, generator=g) < 0.33
    leaf = torch.randint(0, bvh.n_leaves, (n,), generator=g, dtype=torch.int32)
    leaf[:4], leaf[4:8], leaf[8:10] = -1, bvh.n_leaves + 3, 1
    mixed[:10] = True
    hit = torch.rand(n, generator=g) < 0.7
    hit[8:10] = True
    mixed, leaf, hit = mixed.to(dev), leaf.to(dev), hit.to(dev)
    rec = HitRecord(hit=torch.where(mixed, hit, rec.hit),
                    distance=rec.distance,
                    leaf=torch.where(mixed, leaf, rec.leaf))
    # leaf row 1: corners (0, 0, 0), (-1e-12, 0, 0), (0, 1, 0); a ray along
    # +z meets it at det = 1e-12 (u, v ~0.25, t ~1), one along +x at det 0
    attrs = bvh.leaf_attrs.clone()
    attrs[1, 0:9] = torch.tensor([0.0, 0.0, 0.0, -1e-12, 0.0, 0.0,
                                  0.0, 1.0, 0.0], **dict(device=dev))
    bvh = bvh.replace(leaf_attrs=attrs)
    origin, direction = rays.origin.clone(), rays.direction.clone()
    origin[8:10] = torch.tensor([-0.25e-12, 0.25, -1.0], device=dev)
    direction[8] = torch.tensor([0.0, 0.0, 1.0], device=dev)
    direction[9] = torch.tensor([1.0, 0.0, 0.0], device=dev)
    o3, d3 = pipeline._split_rays(Rays(origin, direction))
    return scene, bvh, tex_quads, cfg, o3, d3, rec, light3


CASES = [(g, t, x) for g in ("cuda", "shared")
         for t, x in (("float32", "one"), ("uint8", "one"),
                      ("float32", "several"), ("uint8", "several"))]
CASE_IDS = [f"{'K2' if g == 'cuda' else 'K7'}-{t}-{x}" for g, t, x in CASES]


@pytest.mark.gpu
@pytest.mark.parametrize("shadowed", [False, True], ids=["plain", "vis"])
@pytest.mark.parametrize("gather,table,textures", CASES, ids=CASE_IDS)
def test_launch_pass_equals_plain(dev, gather, table, textures, shadowed):
    scene, bvh, tq, cfg, o3, d3, rec, light3 = _pass_setup(
        dev, gather, table, textures)
    light3 = light3 if shadowed else None
    with torch.no_grad():
        before = shade_cuda.launches
        got = pipeline._launch_soa(scene, bvh, o3, d3, cfg, tq, light3, rec)
        assert shade_cuda.launches - before == 2
        with _plain():
            want = pipeline._launch_soa(scene, bvh, o3, d3, cfg, tq, light3,
                                        rec)
    assert shade_cuda.launches - before == 2
    _assert_same_bits(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bounce", "refract"])
@pytest.mark.parametrize("gather,table,textures", CASES, ids=CASE_IDS)
def test_bounce_passes_equal_plain(dev, gather, table, textures, kind):
    """A reflection or transmission pass from the primary pass's spawns,
    a random carried colour, and intensities of which a quarter are 0
    and a quarter exactly ``intensity_min`` (dead lanes)."""
    scene, bvh, tq, cfg, o3, d3, rec, _ = _pass_setup(
        dev, gather, table, textures, seed=1)
    cfg = cfg.replace(intensity_min=0.125)
    g = torch.Generator(device="cpu").manual_seed(2)
    with torch.no_grad(), _plain():
        _, refl, _, refr, _ = pipeline._launch_soa(scene, bvh, o3, d3, cfg,
                                                   tq, None, rec)
    n = o3[0].shape[0]
    color = tuple(torch.rand(n, generator=g).to(dev) for _ in range(4))
    inten = torch.rand(n, generator=g)
    inten[0::4], inten[1::4] = 0.0, 0.125
    inten = inten.to(dev)
    fn, (ro, rd) = ((pipeline._bounce_soa, refl) if kind == "bounce"
                    else (pipeline._bounce_refract_soa, refr))
    with torch.no_grad():
        before = shade_cuda.launches
        got = fn(scene, bvh, color, ro, rd, inten, cfg, tq)
        assert shade_cuda.launches - before == 2
        with _plain():
            want = fn(scene, bvh, color, ro, rd, inten, cfg, tq)
    _assert_same_bits(got, want)


# the benchmark's traffic (rtbench/traffic/*.json) at 128x96, and the
# refraction chain
FRAMES = {
    "frame": dict(bounces=1, ray_tile=16, texture_dtype="uint8",
                  traversal_backend="cuda"),
    "frame_shadows": dict(bounces=0, enable_shadows=True, ray_tile=16),
    "spd_frame_shadows": dict(bounces=0, enable_shadows=True, ray_tile=16,
                              traversal_backend="cuda"),
    "frame_onchip": dict(bounces=1, enable_shadows=True, ray_tile=16,
                         texture_dtype="uint8", traversal_backend="shared",
                         shade_gather_backend="shared",
                         sort_backend="bitonic"),
    "refract": dict(bounces=2, enable_refraction=True, ray_tile=16),
    "culled_chunks": dict(bounces=1, ray_chunk=768, enable_shadows=True),
}


def _frame_args(dev, **kw):
    from raytracebvh_tpu_torch import Camera

    cfg = RenderConfig(**dict(dict(width=128, height=96, ortho_scale=1.2,
                                   light_pos=(10.0, 80.0, -40.0)), **kw))
    return _scene(dev, "several"), Camera.default(dev), cfg


def _passes(cfg) -> int:
    return 1 + cfg.bounces * (2 if cfg.enable_refraction else 1)


@pytest.mark.gpu
@pytest.mark.parametrize("traffic", list(FRAMES))
def test_frames_equal_plain_eager_and_graphed(dev, traffic):
    """render_frame and render_frame_jit on the kernels give the plain
    shading's frame, bit for bit; the eager frame launches two kernels a
    pass (a culled frame: a pass a shaded chunk), the capture two a pass
    of its warm-up and two of its captured body."""
    import raytracebvh_tpu_torch as T

    scene, cam, cfg = _frame_args(dev, **FRAMES[traffic])
    with torch.no_grad():
        with _plain():
            want = T.render_frame(scene, cam, cfg)
        before = shade_cuda.launches
        got = T.render_frame(scene, cam, cfg)
        eager = shade_cuda.launches - before
        pipeline.FRAME_GRAPHS.clear()
        graphed = T.render_frame_jit(scene, cam, cfg)
        pipeline.FRAME_GRAPHS.clear()
    passes = _passes(cfg)
    if pipeline.culls_chunks(cfg, cfg.width * cfg.height):
        bvh, rays, _ = pipeline.frame_inputs(scene, cam, cfg)
        bvh = pipeline.shade_setup(scene, bvh, cfg)[0]
        passes *= int(pipeline.trace_chunks(bvh, rays, cfg)[1].sum())
        assert passes > 0
    assert eager == 2 * passes
    assert shade_cuda.launches - before > eager
    _assert_same_bits(got, want)
    _assert_same_bits(graphed, want)


@pytest.mark.gpu
def test_chunked_step_forward_on_kernels_backward_plain(dev):
    """The chunked step (the chunk loop under autograd): its forward runs
    with grad mode off and takes the kernels, its backward recomputes
    each chunk on the plain path; the loss and every gradient equal the
    all-plain step's bit for bit."""
    from raytracebvh_tpu_torch.models.inverse import init_params, loss_fn

    scene, cam, cfg = _frame_args(dev, bounces=1, ray_chunk=768,
                                  cull_empty_chunks=False, ray_tile=16,
                                  texture_dtype="uint8")
    target = torch.zeros((cfg.height, cfg.width, 4), device=dev)
    out = []
    for plain in (False, True):
        params = init_params(scene)
        before = shade_cuda.launches
        with _plain() if plain else contextlib.nullcontext():
            loss = loss_fn(params, scene, cam, target, cfg)
            forward = shade_cuda.launches - before
            loss.backward()
        out.append((loss.detach(), [p.grad for p in params], forward,
                    shade_cuda.launches - before))
    (loss, grads, fwd, total), (loss_p, grads_p, fwd_p, total_p) = out
    nchunks = cfg.width * cfg.height // cfg.ray_chunk
    assert fwd == total == 2 * _passes(cfg) * nchunks
    assert fwd_p == total_p == 0
    _assert_same_bits(loss, loss_p)
    _assert_same_bits(grads, grads_p)


@pytest.mark.gpu
def test_step_keeps_the_plain_shading(dev):
    """The training step (the train traffic's config) differentiates its
    shading: neither the eager step nor train_step_jit's capture
    launches the kernels."""
    from raytracebvh_tpu_torch.models import inverse

    scene, cam, cfg = _frame_args(dev, **FRAMES["frame"])
    target = torch.zeros((cfg.height, cfg.width, 4), device=dev)
    params, params_jit = inverse.init_params(scene), inverse.init_params(scene)
    before = shade_cuda.launches
    inverse.train_step(params, inverse.make_optimizer(params), scene, cam,
                       target, cfg)
    inverse.train_step_jit(params_jit, inverse.make_optimizer(
        params_jit, capturable=True), scene, cam, target, cfg)
    torch.cuda.synchronize()
    assert shade_cuda.launches == before
