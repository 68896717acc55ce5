"""The port's render_frame against the JAX package's, end to end.

48x32 frames, one reflection bounce, on a 300-triangle textured scene.
Tolerance: image atol 1e-5.  The two pipelines run the same operations
in the same order, but the JAX frame is one jitted program, in which XLA
may contract a*b + c into FMAs; the port rounds every product, so a few
pixels differ in the last bits."""

import numpy as np
import pytest
import torch

import raytracebvh_tpu as J
from raytracebvh_tpu.core.types import scene_to_device
from raytracebvh_tpu.models.procedural import random_triangles as j_random
from raytracebvh_tpu.pipeline import render_frame as j_render_frame
import raytracebvh_tpu_torch as T
from raytracebvh_tpu_torch.models.procedural import random_triangles as t_random
from raytracebvh_tpu_torch.ops import (gather_cuda, traverse_cuda,
                                       traverse_shared_cuda)

W, H = 48, 32
BASE = dict(width=W, height=H, bounces=1, ortho_scale=2.0)


def _scenes(seed=6):
    kw = dict(seed=seed, with_texture=True)
    return (scene_to_device(j_random(300, **kw)),
            t_random(300, device="cpu", **kw))


def _render_both(**kw):
    js, ts = _scenes()
    want = np.asarray(J.render_frame_jit(js, J.Camera.default(),
                                         J.RenderConfig(**BASE, **kw)))
    got = T.render_frame(ts, T.Camera.default("cpu"), T.RenderConfig(**BASE, **kw))
    return got, want


def _hit_mask(img):
    bg = np.asarray(J.RenderConfig().background, np.float32)
    return ~(np.abs(img - bg) < 1e-6).all(-1)


def test_tiled_u8_frame_matches_jax():
    """16-px ray tiles (8 x 16 on this frame) and UNORM8 texture quads:
    the bench's dense configuration."""
    got, want = _render_both(ray_tile=16, texture_dtype="uint8")
    assert got.shape == (H, W, 4) and got.dtype == torch.float32
    hits = _hit_mask(want)
    assert 0.1 < hits.mean() < 0.9
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_chunked_culled_frame_matches_jax():
    """ray_chunk with cull_empty_chunks: all-miss chunks are skipped and
    come back as background; some chunks of this frame are culled."""
    got, want = _render_both(ray_chunk=96)
    chunk_hits = _hit_mask(want).reshape(-1, 96).any(-1)
    assert chunk_hits.any() and not chunk_hits.all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_backends_agree_on_cpu_without_launching():
    """'cuda' backends on CPU tensors run the kernels' plain versions:
    the same image, and no launch counted."""
    _, ts = _scenes()
    cfg = T.RenderConfig(**BASE, ray_tile=16, texture_dtype="uint8")
    k1, k2 = traverse_cuda.launches, gather_cuda.launches
    a = T.render_frame(ts, T.Camera.default("cpu"), cfg.replace(
        traversal_backend="cuda", shade_gather_backend="cuda",
        texture_gather_backend="cuda"))
    b = T.render_frame(ts, T.Camera.default("cpu"), cfg.replace(
        traversal_backend="torch", shade_gather_backend="torch",
        texture_gather_backend="torch"))
    assert torch.equal(a, b)
    assert (traverse_cuda.launches, gather_cuda.launches) == (k1, k2)


@pytest.mark.parametrize("num,w,h,chunk,ortho", [
    (60, 16, 12, 7, 1.0),    # 7 does not divide the 192 rays
    (300, 48, 32, 48, 2.0),  # 48 divides the 1 536 rays
], ids=["chunk7_16x12", "chunk48_48x32"])
@pytest.mark.parametrize("route,jax_route", [("cuda", "hbm"),
                                             ("shared", "pallas")])
def test_kernel_routes_ignore_traversal_chunk_as_jax(num, w, h, chunk, ortho,
                                                     route, jax_route):
    """traversal_chunk chunks the plain lock-step walk alone: the JAX
    package's Pallas walks ('hbm', 'pallas'; interpret mode) take every
    ray in one call whatever the chunk, and so do the port's kernel
    routes ('cuda', 'shared'), so a chunk that does not divide the ray
    count renders.  Against the eager JAX frame at atol 1e-5, the rule of
    tests/test_torch_graphs.py (the jitted frame's FMAs move textured
    pixels by up to 1e-4); the port's frame is also its unchunked frame
    bit for bit."""
    kw = dict(seed=1, with_texture=True)
    js = scene_to_device(j_random(num, **kw))
    ts = t_random(num, device="cpu", **kw)
    base = dict(width=w, height=h, bounces=1, ortho_scale=ortho)
    want = np.asarray(j_render_frame(js, J.Camera.default(), J.RenderConfig(
        **base, traversal_chunk=chunk, traversal_backend=jax_route)))
    cfg = T.RenderConfig(**base, traversal_backend=route)
    got = T.render_frame(ts, T.Camera.default("cpu"),
                         cfg.replace(traversal_chunk=chunk))
    assert got.shape == (h, w, 4) and want.shape == (h, w, 4)
    assert 0.05 < _hit_mask(want).mean() < 0.95
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert torch.equal(got, T.render_frame(ts, T.Camera.default("cpu"), cfg))


def test_plain_route_chunk_must_divide_as_jax():
    """The plain walk ('torch', JAX's 'jnp') runs in traversal_chunk
    chunks, which must divide the ray count: both packages refuse 7 at
    16x12."""
    js, ts = _scenes()
    kw = dict(width=16, height=12, bounces=0, traversal_chunk=7)
    with pytest.raises(AssertionError, match="must divide"):
        J.render_frame_jit(js, J.Camera.default(),
                           J.RenderConfig(**kw, traversal_backend="jnp"))
    with pytest.raises(ValueError, match="must divide ray count 192"):
        T.render_frame(ts, T.Camera.default("cpu"),
                       T.RenderConfig(**kw, traversal_backend="torch"))


def _counted(monkeypatch, module, name, calls):
    """Count the calls of ``module.name`` into ``calls[name]``."""
    fn = getattr(module, name)

    def wrapper(*args, **kw):
        calls[name] = calls.get(name, 0) + 1
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, wrapper)


@pytest.mark.parametrize("route", ["cuda", "shared"])
def test_kernel_route_walks_a_pass_in_one_call(monkeypatch, route):
    """On a kernel route every pass is one call of the route's walk:
    _traverse_ids whatever traversal_chunk, trace_chunks over every ray
    chunk, and each pass of a frame (primary, bounce, shadow).  The
    records equal the plain walk's, a walk a chunk, bit for bit."""
    from raytracebvh_tpu_torch import pipeline as tp
    from raytracebvh_tpu_torch.config import traversal_passes

    module = traverse_shared_cuda if route == "shared" else traverse_cuda
    _, ts = _scenes()
    cfg = T.RenderConfig(**BASE, traversal_chunk=48, ray_chunk=96,
                         enable_shadows=True, traversal_backend=route)
    plain = cfg.replace(traversal_backend="torch")
    bvh, rays, _ = tp.frame_inputs(ts, T.Camera.default("cpu"), cfg)
    bvh = tp.shade_setup(ts, bvh, cfg)[0]
    want = tp._traverse_ids(bvh, rays, plain)
    want_recs, want_any = tp.trace_chunks(bvh, rays, plain)
    calls = {}
    _counted(monkeypatch, module, "traverse", calls)
    _counted(monkeypatch, module, "traverse_any", calls)
    got = tp._traverse_ids(bvh, rays, cfg)
    assert calls == {"traverse": 1}
    recs, any_hit = tp.trace_chunks(bvh, rays, cfg)
    assert calls == {"traverse": 2}
    for f in ("hit", "distance", "leaf"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert getattr(recs, f).shape == (W * H // 96, 96)
        assert torch.equal(getattr(recs, f), getattr(want_recs, f)), f
    assert torch.equal(any_hit, want_any)
    assert bool(want_any.any()) and bool(want.hit.any())
    calls.clear()
    frame = cfg.replace(ray_chunk=0)
    img = T.render_frame(ts, T.Camera.default("cpu"), frame)
    assert calls == {"traverse": traversal_passes(frame) - 1,
                     "traverse_any": 1}
    monkeypatch.undo()
    assert torch.equal(img, T.render_frame(ts, T.Camera.default("cpu"),
                                           frame.replace(
                                               traversal_backend="torch")))


@pytest.mark.parametrize("scene_kw,cfg_kw", [
    # tests/test_ray_chunk.py::test_cull_bfloat16_branch_dtypes, with and
    # without its ray_chunk
    (dict(num_tris=40, seed=12), dict(width=16, height=16, ortho_scale=0.1)),
    (dict(num_tris=40, seed=12), dict(width=16, height=16, ortho_scale=0.1,
                                      ray_chunk=64)),
    # culled chunks (tests/test_ray_chunk.py::test_cull_empty_chunks_
    # identical's frame): their background takes the shaded chunks' dtype
    (dict(num_tris=60, seed=11), dict(width=32, height=32, ortho_scale=0.05,
                                      ray_chunk=128)),
])
def test_bfloat16_frame_is_float32_as_jax(scene_kw, cfg_kw):
    """A bfloat16 pipeline with the float32 texture table returns a
    float32 image, as the JAX package's promotion makes it; values within
    atol 1e-5 of render_frame_jit, as the float32 frames."""
    n = scene_kw.pop("num_tris")
    js = scene_to_device(j_random(n, with_texture=True, **scene_kw))
    ts = t_random(n, device="cpu", with_texture=True, **scene_kw)
    kw = dict(bounces=1, dtype="bfloat16", **cfg_kw)
    want = np.asarray(J.render_frame_jit(js, J.Camera.default(),
                                         J.RenderConfig(**kw)))
    got = T.render_frame(ts, T.Camera.default("cpu"), T.RenderConfig(**kw))
    assert want.dtype == np.float32 and got.dtype == torch.float32
    hits = _hit_mask(want)
    assert hits.any()
    if cfg_kw.get("ray_chunk") == 128:
        chunk_hits = hits.reshape(-1, 128).any(-1)
        assert chunk_hits.any() and not chunk_hits.all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("field", ["traversal_backend", "shade_gather_backend",
                                   "texture_gather_backend"])
@pytest.mark.parametrize("value", ["jnp", "pallas", "hbm", "sweep",
                                   "windowed", "xla", "Cuda"])
def test_tpu_backend_strings_raise(field, value):
    _, ts = _scenes()
    cfg = T.RenderConfig(width=8, height=8, bounces=0).replace(**{field: value})
    with pytest.raises(ValueError, match=field):
        T.render_frame(ts, T.Camera.default("cpu"), cfg)


@pytest.mark.parametrize("kw,exc", [
    # shadows and refraction are ported (tests/test_torch_shadows.py,
    # tests/test_torch_refraction.py); values no package takes still raise
    (dict(camera_mode="orthographic"), ValueError),
    (dict(texture_dtype="bfloat16"), ValueError),
    # the radix and bitonic sorts are ported: they build lax's tree
    (dict(sort_backend="radix"), None),
    (dict(sort_backend="bitonic"), None),
    (dict(ray_tile=16, ray_tile_order="diagonal"), ValueError),
    (dict(sort_backend="merge"), ValueError),
])
def test_unported_options_raise(kw, exc):
    _, ts = _scenes()
    cfg = T.RenderConfig(width=16, height=16, bounces=0, **kw)
    if exc is not None:
        with pytest.raises(exc):
            T.render_frame(ts, T.Camera.default("cpu"), cfg)
        return
    from raytracebvh_tpu_torch.camera import camera_matrices

    wvp, wv = camera_matrices(T.Camera.default("cpu"), 16, 16)
    got = T.build_bvh(ts, wvp, wv, cfg)
    want = T.build_bvh(ts, wvp, wv, cfg.replace(sort_backend="lax"))
    for f in ("codes", "prim", "child_l", "child_r", "entry_link",
              "skip_link", "bbmin", "bbmax", "leaf_attrs"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("kw,passes", [
    # bench.py counts W*H*(1 + bounces) rays a frame (:79) and W*H*2 for
    # a shadowed frame with no bounce (:126, :305)
    (dict(bounces=1), 2),
    (dict(bounces=0, enable_shadows=True), 2),
    (dict(bounces=1, enable_refraction=True), 3),
    (dict(bounces=3, enable_shadows=True, enable_refraction=True), 8),
])
def test_traversal_passes(kw, passes):
    from raytracebvh_tpu_torch.config import traversal_passes

    assert traversal_passes(T.RenderConfig(**kw)) == passes


def test_cli_renders_bmp(tmp_path):
    from raytracebvh_tpu_torch.cli import render as cli
    from raytracebvh_tpu_torch.io.bmp import read_bmp

    obj = tmp_path / "tri.obj"
    obj.write_text("v -1 -1 5\nv 1 -1 5\nv 0 1 5\nvt 0 0\nvt 1 0\nvt 0 1\n"
                   "vn 0 0 -1\nf 1/1/1 2/2/1 3/3/1\n")
    out = tmp_path / "out.bmp"
    rc = cli.main(["--obj", str(obj), "--width", "32", "--height", "24",
                   "--bounces", "1", "--frames", "2", "--out", str(out),
                   "--device", "cpu"])
    assert rc == 0
    assert read_bmp(str(out)).shape == (24, 32, 3)
    if not torch.cuda.is_available():
        assert cli.main(["--obj", str(obj), "--device", "cuda"]) == 1
    assert cli.main(["--obj", str(tmp_path / "missing.obj"),
                     "--device", "cpu"]) == 1
