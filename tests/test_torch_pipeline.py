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
import raytracebvh_tpu_torch as T
from raytracebvh_tpu_torch.models.procedural import random_triangles as t_random
from raytracebvh_tpu_torch.ops import gather_cuda, traverse_cuda

W, H = 48, 32
BASE = dict(width=W, height=H, bounces=1, ortho_scale=2.0)


def _scenes(seed=6):
    kw = dict(seed=seed, with_texture=True)
    return scene_to_device(j_random(300, **kw)), t_random(300, **kw)


def _render_both(**kw):
    js, ts = _scenes()
    want = np.asarray(J.render_frame_jit(js, J.Camera.default(),
                                         J.RenderConfig(**BASE, **kw)))
    got = T.render_frame(ts, T.Camera.default(), T.RenderConfig(**BASE, **kw))
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
    a = T.render_frame(ts, T.Camera.default(), cfg.replace(
        traversal_backend="cuda", shade_gather_backend="cuda",
        texture_gather_backend="cuda"))
    b = T.render_frame(ts, T.Camera.default(), cfg.replace(
        traversal_backend="torch", shade_gather_backend="torch",
        texture_gather_backend="torch"))
    assert torch.equal(a, b)
    assert (traverse_cuda.launches, gather_cuda.launches) == (k1, k2)


@pytest.mark.parametrize("field", ["traversal_backend", "shade_gather_backend",
                                   "texture_gather_backend"])
@pytest.mark.parametrize("value", ["jnp", "pallas", "hbm", "sweep",
                                   "windowed", "xla", "Cuda"])
def test_tpu_backend_strings_raise(field, value):
    _, ts = _scenes()
    cfg = T.RenderConfig(width=8, height=8, bounces=0).replace(**{field: value})
    with pytest.raises(ValueError, match=field):
        T.render_frame(ts, T.Camera.default(), cfg)


@pytest.mark.parametrize("kw,exc", [
    (dict(enable_shadows=True), NotImplementedError),
    (dict(enable_refraction=True), NotImplementedError),
    (dict(sort_backend="radix"), ValueError),
    (dict(sort_backend="bitonic"), ValueError),
    (dict(ray_tile=16, ray_tile_order="diagonal"), ValueError),
])
def test_unported_options_raise(kw, exc):
    _, ts = _scenes()
    with pytest.raises(exc):
        T.render_frame(ts, T.Camera.default(),
                       T.RenderConfig(width=16, height=16, bounces=0, **kw))


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
    assert cli.main(["--obj", str(tmp_path / "missing.obj")]) == 1
