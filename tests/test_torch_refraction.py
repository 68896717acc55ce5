"""The port's refraction chain and present blend against the JAX package,
and the render CLI's --shadows / --refract / --device flags.

Scenes: tests/test_refraction.py's semi-transparent triangles (alpha 0.4,
optical density 0.7), and the same with optical density 1.8, where
refraction meets total internal reflection.  Tolerances: frames within
atol 1e-5 of eager JAX ``render_frame``.  Eager JAX runs op by op, as
PyTorch does; only its traversal loop and its ``ray_chunk`` loop body are
compiled, and there XLA may contract a*b + c into one FMA (measured max
|diff| 1.9e-6, and 0 on the unchunked frames).  The jitted frame is not
the reference here: its FMAs shift refracted directions by an ulp, which
the textured bounce amplifies to 5e-3 on a few pixels.  The primary
pass's spawns against eager JAX within atol 1e-6, the TIR mask exactly.
"""

import os

import jax
import numpy as np
import pytest
import torch

import raytracebvh_tpu as J
from raytracebvh_tpu import pipeline as jp
from raytracebvh_tpu.camera import camera_matrices as j_camera_matrices
from raytracebvh_tpu.core.types import scene_to_device
from raytracebvh_tpu.models.procedural import random_triangles as j_random
from raytracebvh_tpu.pipeline import render_frame as j_render_frame
import raytracebvh_tpu_torch as T
from raytracebvh_tpu_torch import pipeline as tp
from raytracebvh_tpu_torch.core.types import HitRecord, bvh_from_numpy
from raytracebvh_tpu_torch.models.procedural import random_triangles as t_random

GLASS = dict(alpha=0.4, optical_density=0.7)  # tests/test_refraction.py:21


def _render_both(scene_kw, **kw):
    js = scene_to_device(j_random(200, seed=11, **scene_kw))
    ts = t_random(200, device="cpu", seed=11, **scene_kw)
    want = np.asarray(j_render_frame(js, J.Camera.default(),
                                     J.RenderConfig(**kw)))
    got = T.render_frame(ts, T.Camera.default("cpu"), T.RenderConfig(**kw))
    return got.numpy(), want


@pytest.mark.parametrize("scene_kw,kw", [
    (GLASS, dict(bounces=2, ortho_scale=0.2)),  # tests/test_refraction.py
    (dict(GLASS, with_texture=True),
     dict(bounces=1, ortho_scale=0.2, ray_tile=16, texture_dtype="uint8")),
    (dict(GLASS, with_texture=True),
     dict(bounces=1, ortho_scale=2.0, ray_chunk=48, enable_shadows=True)),
    (dict(alpha=0.4, optical_density=1.8), dict(bounces=2, ortho_scale=0.2)),
], ids=["glass", "tiled_u8", "chunked_culled_shadows", "tir"])
def test_refraction_frame_matches_jax(scene_kw, kw):
    kw = dict(width=48, height=48, enable_refraction=True, **kw)
    got, want = _render_both(scene_kw, **kw)
    bg = np.asarray(J.RenderConfig().background, np.float32)
    hits = ~(np.abs(want - bg) < 1e-6).all(-1)
    assert 0.02 < hits.mean() < 0.95
    if "ray_chunk" in kw:
        chunk_hits = hits.reshape(-1, kw["ray_chunk"]).any(-1)
        assert chunk_hits.any() and not chunk_hits.all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the refraction chain is visible in this frame
    opaque, _ = _render_both(scene_kw, **dict(kw, enable_refraction=False))
    assert np.abs(got - opaque).max() > 0.05


@pytest.mark.parametrize("density", [0.7, 1.8])
def test_primary_spawns_match_jax(density):
    """``_launch_soa``'s reflection and refraction spawns on the same
    primary hits; at optical density 1.8 some hits reflect totally and
    spawn no refraction ray."""
    cfg = J.RenderConfig(width=48, height=48, bounces=1, ortho_scale=0.2,
                         enable_refraction=True)
    tcfg = T.RenderConfig(width=48, height=48, bounces=1, ortho_scale=0.2,
                          enable_refraction=True)
    kw = dict(seed=11, alpha=0.4, optical_density=density)
    js = scene_to_device(j_random(200, **kw))
    ts = t_random(200, device="cpu", **kw)
    cam = J.Camera.default()
    wvp, wv = j_camera_matrices(cam, 48, 48)
    jb = jax.jit(lambda s: jp.build_bvh(s, wvp, wv, cfg))(js)
    jrays = jp.make_rays(cam, cfg)
    jrec = jp._traverse_ids(jb, jrays, cfg)
    jo3, jd3 = jp._split_rays(jrays)
    want = jp._launch_soa(js, jb, jo3, jd3, cfg, None, None, jrec)

    tb = bvh_from_numpy(jb, "cpu")
    o, d = _torch(jrays.origin), _torch(jrays.direction)
    trec = HitRecord(hit=_torch(jrec.hit), distance=_torch(jrec.distance),
                     leaf=_torch(jrec.leaf))
    got = tp._launch_soa(ts, tb, tuple(o[:, k] for k in range(3)),
                         tuple(d[:, k] for k in range(3)), tcfg,
                         tp._frame_tex_quads(ts, tcfg), None, trec)
    got_leaves = jax.tree_util.tree_leaves(got)
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves) == 18
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    hit = np.asarray(jrec.hit)
    refr_int = got[4].numpy()
    assert (refr_int[hit] > 0).any()
    tir = hit & (refr_int == 0)
    np.testing.assert_array_equal(tir, hit & (np.asarray(want[4]) == 0))
    assert tir.any() == (density > 1.0)


def _torch(x):
    return torch.from_numpy(np.array(x))  # an own, writable copy


def test_refraction_is_a_no_op_on_opaque_scenes():
    ts = t_random(200, device="cpu", seed=11, alpha=1.0, optical_density=0.7)
    cfg = T.RenderConfig(width=48, height=48, bounces=1, ortho_scale=0.2)
    off = T.render_frame(ts, T.Camera.default("cpu"), cfg)
    on = T.render_frame(ts, T.Camera.default("cpu"),
                        cfg.replace(enable_refraction=True))
    assert torch.equal(on, off)


def _obj(tmp_path):
    obj = tmp_path / "two.obj"
    # a triangle in front of another: the near one shadows the far one
    obj.write_text("v -1 -1 5\nv 1 -1 5\nv 0 1 5\n"
                   "v -4 -4 9\nv 4 -4 9\nv 0 4 9\n"
                   "vt 0 0\nvt 1 0\nvt 0 1\nvn 0 0 -1\n"
                   "f 1/1/1 2/2/1 3/3/1\nf 4/1/1 5/2/1 6/3/1\n")
    return obj


def test_cli_renders_shadows_and_refraction_on_cpu(tmp_path):
    from raytracebvh_tpu_torch.cli import render as cli
    from raytracebvh_tpu_torch.io.bmp import read_bmp

    obj = _obj(tmp_path)
    args = ["--obj", str(obj), "--width", "32", "--height", "24",
            "--bounces", "1", "--device", "cpu"]
    plain, lit = tmp_path / "plain.bmp", tmp_path / "lit.bmp"
    assert cli.main(args + ["--out", str(plain)]) == 0
    assert cli.main(args + ["--out", str(lit), "--shadows", "--refract",
                            "--light", "0", "0", "-50"]) == 0
    a, b = read_bmp(str(plain)), read_bmp(str(lit))
    assert a.shape == b.shape == (24, 32, 3)
    # a light behind the far triangle leaves it in shadow
    assert cli.main(args + ["--out", str(lit), "--shadows",
                            "--light", "0", "0", "50"]) == 0
    assert (read_bmp(str(lit)) != a).any()


def test_cli_defaults_to_cuda_and_exits_1_without_it(tmp_path, monkeypatch,
                                                     capsys):
    """No --device means the card; without one the CLI says so and exits
    1 instead of rendering on the CPU."""
    from raytracebvh_tpu_torch.cli import render as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out.bmp"
    assert cli.main(["--obj", str(_obj(tmp_path)), "--width", "8",
                     "--height", "8", "--out", str(out)]) == 1
    assert "cuda" in capsys.readouterr().err.lower()
    assert not os.path.exists(out)
