"""The program against the benchmark's plain reference at a tiny size on
the CPU, through the program's plain routes (its kernel wrappers run their
plain versions on CPU tensors); and the lower-precision control failing
the comparison."""

from __future__ import annotations

import pytest
import torch

from rtbench import compare, harness, scenes
from rtbench.entries.frame import render_config
from rtbench.reference import render as ref_render
from rtbench.tests import tiny

SEED = 2 ** 31 + 12345


def test_scene_is_the_programs_sphere_grid():
    from raytracebvh_tpu_torch.models.procedural import sphere_grid

    man, conf, _ = tiny.sized("sphere100k-frame_shadows")
    sc = conf["scene"]
    raw = scenes.make_scene(conf, SEED, "cpu")
    prog = sphere_grid(sc["nx"], sc["ny"], sc["subdiv"], sc["spacing"],
                       sc["radius"], device="cpu")
    for f in ("verts", "normals", "uv", "indices", "mat_index"):
        assert torch.equal(raw[f], getattr(prog, f)), f
    assert torch.equal(raw["textures"], prog.textures)
    for f in ("ambient", "specular", "shininess", "tex_id"):
        assert torch.equal(raw["materials"][f], getattr(prog.materials, f))


def test_uv_sphere_has_the_counts_of_its_source():
    """sphere3k at its full size: Image_Test.obj's 3 072 faces on 1 538
    positions, one material, every face's corners shared with its
    neighbours', and the normals the unit positions."""
    man = harness.manifest()
    conf = harness.config_of(man, harness.cell(man, "sphere3k-frame"))
    raw = scenes.make_scene(conf, SEED, "cpu")
    idx = raw["indices"].long().reshape(-1, 3)
    assert idx.shape[0] == conf["triangles"] == 3072
    assert int(raw["mat_index"].max()) == 0
    assert raw["materials"]["diffuse"].shape[0] == 1
    assert torch.unique(idx).numel() == raw["verts"].shape[0]
    assert torch.bincount(idx.reshape(-1)).max() == 6
    positions = torch.unique(torch.round(raw["verts"] * 1e4), dim=0)
    assert positions.shape[0] == 1538
    centre = torch.tensor(conf["scene"]["center"])
    radius = conf["scene"]["radius"]
    torch.testing.assert_close(raw["normals"] * radius + centre,
                               raw["verts"])
    # every face is wound as sphere_grid winds its quads: outward
    pos = raw["verts"][idx]
    n = torch.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0], dim=-1)
    assert (torch.sum(n * (pos.mean(1) - centre), -1) < 0).all() or \
        (torch.sum(n * (pos.mean(1) - centre), -1) > 0).all()


def _frame(cell, pose: int, frame: int):
    from raytracebvh_tpu_torch.pipeline import render_frame

    man, conf, tr = tiny.sized(cell)

    class R:  # what render_config reads of a run
        config, traffic = conf, tr

    cfg = render_config(R)
    raw = scenes.make_scene(conf, SEED, "cpu")
    cam = scenes.camera(conf, "cpu")
    ring = scenes.pose_ring(raw, 4, tr["pose_jitter"], SEED)
    eyes = scenes.orbit_eyes(cam, tr["orbit_yaw"], 8)
    got = render_frame(scenes.port_scene(raw, ring[pose]),
                       scenes.port_camera(cam, eyes[frame]), cfg)
    want = ref_render.render(dict(raw, verts=ring[pose]),
                             dict(cam, eye=eyes[frame]),
                             compare.ref_cfg(cfg))
    return got, want


@pytest.mark.parametrize("cell", ["sphere3k-frame", "sphere100k-frame_shadows"])
@pytest.mark.parametrize("pose,frame", [(0, 0), (3, 5)])
def test_frame_matches_reference(cell, pose, frame):
    got, want = _frame(cell, pose, frame)
    err = (got - want).abs().amax(dim=-1)
    assert (err > 1e-3).float().mean() == 0.0
    assert err.max() < 1e-4


@pytest.mark.parametrize("cell", ["sphere3k-frame", "sphere100k-frame_shadows",
                                  "sphere3k-train"])
def test_run_is_correct(cell):
    run = tiny.drive(cell, SEED)
    assert run.check.correct, run.check.as_dict()
    assert run.iterations >= 1


def test_train_steps_match_reference_closely():
    run = tiny.drive("sphere3k-train", SEED + 1)
    for name, item in run.check.as_dict().items():
        assert item["value"] < 1e-4, (name, item)


@pytest.mark.parametrize("cell", ["sphere3k-frame", "sphere100k-frame_shadows",
                                  "sphere3k-train"])
def test_lower_precision_control_fails(cell):
    run = tiny.drive(cell, SEED + 2, variant="bf16")
    assert not run.check.correct, run.check.as_dict()


def test_primary_raster_equals_brute_force():
    man, conf, tr = tiny.sized("sphere3k-frame")

    class R:
        config, traffic = conf, tr

    cfg = compare.ref_cfg(render_config(R))
    raw = scenes.make_scene(conf, SEED, "cpu")
    cam = scenes.camera(conf, "cpu")
    geo, _ = ref_render.ray_space(raw, cam, cfg)
    pix = torch.arange(cfg["width"] * cfg["height"])
    o = ref_render.primary_origins(pix, cfg["width"], cfg["height"],
                                   cfg["ortho_scale"])
    one = torch.ones_like(o[0])
    d = (torch.zeros_like(one), torch.zeros_like(one), one)
    brute = ref_render.nearest_hits(o, d, geo["pos"], cfg["epsilon"])
    raster = ref_render.primary_hits(geo["pos"], cfg)
    for a, b in zip(brute, raster):
        assert torch.equal(a, b)
    assert brute[0].any()
