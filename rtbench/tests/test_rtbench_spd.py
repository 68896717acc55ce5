"""The SPD scene (``scenes_spd.py``), its entry (``entries/spd_frame.py``)
and the walk window (``walks.py``) on the CPU: the Sierpinski tetrahedron's
counts, lattice, faces and objects at its configuration's size factor and
at a tiny one; the program against the plain reference on seeded poses at
the tiny size (``conftest.py``: size factor 3, 64 x 48); ``correct`` true
when sound and false under the lower-precision control and the planted
faults; the walk window's counts are the plain walks' step counts; and
its four readers."""

from __future__ import annotations

import inspect
import math

import pytest
import torch

from rtbench import compare, harness, scenes, scenes_spd, tracing, walks
from rtbench.entries.frame import render_config
from rtbench.reference import render as ref_render
from rtbench.tests import tiny

CELL = "tetra1m-frame_shadows"
SEED = 2 ** 31 + 2222
READERS = ("walk.steps_per_ray", "walk.ns_per_step", "build.topology_ms",
           "build.fit_ms")


def _config():
    man = harness.manifest()
    return harness.config_of(man, harness.cell(man, CELL))


def test_configuration_is_sf9_with_its_counts():
    conf = _config()
    sc = conf["scene"]
    assert sc["kind"] == "sierpinski_tetra" and sc["size_factor"] == 9
    assert conf["triangles"] == 1048576 and conf["vertices"] == 3145728
    assert conf["reduced"] == [] and conf["assumed"]
    raw = scenes_spd.make_scene(conf, SEED, "cpu")
    assert raw["indices"].numel() == 3 * conf["triangles"]
    assert raw["verts"].shape == (conf["vertices"], 3)
    assert torch.equal(raw["indices"], torch.arange(conf["vertices"],
                                                    dtype=torch.int32))
    # every corner on the level-9 lattice, exactly, inside the level-0 cube
    cell = sc["radius"] * 2.0 ** -sc["size_factor"]
    q = raw["verts"].double() / cell
    assert torch.equal(q, torch.round(q))
    assert float(raw["verts"].abs().max()) == sc["radius"]
    obj = raw["sphere"]
    assert int(obj.max()) + 1 == 64
    assert torch.equal(torch.bincount(obj), torch.full((64,), 12 * 4 ** 6))


@pytest.mark.parametrize("sf", [3, 4, 5])
def test_counts_faces_and_objects(sf):
    radius = 64.0
    verts, normals, uv, obj, mat = scenes_spd.sierpinski_tetra(sf, radius, 3,
                                                               "cpu")
    tets = 4 ** sf
    assert verts.shape == normals.shape == (3 * 4 * tets, 3)
    assert uv.shape == (3 * 4 * tets, 2) and mat.shape == (4 * tets,)
    assert int(mat.max()) == 0
    corners = verts.double().reshape(tets, 4, 3, 3)
    # each tetrahedron: its 4 distinct corners, every edge 2 R sqrt 2 / 2^sf
    distinct = torch.unique(torch.round(corners.reshape(tets, 12, 3) * 64),
                            dim=1)
    assert distinct.shape == (tets, 4, 3)
    edge = torch.linalg.vector_norm(corners[:, :, 1] - corners[:, :, 0],
                                    dim=-1)
    torch.testing.assert_close(edge, torch.full_like(edge, 2 * radius
                                                     * math.sqrt(2) / 2 ** sf))
    # outward, flat: a face's normal is its corners' cross product, away
    # from its tetrahedron's centre, the same at its three corners
    centre = corners.reshape(tets, 12, 3).mean(1)[:, None, :]
    face = corners.mean(2)
    n = torch.linalg.cross(corners[:, :, 1] - corners[:, :, 0],
                           corners[:, :, 2] - corners[:, :, 0])
    assert (torch.sum(n * (face - centre), -1) > 0).all()
    nrm = normals.double().reshape(tets, 4, 3, 3)
    torch.testing.assert_close(nrm[:, :, 0], n / torch.linalg.vector_norm(
        n, dim=-1, keepdim=True), atol=1e-6, rtol=0)
    assert torch.equal(nrm, nrm[:, :, :1].expand_as(nrm))
    assert uv.reshape(-1, 3, 2)[:, :, 0].tolist()[0] == [0.0, 1.0, 0.0]
    # 64 objects of 4^(sf - 3) tetrahedra, each a run of whole tetrahedra
    per = 12 * 4 ** (sf - 3)
    assert torch.equal(obj, torch.arange(64).repeat_interleave(per))


def test_poses_move_objects_rigidly():
    raw = scenes_spd.make_scene(tiny.sized(CELL)[1], SEED, "cpu")
    ring = scenes.pose_ring(raw, 3, math.sqrt(2), SEED)
    for pose in ring:
        d = (pose - raw["verts"]).reshape(64, -1, 3)
        assert torch.allclose(d, d[:, :1].expand_as(d), atol=1e-5)
        assert float(torch.linalg.vector_norm(d[:, 0], dim=-1).max()) \
            <= math.sqrt(2) + 1e-5


def _frame(pose: int, frame: int):
    from raytracebvh_tpu_torch.pipeline import render_frame

    man, conf, tr = tiny.sized(CELL)

    class R:  # what render_config reads of a run
        config, traffic = conf, tr

    cfg = render_config(R)
    raw = scenes_spd.make_scene(conf, SEED, "cpu")
    cam = scenes.camera(conf, "cpu")
    ring = scenes.pose_ring(raw, 4, tr["pose_jitter"], SEED)
    eyes = scenes.orbit_eyes(cam, tr["orbit_yaw"], 8)
    got = render_frame(scenes.port_scene(raw, ring[pose]),
                       scenes.port_camera(cam, eyes[frame]), cfg)
    want = ref_render.render(dict(raw, verts=ring[pose]),
                             dict(cam, eye=eyes[frame]),
                             compare.ref_cfg(cfg))
    return got, want


@pytest.mark.parametrize("pose,frame", [(0, 0), (1, 3), (3, 7)])
def test_frame_matches_reference(pose, frame):
    got, want = _frame(pose, frame)
    err = (got - want).abs().amax(dim=-1)
    assert (err > 1e-3).float().mean() == 0.0
    assert err.max() < 1e-4
    background = torch.tensor([0.5, 0.5, 0.5, 1.0])
    hit = (want != background).any(-1).float().mean()
    assert 0.05 < hit < 0.95


@pytest.mark.parametrize("variant", ["sound", "bf16", "altered", "half"])
def test_correct_only_when_sound(variant):
    run = tiny.drive(CELL, SEED, variant=variant)
    assert run.check.correct == (variant == "sound"), run.check.as_dict()
    assert run.iterations >= 1


def _window(cell: str):
    man, conf, tr = tiny.sized(cell)
    run = harness.Run(man, cell, 7, 0.05, False, torch.device("cpu"),
                      config=conf, traffic_=tr)
    harness.entry(tr["entry"]).window(run)
    return run


@pytest.fixture
def short(monkeypatch):
    monkeypatch.setattr(walks, "WARMUP", 1)
    monkeypatch.setattr(walks, "ITERATIONS", 3)


def test_window_counts_are_the_plain_walks_steps(short, monkeypatch):
    from raytracebvh_tpu_torch.ops import traverse as t_traverse

    run = _window(CELL)
    seen = []

    def wrap(walk):
        sig = inspect.signature(walk)

        def counted(*args, **kw):
            call = sig.bind(*args, **kw)
            out = walk(*call.args, **call.kwargs)
            if call.arguments.get("return_steps"):
                seen.append((int(out[1].sum()), int(out[1].numel())))
            return out
        return counted

    for name in ("traverse", "traverse_any"):
        monkeypatch.setattr(t_traverse, name, wrap(getattr(t_traverse,
                                                            name)))
    summary = walks.window(run)
    frames = summary["frames"]
    assert len(frames) == 3 and summary["traced"] == 2
    # the warm-up frame's two walks, then each frame's primary and shadow
    walked = seen[2:]
    assert len(walked) == 6
    for k, f in enumerate(frames):
        primary, shadow = walked[2 * k], walked[2 * k + 1]
        assert f["walks"] == {"walk.primary": primary,
                              "walk.shadow": shadow}
        assert f["steps"] == primary[0] + shadow[0]
        assert f["rays"] == 2 * 64 * 48
        assert f["topology_ms"] > 0 and f["fit_ms"] > 0


@pytest.mark.parametrize("cell", [CELL, "sphere3k-frame",
                                  "sphere100k-frame_shadows",
                                  "sphere3k-frame_onchip"])
def test_readers_in_their_cells(short, cell):
    run = _window(cell)
    listed = {m["name"] for m in harness.metrics_of(run.manifest, cell,
                                                    "per_layer")}
    assert set(READERS) <= listed
    got = {name: harness.reader(name)(run) for name in READERS}
    assert got["walk.steps_per_ray"] >= 1
    assert got["build.topology_ms"] > 0 and got["build.fit_ms"] > 0
    assert got["walk.ns_per_step"] is None  # no device trace on the CPU
    # a trace of 2 frames whose walks took 1 ms each
    steps = walks.traced_steps(walks.window(run))
    kernel = "void (anonymous namespace)::traverse_kernel<false>(float const*)"
    run.traced = tracing.Trace([{"cat": "kernel", "name": kernel, "ts": k,
                                 "dur": 1000.0} for k in range(2)], 2, 1.0)
    assert harness.reader("walk.ns_per_step")(run) == pytest.approx(
        1e6 / steps)


def test_no_counter_no_steps(short, monkeypatch):
    from raytracebvh_tpu_torch.utils import profiling

    run = _window(CELL)
    monkeypatch.delattr(profiling, "counts")
    assert harness.reader("walk.steps_per_ray")(run) is None
    assert harness.reader("build.fit_ms")(run) > 0
    run = _window("sphere3k-train")
    assert walks.window(run) is None
