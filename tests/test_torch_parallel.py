"""The port's multi-device path (``raytracebvh_tpu_torch/parallel``)
against the single-process port and the JAX package's ``parallel/``.

The ranks are subprocesses over Gloo (a ``file://`` rendezvous in the
test's temporary directory, one thread each, a 60 s group timeout, no
JAX): one run of four ranks on the flat meshes (4 x 1 for
``render_sharded``, 2 x 2 for the rest), and one on the host mesh
(``LOCAL_WORLD_SIZE=2``: ('dcn', 'rays', 'geo') = (2, 1, 2)).  Each rank
writes an npz; the tests compare them here, where the JAX side runs on
the conftest's virtual CPU devices (``make_mesh(4, ...)`` takes the first
four).  Both sides get the same scenes (the procedural generators are
copies, seeded alike) and the same parameters (``params_from_numpy`` of
the JAX ``init_params``).

Tolerances:
  * the sharded frames against the port's ``render_frame``: exact (the
    shards do the same elementwise operations, min/max and gathers are
    exact, and a ray's colour does not depend on its order);
  * against the JAX package's: its sharded functions run under ``jit``,
    where XLA contracts some a*b + c into FMAs that the port rounds apart
    (the port's ``render_frame`` equals JAX's eager ``render_frame`` on
    these scenes, and is 2.1e-5 off ``render_frame_jit``): so
    ``render_sharded`` is held to JAX's within atol 1e-4 (the bound
    tests/test_torch_shadows.py holds textured frames to against jitted
    JAX; measured 2.1e-5), and ``render_geo_sharded`` within
    tests/test_sharding.py's atol 1e-3 (measured 1.1e-5 on the
    16-triangle scene, 3.1e-5 on the 300-triangle one with shadows);
  * ``train_step_sharded`` against the single-process ``loss_fn`` +
    ``backward()``: loss rtol 1e-6, gradients 1e-5 of each tensor's
    largest |grad| (tests/test_torch_inverse.py's float32 rule); against
    JAX's ``train_step_sharded`` on ``make_mesh(4, geo=2)``, which runs
    under ``jit``: loss rtol 1e-6, gradients atol 1e-6, the bound
    tests/test_sharding.py:74 holds JAX's own sharded step to its single
    one by (the FMAs move the vertex gradient by 1.5e-7, 7e-5 of its
    largest |grad|);
  * the culled chunked step (``ray_chunk`` 8) against JAX's and the
    unculled step: their tolerances above;
  * ``grad_chunks=4`` against 1: rtol 1e-4, atol 1e-7 (loss rtol 1e-6;
    tests/test_sharding.py); the host mesh against the flat one: loss
    rtol 1e-6, gradients rtol 1e-5, atol 1e-7; every rank returns the
    same bits.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracebvh_tpu as J
from raytracebvh_tpu.core.types import scene_to_device
from raytracebvh_tpu.models import inverse as ji
from raytracebvh_tpu.models.procedural import random_triangles as j_random
from raytracebvh_tpu.parallel import mesh as jm
from raytracebvh_tpu.parallel import render as jr
from raytracebvh_tpu.parallel import scaling as js
import raytracebvh_tpu_torch as T
from raytracebvh_tpu_torch.models import inverse as ti
from raytracebvh_tpu_torch.models.procedural import random_triangles as t_random
from raytracebvh_tpu_torch.parallel import mesh as tm
from raytracebvh_tpu_torch.parallel import render as t_render
from raytracebvh_tpu_torch.parallel import scaling as ts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
FIELDS = ti.InverseParams._fields
# tests/test_sharding.py:23-29's scene and frame
SCENE16 = dict(num_tris=16, seed=5, extent=8.0, tri_size=2.0,
               with_texture=True)
CFG16 = dict(width=16, height=32, bounces=1, leaf_pad_multiple=32)
# tests/test_torch_shadows.py's scene and light
SCENE300 = dict(num_tris=300, seed=7, with_texture=True)
CFG300 = dict(width=48, height=48, bounces=1, enable_shadows=True,
              light_pos=(10.0, 80.0, -40.0), ortho_scale=2.0)
# tests/test_sharding.py:166-183's mid-size scene
SCENE4K = dict(num_tris=4096, seed=5, extent=40.0, tri_size=3.0,
               with_texture=True)
CFG4K = dict(width=128, height=128, bounces=0)

RANK = """
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
rank, world, local, store, out, mode = sys.argv[1:7]
os.environ.update(RANK=rank, WORLD_SIZE=world, LOCAL_RANK=str(int(rank) % int(local)),
                  LOCAL_WORLD_SIZE=local)
sys.modules["jax"] = None
import raytracebvh_tpu_torch as T
from raytracebvh_tpu_torch.models import inverse as ti
from raytracebvh_tpu_torch.models.procedural import random_triangles
from raytracebvh_tpu_torch.parallel import mesh as tm, render as tr, scaling as ts
sc, cfgs, pnpz = json.loads(sys.argv[7]), json.loads(sys.argv[8]), sys.argv[9]
tm.initialize_distributed(device="cpu", init_method="file://" + store, timeout_s=60)
cam = T.Camera.default("cpu")
scene = {k: random_triangles(**v, device="cpu") for k, v in sc.items()}
cfg = {k: T.RenderConfig(**v) for k, v in cfgs.items()}
p = np.load(pnpz)
params = ti.params_from_numpy(type("P", (), {f: p[f] for f in p.files}), device="cpu")
target = torch.zeros(32, 16, 4)
res = {}

def info(name, mesh):
    res[name + "_names"] = np.array(mesh.mesh_dim_names)
    res[name + "_shape"] = np.array(mesh.shape)
    res[name + "_ranks"] = mesh.mesh.numpy()
    res[name + "_coord"] = np.array(mesh.get_coordinate())
    res[name + "_ray_axes"] = np.array(tm.ray_axes(mesh))

def step(tag, mesh, c=None, **kw):
    loss, grads = tr.train_step_sharded(params, ti.apply_params, scene["s16"], cam,
                                        target, c or cfg["c16"], mesh, **kw)
    res[tag + "_loss"] = loss.numpy()
    for f, g in zip(ti.InverseParams._fields, grads):
        res[tag + "_" + f] = g.numpy()

def raises(tag, fn):
    try:
        fn()
    except ValueError as e:
        res[tag] = np.array(str(e))

if mode == "flat":
    m41 = tm.make_mesh(4, geo=1, device="cpu")
    m22 = tm.make_mesh(4, geo=2, device="cpu")
    info("m41", m41)
    info("m22", m22)
    for tag, kw in (("rs", {}), ("rs_tiled", dict(ray_tile=4)), ("rs_perm", dict(ray_tile=3))):
        res[tag] = tr.render_sharded(scene["s16"], cam, cfg["c16"].replace(**kw), m41).numpy()
    res["rgs"] = tr.render_geo_sharded(scene["s16"], cam, cfg["c16"], m22).numpy()
    res["rgs300"] = tr.render_geo_sharded(scene["s300"], cam, cfg["c300"], m22).numpy()
    res["rgs4k"] = tr.render_geo_sharded(scene["s4k"], cam, cfg["c4k"], m22).numpy()
    step("step", m22)
    step("chunks", m22, grad_chunks=4)
    step("culled", m22, cfg["c16"].replace(ray_chunk=8))
    s16 = scene["s16"]
    rep = tm.replicated(s16.replace(verts=s16.verts + int(rank)), m22)
    res["replicated"] = rep.verts.numpy()
    res["replicated_fov"] = tm.replicated(cam.replace(fov=cam.fov + int(rank)), m22).fov.numpy()
    res["comm"] = np.array(json.dumps(ts.comm_volume_per_device(scene["s16"], params, m22)))
    raises("err_faces", lambda: tr.render_geo_sharded(
        random_triangles(15, seed=5, device="cpu"), cam, cfg["c16"], m22))
    raises("err_chunk", lambda: tr.render_geo_sharded(
        scene["s16"], cam, cfg["c16"].replace(height=24, ray_chunk=128), m22))
    raises("err_grad_chunks", lambda: step("bad", m22, grad_chunks=3))
    recs = ts.weak_scaling_sweep(max_devices=2, iters=1, device="cpu")
    res["sweep"] = np.array(json.dumps(recs))
    if rank == "0":
        ts.write_scaling_report(recs, os.path.join(out, "scaling.json"), device="cpu")
else:
    mh = tm.make_host_mesh(geo=2, device="cpu")
    info("mh", mh)
    res["rs"] = tr.render_sharded(scene["s16"], cam, cfg["c16"], mh).numpy()
    res["rgs"] = tr.render_geo_sharded(scene["s16"], cam, cfg["c16"], mh).numpy()
    step("step", mh)
np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
torch.distributed.destroy_process_group()
"""


def _jax_scene(kw):
    return scene_to_device(j_random(**kw))


def _run_ranks(tmp, mode, local):
    """Starts the four ranks of ``mode`` and returns their npz contents."""
    out = tmp / mode
    out.mkdir()
    params = ji.init_params(_jax_scene(SCENE16))
    pnpz = str(out / "params.npz")
    np.savez(pnpz, **{f: np.asarray(getattr(params, f)) for f in FIELDS})
    scenes = json.dumps({"s16": SCENE16, "s300": SCENE300, "s4k": SCENE4K})
    cfgs = json.dumps({"c16": CFG16, "c300": CFG300, "c4k": CFG4K})
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(WORLD), str(local),
         str(out / "store"), str(out), mode, scenes, cfgs, pnpz],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=ROOT) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {mode}:\n{log[-3000:]}"
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)], out


@pytest.fixture(scope="module")
def flat(tmp_path_factory):
    return _run_ranks(tmp_path_factory.mktemp("parallel"), "flat", WORLD)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    return _run_ranks(tmp_path_factory.mktemp("parallel"), "host", 2)[0]


def _port_frame(scene_kw, cfg_kw):
    return T.render_frame(t_random(**scene_kw, device="cpu"),
                          T.Camera.default("cpu"),
                          T.RenderConfig(**cfg_kw)).numpy()


def _jax_frame(fn, scene_kw, cfg_kw, geo):
    return np.asarray(fn(_jax_scene(scene_kw), J.Camera.default(),
                         J.RenderConfig(**cfg_kw), jm.make_mesh(WORLD, geo=geo)))


def _assert_grads(got, want, rel=1e-5):
    for f, a, b in zip(FIELDS, got, want):
        scale = np.abs(b).max()
        assert scale > 0, f
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale, err_msg=f)


def _step(res, tag="step"):
    return float(res[tag + "_loss"]), [res[f"{tag}_{f}"] for f in FIELDS]


@pytest.mark.parametrize("tag, tile", [("rs", {}),
                                       ("rs_tiled", dict(ray_tile=4)),
                                       ("rs_perm", dict(ray_tile=3))],
                         ids=["rows", "tiled", "permuted"])
def test_render_sharded_equals_frame(flat, tag, tile):
    """rays = 4: each rank's 8 rows (traced in tile order: 4 x 4 tiles by
    reshape, 3 x 3 by permutation) gathered into the port's frame."""
    want = _port_frame(SCENE16, dict(CFG16, **tile))
    for res in flat[0]:
        np.testing.assert_array_equal(res[tag], want)


def test_render_sharded_matches_jax(flat):
    want = _jax_frame(jr.render_sharded, SCENE16, CFG16, geo=1)
    np.testing.assert_allclose(flat[0][0]["rs"], want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("tag, scene_kw, cfg_kw", [
    ("rgs", SCENE16, CFG16), ("rgs300", SCENE300, CFG300)],
    ids=["16_tris", "300_tris_shadows"])
def test_render_geo_sharded_equals_frame_and_matches_jax(flat, tag, scene_kw,
                                                         cfg_kw):
    want = _port_frame(scene_kw, cfg_kw)
    for res in flat[0]:
        np.testing.assert_array_equal(res[tag], want)
    jax_img = _jax_frame(jr.render_geo_sharded, scene_kw, cfg_kw, geo=2)
    np.testing.assert_allclose(flat[0][0][tag], jax_img, rtol=0, atol=1e-3)
    bg = np.asarray(T.RenderConfig().background, np.float32)
    assert 0.05 < (~(np.abs(want - bg) < 1e-6).all(-1)).mean() < 0.95


def test_geo_sharded_midsize_scene_equals_frame(flat):
    """4 096 triangles at 128 x 128: the geo all-gather ships the leaf
    data of 2 048 faces a rank."""
    want = _port_frame(SCENE4K, CFG4K)
    np.testing.assert_array_equal(flat[0][1]["rgs4k"], want)
    assert (np.abs(want[..., 0] - 0.5) > 1e-6).sum() > 10000


def test_host_mesh_frames_equal_frame(host):
    want = _port_frame(SCENE16, CFG16)
    for res in host:
        np.testing.assert_array_equal(res["rs"], want)
        np.testing.assert_array_equal(res["rgs"], want)


def test_train_step_sharded_matches_single_process(flat):
    ts16 = t_random(**SCENE16, device="cpu")
    params = ti.params_from_numpy(ji.init_params(_jax_scene(SCENE16)),
                                  device="cpu")
    loss = ti.loss_fn(params, ts16, T.Camera.default("cpu"),
                      torch.zeros(32, 16, 4), T.RenderConfig(**CFG16))
    loss.backward()
    got_loss, got = _step(flat[0][0])
    np.testing.assert_allclose(got_loss, float(loss.detach()), rtol=1e-6)
    _assert_grads(got, [getattr(params, f).grad.numpy() for f in FIELDS])


def test_train_step_sharded_matches_jax(flat):
    js16 = _jax_scene(SCENE16)
    loss, grads = jr.train_step_sharded(
        ji.init_params(js16), ji.apply_params, js16, J.Camera.default(),
        jnp.zeros((32, 16, 4), jnp.float32), J.RenderConfig(**CFG16),
        jm.make_mesh(WORLD, geo=2))
    got_loss, got = _step(flat[0][0])
    np.testing.assert_allclose(got_loss, float(loss), rtol=1e-6)
    for f, a in zip(FIELDS, got):
        np.testing.assert_allclose(a, np.asarray(getattr(grads, f)), rtol=0,
                                   atol=1e-6, err_msg=f)


def test_culled_train_step_sharded_matches_jax(flat):
    """A step whose ray chunks cull (ray_chunk 8: half rows, about half of
    them all-miss), the hit chunks' shading and gradients in
    graphs.while_loop, against JAX's sharded step through lax.map of
    lax.cond and the same unculled step on the port, at the unculled
    step's tolerances."""
    cfg_kw = dict(CFG16, ray_chunk=8)
    hits = _port_frame(SCENE16, CFG16)
    bg = np.asarray(T.RenderConfig().background, np.float32)
    chunk_hits = (~(np.abs(hits - bg) < 1e-6).all(-1)).reshape(-1, 8).any(-1)
    assert chunk_hits.any() and not chunk_hits.all()
    js16 = _jax_scene(SCENE16)
    loss, grads = jr.train_step_sharded(
        ji.init_params(js16), ji.apply_params, js16, J.Camera.default(),
        jnp.zeros((32, 16, 4), jnp.float32), J.RenderConfig(**cfg_kw),
        jm.make_mesh(WORLD, geo=2))
    got_loss, got = _step(flat[0][0], "culled")
    np.testing.assert_allclose(got_loss, float(loss), rtol=1e-6)
    for f, a in zip(FIELDS, got):
        np.testing.assert_allclose(a, np.asarray(getattr(grads, f)), rtol=0,
                                   atol=1e-6, err_msg=f)
    l1, g1 = _step(flat[0][0])
    np.testing.assert_allclose(got_loss, l1, rtol=1e-6)
    _assert_grads(got, g1)


def test_grad_chunks_match_one_chunk(flat):
    """grad_chunks=4: four builds, forwards and backwards, each chunk's
    all-reduce over 'geo' overlapping the next chunk."""
    l1, g1 = _step(flat[0][0])
    l4, g4 = _step(flat[0][0], "chunks")
    np.testing.assert_allclose(l4, l1, rtol=1e-6)
    for a, b in zip(g4, g1):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7)


def test_host_mesh_train_step_matches_flat(flat, host):
    l1, g1 = _step(flat[0][0])
    l2, g2 = _step(host[0])
    np.testing.assert_allclose(l2, l1, rtol=1e-6)
    for a, b in zip(g2, g1):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("which", ["flat", "host"])
def test_ranks_return_the_same_bits(flat, host, which):
    ranks = flat[0] if which == "flat" else host
    tags = ["rs", "rgs", "step_loss"] + [f"step_{f}" for f in FIELDS]
    if which == "flat":
        tags += ["chunks_loss", "culled_loss", "rgs300", "rgs4k",
                 "replicated"] + [f"{t}_{f}" for t in ("chunks", "culled")
                                  for f in FIELDS]
    for res in ranks[1:]:
        for tag in tags:
            np.testing.assert_array_equal(res[tag], ranks[0][tag], tag)


def test_replicated_broadcasts_the_origin_rank(flat):
    want = np.asarray(_jax_scene(SCENE16).verts)
    fov = T.Camera.default("cpu").fov.numpy()
    for res in flat[0]:
        np.testing.assert_array_equal(res["replicated"], want)
        np.testing.assert_array_equal(res["replicated_fov"], fov)


@pytest.mark.parametrize("n, geo", [(4, 1), (4, 2)])
def test_make_mesh_matches_jax(flat, n, geo):
    jmesh = jm.make_mesh(n, geo=geo)
    name = "m41" if geo == 1 else "m22"
    for r, res in enumerate(flat[0]):
        assert tuple(res[name + "_names"]) == jmesh.axis_names
        assert tuple(res[name + "_shape"]) == jmesh.devices.shape
        # rank r at the reshape of the JAX package's mesh.py:46
        np.testing.assert_array_equal(
            res[name + "_ranks"], np.arange(n).reshape(n // geo, geo))
        assert tuple(res[name + "_coord"]) == (r // geo, r % geo)
        assert str(res[name + "_ray_axes"]) == jm.ray_axes(jmesh)


def test_make_host_mesh_layout(host):
    """LOCAL_WORLD_SIZE=2 of 4: two hosts, each a (rays, geo) = (1, 2)
    block; rays shard over ('dcn', 'rays') as in the JAX package."""
    jhost = jm.make_host_mesh(geo=2)  # one process: (1, 4, 2)
    assert tm.host_mesh_shape(8, 8, 2) == jhost.devices.shape
    for r, res in enumerate(host):
        assert tuple(res["mh_names"]) == jhost.axis_names
        assert tuple(res["mh_shape"]) == tm.host_mesh_shape(4, 2, 2) == (
            2, 1, 2)
        np.testing.assert_array_equal(res["mh_ranks"],
                                      np.arange(4).reshape(2, 1, 2))
        assert tuple(res["mh_ray_axes"]) == jm.ray_axes(jhost)
    with pytest.raises(ValueError, match="not divisible by geo=3"):
        tm.host_mesh_shape(8, 4, 3)


@pytest.mark.parametrize("shape, multiple, axis", [
    ((10, 3), 4, 0), ((12, 3), 4, 0), ((5, 7), 3, 1), ((0,), 8, 0)])
def test_pad_to_multiple_matches_jax(shape, multiple, axis):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got, n = tm.pad_to_multiple(x, multiple, axis, fill=-1)
    want, wn = jm.pad_to_multiple(x, multiple, axis, fill=-1)
    assert n == wn
    np.testing.assert_array_equal(got, want)


def test_comm_volume_matches_jax(flat):
    js16 = _jax_scene(SCENE16)
    want = js.comm_volume_per_device(js16, ji.init_params(js16),
                                     jm.make_mesh(WORLD, geo=2))
    for res in flat[0]:
        assert json.loads(str(res["comm"])) == want


def test_predict_multihost_efficiency_model():
    """The JAX package's checks (tests/test_sharding.py:145-163) with the
    H100 link rates: NVLink 4 inside a host, a 400 Gb/s NIC between."""
    scene = t_random(**SCENE16, device="cpu")
    params = ti.init_params(scene)
    pred = ts.predict_multihost_efficiency(scene, params, 0.105, hosts=4,
                                           local_devices=4, geo=2)
    assert pred["assumed_ici_bw"] == ts.NVLINK_BW == 4.5e11
    assert pred["assumed_dcn_bw"] == ts.NIC_BW == 5.0e10
    assert 0.0 < pred["efficiency_serial_bound"] <= 1.0
    assert (pred["efficiency_overlapped_bound"]
            >= pred["efficiency_serial_bound"])
    assert pred["efficiency_serial_bound"] > 0.8
    p8 = ts.predict_multihost_efficiency(scene, params, 0.105, hosts=8,
                                         local_devices=4, geo=2)
    assert p8["dcn_bytes_per_device"] >= pred["dcn_bytes_per_device"]
    # the same model as the JAX package's, given the same link rates
    js16 = _jax_scene(SCENE16)
    want = js.predict_multihost_efficiency(
        js16, ji.init_params(js16), 0.105, hosts=4, local_devices=4, geo=2,
        ici_bw=ts.NVLINK_BW, dcn_bw=ts.NIC_BW)
    assert pred.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(pred[k], want[k], rtol=1e-12, err_msg=k)


def test_weak_scaling_sweep_and_report(flat):
    """Meshes of 1 and 2 ranks inside a world of 4 (ranks 2 and 3 wait at
    the barrier); the records carry the JAX sweep's keys, and the report
    goes only where it is told."""
    ranks, out = flat
    jax_keys = {"devices", "mesh", "tris", "rays_per_step", "step_ms",
                "step_ms_overlapped", "rays_per_sec", "weak_scaling_efficiency"}
    jax_keys |= set(js.comm_volume_per_device(
        _jax_scene(dict(num_tris=8, seed=0)),
        ji.init_params(_jax_scene(dict(num_tris=8, seed=0))),
        jm.make_mesh(1)))
    recs = json.loads(str(ranks[0]["sweep"]))
    assert [r["devices"] for r in recs] == [1, 2]
    assert [r["mesh"] for r in recs] == [{"rays": 1, "geo": 1},
                                         {"rays": 1, "geo": 2}]
    for rec in recs:
        assert set(rec) == jax_keys
        assert rec["step_ms"] > 0
    assert recs[0]["weak_scaling_efficiency"] == 1.0
    assert [r["devices"] for r in json.loads(str(ranks[1]["sweep"]))] == [2]
    assert json.loads(str(ranks[2]["sweep"])) == []
    report = json.loads((out / "scaling.json").read_text())
    assert report["records"] == recs
    assert report["device"] == "cpu" and report["backend"] == "gloo"
    assert report["world_size"] == WORLD
    with pytest.raises(ValueError, match="committed"):
        ts.write_scaling_report(recs, os.path.join(ROOT, "SCALING.json"),
                                device="cpu")
    assert ts.REPORT_PATH == ts.ROOT / "build" / "raytracebvh_tpu_torch" \
        / "scaling_torch.json"


def test_indivisible_inputs_raise(flat):
    """Raised alike on every rank, so no rank is left waiting in a
    collective: 15 faces over geo=2 (before any collective), ray_chunk
    128 against 192 local rays (384 over 2 ray shards; ``shade_rays``
    names the local count), and 3 gradient chunks of 256 local rays."""
    for res in flat[0]:
        assert "15 faces" in str(res["err_faces"])
        assert "pad_to_multiple" in str(res["err_faces"])
        assert "ray_chunk 128 must divide ray count 192" in str(
            res["err_chunk"])
        assert "grad_chunks 3 must divide the local ray count 256" in str(
            res["err_grad_chunks"])


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card the default device raises; no fallback to Gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.initialize_distributed()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.make_mesh()


class _Mesh:
    """A stand-in for a DeviceMesh: ``mesh_graphs`` keeps its cache on it."""


def test_sharded_signatures_tell_meshes_and_chunks_apart():
    """The sharded captures' caches and keys: every mesh holds its own
    cache (``mesh_graphs``: the same mesh gives the same cache, another
    mesh, also of the same shape, another; it goes with its mesh); in a
    cache, the same entry point, config, static arguments and inputs give
    one key, and another grad_chunks, scene_fn, entry point, config or
    input shape another."""
    import gc
    import weakref

    m1, m2 = _Mesh(), _Mesh()
    c1 = tm.mesh_graphs(m1)
    assert c1 is tm.mesh_graphs(m1) and c1 is not tm.mesh_graphs(m2)
    assert c1.capture_error_mode == "thread_local"
    gone = weakref.ref(c1)
    del m1, c1
    gc.collect()
    assert gone() is None

    scene = t_random(20, seed=1, device="cpu")
    cam = T.Camera.default("cpu")
    cfg = T.RenderConfig(width=8, height=8)

    def key(*static, name="train_step_sharded", c=cfg, s=scene):
        return t_render.signature(name, c, (s, cam), *static)

    want = key(1, ti.apply_params)
    assert want == key(1, ti.apply_params)
    assert hash(want) == hash(key(1, ti.apply_params))
    others = [key(4, ti.apply_params), key(1, lambda p, s: s),
              key(1, ti.apply_params, name="render_sharded"),
              key(1, ti.apply_params, c=cfg.replace(width=16)),
              key(1, ti.apply_params, s=t_random(40, seed=1, device="cpu"))]
    assert len(set(others + [want])) == len(others) + 1
