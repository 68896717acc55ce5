"""The build's leaf pack kernel (``ops/pack_cuda.py``, ``csrc/pack.cu``).

On the CPU: the rule that routes a build's pack to the kernel, as a pure
function of the config and the pack's input tensors; a CPU build packs
on the plain path; the wrapper refuses tensors of the wrong shape (the
kernel's C entry point is held to ``_kernels._SIGNATURES`` in
``test_torch_kernels.py``).

Marked ``gpu`` (they skip without a CUDA device; a CUDA kernel has no CPU
mode; this file imports no JAX): the kernel's BVH against the plain
pack's, bit for bit on every field and on K1's two tables
(``traverse_cuda.pack_tables`` of the plain BVH), for padded leaf counts
(padding leaves copy face 0; one that ends in a part of a warp), several materials with distinct texture
ids, a shared-vertex mesh, a small SPD tetra (every corner its own
vertex) and degenerate triangles; whole frames of the benchmark's
``frame_shadows`` and ``frame_onchip`` traffic at a test size, eager and
graphed, whose images equal the plain pack's bit for bit; and the
training steps, which differentiate their build and never launch it.
Each case checks ``pack_cuda.launches``.  On a GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_pack_cuda.py
"""

import dataclasses
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from raytracebvh_tpu_torch import pipeline
from raytracebvh_tpu_torch.config import RenderConfig
from raytracebvh_tpu_torch.ops import pack_cuda, traverse_cuda

INT_INPUTS = ("prim", "indices", "mat_index", "tex_id", "entry", "skip")


def _fake(name, device="cuda", dtype=None, requires_grad=False):
    """What ``engages`` reads of a tensor, on any device type (the CPU
    build can name a CUDA device but not make a tensor there)."""
    if dtype is None:
        dtype = torch.int32 if name in INT_INPUTS else torch.float32
    return SimpleNamespace(device=torch.device(device), dtype=dtype,
                           requires_grad=requires_grad)


def _pack_inputs(**kw):
    """A pack's inputs as ``engages`` sees them; ``kw`` name -> the
    ``_fake`` arguments that input takes instead."""
    scene = SimpleNamespace(
        materials=SimpleNamespace(ambient=0, diffuse=0, specular=0,
                                  shininess=0, optical_density=0, alpha=0,
                                  tex_id=0),
        indices=0, uv=0, mat_index=0)
    names = pack_cuda.inputs(scene, *range(7))
    return {k: _fake(k, **kw.get(k, {})) for k in names}


def test_inputs_are_every_table_the_kernel_reads():
    names = set(_pack_inputs())
    assert len(names) == 17
    assert set(INT_INPUTS) <= names
    assert names - set(INT_INPUTS) == set(pack_cuda._FLOATS)


def test_kernel_route_on_the_card_without_gradients():
    cfg = RenderConfig()
    assert pack_cuda.engages(cfg, _pack_inputs())
    grads = _pack_inputs(verts=dict(requires_grad=True))
    with torch.no_grad():
        assert pack_cuda.engages(cfg, grads)
    with torch.enable_grad():
        assert not pack_cuda.engages(cfg, grads)


@pytest.mark.parametrize("case", [
    "cpu", "bfloat16", "grad_verts", "grad_materials", "float64_uv",
    "int64_indices", "one_input_on_the_cpu"])
def test_plain_route(case):
    """The plain pack runs for CPU tensors, in bfloat16, where an input
    requires grad under grad mode (the moved vertices, the learned
    colours), and for inputs the kernel does not read."""
    cfg = RenderConfig()
    inputs = {
        "cpu": lambda: _pack_inputs(**{k: dict(device="cpu")
                                       for k in _pack_inputs()}),
        "bfloat16": _pack_inputs,
        "grad_verts": lambda: _pack_inputs(verts=dict(requires_grad=True)),
        "grad_materials": lambda: _pack_inputs(
            diffuse=dict(requires_grad=True)),
        "float64_uv": lambda: _pack_inputs(uv=dict(dtype=torch.float64)),
        "int64_indices": lambda: _pack_inputs(
            indices=dict(dtype=torch.int64)),
        "one_input_on_the_cpu": lambda: _pack_inputs(
            bbmin=dict(device="cpu")),
    }[case]()
    if case == "bfloat16":
        cfg = cfg.replace(dtype="bfloat16")
    with torch.enable_grad():
        assert not pack_cuda.engages(cfg, inputs)


def test_cpu_build_takes_the_plain_pack():
    """A CPU build packs in plain PyTorch: no launch, no K1 tables, and
    ``tri_verts`` a table of its own."""
    from raytracebvh_tpu_torch import Camera
    from raytracebvh_tpu_torch.models.procedural import random_triangles

    scene = random_triangles(60, seed=2, device="cpu")
    cfg = RenderConfig(width=16, height=16, ortho_scale=1.4)
    before = pack_cuda.launches
    bvh = pipeline.frame_inputs(scene, Camera.default("cpu"), cfg)[0]
    assert pack_cuda.launches == before
    assert bvh.node_table is None and bvh.leaf_table is None
    assert bvh.tri_verts.is_contiguous()
    assert torch.equal(bvh.leaf_attrs[:, 0:9].reshape(-1, 3, 3),
                       bvh.tri_verts)


@pytest.mark.parametrize("name,shape", [
    ("bbmin", (511, 3)), ("indices", (899,)), ("uv", (900, 3)),
    ("tex_id", (2,))])
def test_pack_refuses_a_wrong_shape(name, shape):
    """Before any launch: every table's shape against the leaf count, the
    faces, the vertices and the materials."""
    n, nf, nv, k = 256, 300, 900, 3
    shapes = dict(prim=(n,), indices=(3 * nf,), verts=(nv, 3),
                  normals=(nv, 3), uv=(nv, 2), mat_index=(nf,),
                  ambient=(k, 4), diffuse=(k, 4), specular=(k, 4),
                  shininess=(k,), optical_density=(k,), alpha=(k,),
                  tex_id=(k,), bbmin=(2 * n, 3), bbmax=(2 * n, 3),
                  entry=(2 * n,), skip=(2 * n,))
    shapes[name] = shape
    tensors = {k: torch.zeros(s, dtype=torch.int32 if k in INT_INPUTS
                              else torch.float32)
               for k, s in shapes.items()}
    before = pack_cuda.launches
    with pytest.raises(ValueError, match=name):
        pack_cuda.pack(tensors)
    assert pack_cuda.launches == before


# ---------------------------------------------------------------- the card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _plain():
    """Within it, every build packs on the plain path."""
    return mock.patch.object(pack_cuda, "engages", return_value=False)


def _assert_same_bits(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if got.dtype.is_floating_point:
        gn, wn = torch.isnan(got), torch.isnan(want)
        assert torch.equal(gn, wn), what
        got, want = got[~gn].view(torch.int32), want[~wn].view(torch.int32)
    assert torch.equal(got, want), what


def _materials(dev, nmat):
    """Material arrays apart in every channel, texture ids -1, 0, 1, 2
    in turn (three textures of three sizes in one padded stack)."""
    from raytracebvh_tpu_torch.core.types import Materials, stack_textures

    g = torch.Generator(device="cpu").manual_seed(5)
    r = lambda *s: torch.rand(*s, generator=g).to(dev)
    stack, hw = stack_textures([
        (np.random.default_rng(4).integers(0, 256, s + (4,)) / 255.0)
        .astype(np.float32) for s in ((64, 64), (16, 40), (8, 8))])
    mats = Materials(
        ambient=r(nmat, 4) * 0.2, diffuse=r(nmat, 4), specular=r(nmat, 4),
        shininess=r(nmat) * 999.0 + 1.0, optical_density=r(nmat) * 2.0,
        alpha=r(nmat) * 0.5 + 0.5,
        tex_id=(torch.arange(nmat, dtype=torch.int32) % 4 - 1).to(dev))
    return mats, torch.from_numpy(stack).to(dev), torch.from_numpy(hw).to(dev)


def _with_materials(scene, nmat, dev):
    mats, textures, tex_hw = _materials(dev, nmat)
    nf = scene.num_faces
    mat_index = (torch.arange(nf, dtype=torch.int32, device=dev) * 7
                 % nmat).to(torch.int32)
    return dataclasses.replace(scene, materials=mats, textures=textures,
                               tex_hw=tex_hw, mat_index=mat_index)


def _random(dev, num_tris=300):
    """Random triangles (every corner its own vertex) on eight materials,
    with three degenerate faces: a point and two lines."""
    from raytracebvh_tpu_torch.models.procedural import random_triangles

    scene = random_triangles(num_tris, seed=3, device=dev)
    verts = scene.verts.clone()
    verts[0:3] = verts[0]
    verts[3:6] = verts[3]
    verts[5] = verts[3] + 1.0
    verts[9:12] = verts[9] + torch.arange(3, device=dev)[:, None] * 0.5
    return _with_materials(dataclasses.replace(scene, verts=verts), 8, dev)


def _shared(dev):
    """sphere_grid's spheres with their corners merged into shared
    vertices (one vertex a distinct position, normal and uv)."""
    from raytracebvh_tpu_torch.models.procedural import sphere_grid

    scene = sphere_grid(2, 2, subdiv=6, device=dev)
    rows = torch.cat([scene.verts, scene.normals, scene.uv], 1)
    uniq, inverse = torch.unique(rows, dim=0, return_inverse=True)
    assert uniq.shape[0] < rows.shape[0] // 2
    scene = dataclasses.replace(
        scene, verts=uniq[:, 0:3].contiguous(),
        normals=uniq[:, 3:6].contiguous(), uv=uniq[:, 6:8].contiguous(),
        indices=inverse[scene.indices.long()].to(torch.int32))
    return _with_materials(scene, 5, dev)


def _tetra(dev):
    """The SPD tetra at size factor 4 (1 024 faces, every corner its own
    vertex), on one material, as the benchmark's tetra1m at a test size."""
    from raytracebvh_tpu_torch.core.types import Scene
    from rtbench.scenes_spd import sierpinski_tetra

    verts, normals, uv, _, mat_index = sierpinski_tetra(4, 40.0, 1, dev)
    nf = mat_index.shape[0]
    mats, textures, tex_hw = _materials(dev, 1)
    return Scene(verts=verts.float(), normals=normals.float(),
                 uv=uv.float(), indices=torch.arange(
                     3 * nf, dtype=torch.int32, device=dev),
                 mat_index=mat_index.to(torch.int32), materials=mats,
                 textures=textures, tex_hw=tex_hw)


SCENES = {"random300": _random, "random100": lambda d: _random(d, 100),
          "shared_vertices": _shared, "spd_tetra": _tetra}


def _builds(scene, cfg, dev):
    """(the kernel's BVH, the plain pack's) of one frame's build."""
    from raytracebvh_tpu_torch import Camera

    cam = Camera.default(dev)
    with torch.no_grad():
        before = pack_cuda.launches
        got = pipeline.frame_inputs(scene, cam, cfg)[0]
        assert pack_cuda.launches - before == 1
        with _plain():
            want = pipeline.frame_inputs(scene, cam, cfg)[0]
        assert pack_cuda.launches - before == 1
    return got, want


@pytest.mark.gpu
@pytest.mark.parametrize("sort,pad", [("lax", 256), ("bitonic", 256),
                                      ("lax", 37)])
@pytest.mark.parametrize("name", list(SCENES))
def test_build_equals_plain(dev, name, sort, pad):
    """Every BVH field and both K1 tables, bit for bit; the kernel's
    tables are the ones the walks take (``with_tables`` keeps them).  A
    leaf count padded to a multiple of 37 ends in a part of a warp."""
    scene = SCENES[name](dev)
    cfg = RenderConfig(width=32, height=32, ortho_scale=1.2,
                       sort_backend=sort, leaf_pad_multiple=pad)
    got, want = _builds(scene, cfg, dev)
    n = got.n_leaves
    assert n % pad == 0 and n >= scene.num_faces
    if scene.num_faces < n:  # padding leaves: face 0's row
        pad = want.prim < 0
        assert bool(pad.any())
        first = want.leaf_attrs[(want.prim == 0).nonzero()[0, 0]]
        assert torch.equal(got.leaf_attrs[pad],
                           first.expand(int(pad.sum()), -1))
    for f in dataclasses.fields(want):
        if f.name not in ("node_table", "leaf_table"):
            _assert_same_bits(getattr(got, f.name), getattr(want, f.name),
                              f.name)
    assert want.node_table is None
    nodes, leaves = traverse_cuda.pack_tables(want)
    _assert_same_bits(got.node_table, nodes, "node_table")
    _assert_same_bits(got.leaf_table, leaves, "leaf_table")
    assert traverse_cuda.with_tables(got) is got
    assert len(set(want.tri_mat.tolist())) == min(
        scene.materials.count, scene.num_faces)


# the benchmark's frame traffic (rtbench/traffic/*.json) at 128x96
FRAMES = {
    "frame_shadows": dict(bounces=0, enable_shadows=True, ray_tile=16),
    "frame_onchip": dict(bounces=1, enable_shadows=True, ray_tile=16,
                         texture_dtype="uint8", traversal_backend="shared",
                         shade_gather_backend="shared",
                         sort_backend="bitonic"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["random300", "spd_tetra"])
@pytest.mark.parametrize("traffic", list(FRAMES))
def test_frames_equal_plain_eager_and_graphed(dev, traffic, name):
    """render_frame and render_frame_jit on the kernel pack give the
    plain pack's frame, bit for bit; the eager frame launches the kernel
    once, a capture at least once (its warm-up and its body), a replay
    never."""
    import raytracebvh_tpu_torch as T

    scene, cam = SCENES[name](dev), T.Camera.default(dev)
    cfg = RenderConfig(**dict(dict(width=128, height=96, ortho_scale=1.2,
                                   light_pos=(10.0, 80.0, -40.0)),
                              **FRAMES[traffic]))
    with torch.no_grad():
        with _plain():
            want = T.render_frame(scene, cam, cfg)
        before = pack_cuda.launches
        got = T.render_frame(scene, cam, cfg)
        assert pack_cuda.launches - before == 1
        pipeline.FRAME_GRAPHS.clear()
        before = pack_cuda.launches
        graphed = T.render_frame_jit(scene, cam, cfg)
        assert pack_cuda.launches > before
        before = pack_cuda.launches
        replayed = T.render_frame_jit(scene, cam, cfg)
        torch.cuda.synchronize()
        assert pack_cuda.launches == before
        pipeline.FRAME_GRAPHS.clear()
    for img, what in ((got, "eager"), (graphed, "graphed"),
                      (replayed, "replayed")):
        _assert_same_bits(img, want, what)


@pytest.mark.gpu
@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
def test_steps_keep_the_plain_pack(dev, chunked):
    """The training step differentiates its build (the moved vertices,
    the learned colours): neither the eager step nor train_step_jit's
    capture launches the kernel, chunked or not."""
    from raytracebvh_tpu_torch import Camera
    from raytracebvh_tpu_torch.models import inverse

    scene, cam = _random(dev), Camera.default(dev)
    cfg = RenderConfig(width=64, height=48, bounces=1, ortho_scale=1.2,
                       ray_tile=16, texture_dtype="uint8",
                       ray_chunk=768 if chunked else 0)
    target = torch.zeros((cfg.height, cfg.width, 4), device=dev)
    params, params_jit = inverse.init_params(scene), inverse.init_params(scene)
    before = pack_cuda.launches
    inverse.train_step(params, inverse.make_optimizer(params), scene, cam,
                       target, cfg)
    inverse.train_step_jit(params_jit, inverse.make_optimizer(
        params_jit, capturable=True), scene, cam, target, cfg)
    torch.cuda.synchronize()
    assert pack_cuda.launches == before
