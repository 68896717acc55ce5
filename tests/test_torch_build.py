"""The port's build stages against the JAX package, stage by stage.

Every stage gets the JAX package's own upstream arrays, so a fault shows
in the stage that has it.  Tolerance: exact equality throughout (integer
stages, and float stages that are the same operations in the same
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracebvh_tpu as J
from raytracebvh_tpu.camera import camera_matrices as j_camera_matrices
from raytracebvh_tpu.camera import transform_normals as j_transform_normals
from raytracebvh_tpu.camera import transform_points as j_transform_points
from raytracebvh_tpu.core.types import scene_to_device
from raytracebvh_tpu.models import procedural as j_proc
from raytracebvh_tpu.ops import bvh as j_bvh
from raytracebvh_tpu.ops import morton as j_morton
from raytracebvh_tpu.ops import sort as j_sort
from raytracebvh_tpu.pipeline import assemble_bvh as j_assemble_bvh
from raytracebvh_tpu.pipeline import build_bvh as j_build_bvh
import raytracebvh_tpu_torch as T
from raytracebvh_tpu_torch.core.types import scene_from_numpy
from raytracebvh_tpu_torch.models import procedural as t_proc
from raytracebvh_tpu_torch.ops import bvh as t_bvh
from raytracebvh_tpu_torch.ops import morton as t_morton
from raytracebvh_tpu_torch.ops import sort as t_sort
from raytracebvh_tpu_torch.pipeline import assemble_bvh as t_assemble_bvh
from raytracebvh_tpu_torch.pipeline import build_bvh as t_build_bvh

SCENES = {
    "random300": lambda m, **kw: m.random_triangles(300, seed=4,
                                                    with_texture=True, **kw),
    "spheres": lambda m, **kw: m.sphere_grid(nx=2, ny=2, subdiv=5, **kw),
}
BVH_FIELDS = ("codes", "prim", "bbmin", "bbmax", "child_l", "child_r",
              "parent", "entry_link", "skip_link", "tri_verts",
              "tri_normals", "tri_uv", "tri_mat", "leaf_attrs")


def _np(x):
    a = np.asarray(x)
    return a.astype(np.int32) if a.dtype == np.uint32 else a


def _t(a):
    return torch.from_numpy(np.array(_np(a)))


def _scenes(name):
    return SCENES[name](j_proc), SCENES[name](t_proc, device="cpu")


def _assert_scene_equal(js, ts):
    for f in ("verts", "normals", "uv", "indices", "mat_index", "textures",
              "tex_hw"):
        np.testing.assert_array_equal(_np(getattr(js, f)),
                                      getattr(ts, f).numpy(), err_msg=f)
    for f in ("ambient", "diffuse", "specular", "shininess",
              "optical_density", "alpha", "tex_id"):
        np.testing.assert_array_equal(_np(getattr(js.materials, f)),
                                      getattr(ts.materials, f).numpy(),
                                      err_msg=f)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_procedural_scenes_equal(name):
    _assert_scene_equal(*_scenes(name))


def test_scene_from_numpy_takes_jax_scene():
    js = j_proc.random_triangles(20, seed=1)
    _assert_scene_equal(js, scene_from_numpy(js, "cpu"))


def test_carry_across_functions_default_to_the_card(tmp_path):
    """scene_from_numpy, materials_from_numpy, camera_from_numpy,
    bvh_from_numpy, Camera.default, the scene constructors
    (random_triangles, sphere_grid, load_obj), reference_rays and
    optimizer_from_numpy (an optax.adam state into torch.optim.Adam) put
    their tensors on the CUDA device unless asked for another: without one
    they raise rather than return CPU tensors.  With device="cpu" they
    equal the JAX arrays exactly."""
    from raytracebvh_tpu.camera import reference_rays as j_reference_rays
    from raytracebvh_tpu_torch.camera import reference_rays
    from raytracebvh_tpu_torch.core import types as tt
    from raytracebvh_tpu_torch.io.obj import load_obj

    obj = tmp_path / "tri.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    js = j_proc.random_triangles(20, seed=1)
    jc = J.Camera.default()
    jb = j_build_bvh(scene_to_device(js), *j_camera_matrices(jc, 16, 16),
                     J.RenderConfig(width=16, height=16))
    calls = {"scene": lambda **kw: tt.scene_from_numpy(js, **kw),
             "materials": lambda **kw: tt.materials_from_numpy(js.materials,
                                                               **kw),
             "camera": lambda **kw: tt.camera_from_numpy(jc, **kw),
             "bvh": lambda **kw: tt.bvh_from_numpy(jb, **kw),
             "default camera": lambda **kw: T.Camera.default(**kw),
             "random_triangles": lambda **kw: t_proc.random_triangles(
                 20, seed=1, **kw),
             "sphere_grid": lambda **kw: t_proc.sphere_grid(1, 1, 2, **kw),
             "load_obj": lambda **kw: load_obj(str(obj), **kw),
             "reference_rays": lambda **kw: reference_rays(16, 8, 4.0, **kw)}
    for name, call in calls.items():
        if torch.cuda.is_available():
            out = call()
            assert all(v.device.type == "cuda" for v in vars(out).values()
                       if isinstance(v, torch.Tensor)), name
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()
    _assert_scene_equal(js, tt.scene_from_numpy(js, device="cpu"))
    _assert_scene_equal(js, t_proc.random_triangles(20, seed=1, device="cpu"))
    assert load_obj(str(obj), device="cpu").verts.device.type == "cpu"
    for jcam, tcam in ((jc, T.Camera.default(device="cpu")),
                       (jc, tt.camera_from_numpy(jc, device="cpu"))):
        for f in ("eye", "at", "up", "fov", "near", "far"):
            np.testing.assert_array_equal(np.asarray(getattr(jcam, f)),
                                          getattr(tcam, f).numpy(), f)
    jr, tr = j_reference_rays(16, 8, 4.0), reference_rays(16, 8, 4.0,
                                                          device="cpu")
    for f in ("origin", "direction"):
        np.testing.assert_array_equal(np.asarray(getattr(jr, f)),
                                      getattr(tr, f).numpy(), f)
    tb = tt.bvh_from_numpy(jb, device="cpu")
    for f in BVH_FIELDS:
        np.testing.assert_array_equal(_np(getattr(jb, f)),
                                      getattr(tb, f).numpy(), f)

    # the optimizer state: an optax.adam state into torch.optim.Adam
    import optax
    from raytracebvh_tpu.models import inverse as ji
    from raytracebvh_tpu_torch.models import inverse as ti

    rng = np.random.default_rng(4)
    jp = ji.init_params(scene_to_device(js))
    moment = lambda: ji.InverseParams(*(
        rng.uniform(0, 1, np.shape(x)).astype(np.float32) for x in jp))
    jstate = (optax.ScaleByAdamState(count=np.int32(3), mu=moment(),
                                     nu=moment()), optax.EmptyState())
    if torch.cuda.is_available():
        opt = ti.optimizer_from_numpy(ti.params_from_numpy(jp), jstate)
        assert all(t.device.type == "cuda" for st in opt.state.values()
                   for k, t in st.items() if k != "step")
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            ti.optimizer_from_numpy(ti.params_from_numpy(jp, "cpu"), jstate)
    params = ti.params_from_numpy(jp, "cpu")
    opt = ti.optimizer_from_numpy(params, jstate, device="cpu")
    for f, p in zip(ti.InverseParams._fields, params):
        st = opt.state[p]
        assert float(st["step"]) == 3.0
        np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                      getattr(jstate[0].mu, f), f)
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                      getattr(jstate[0].nu, f), f)


def test_clz32_every_bit_position():
    xs = [0] + [1 << k for k in range(32)] + [(1 << k) | 1 for k in range(1, 32)]
    xs += [(1 << (k + 1)) - 1 for k in range(32)]  # all bits below k set
    want = [32] + [31 - k for k in range(32)] + [31 - k for k in range(1, 32)]
    want += [31 - k for k in range(32)]
    got = t_bvh._clz32(torch.tensor(xs, dtype=torch.int64))
    np.testing.assert_array_equal(got.numpy(), np.array(want))
    # and as the JAX build computes it (int32 bit patterns)
    j = j_bvh._clz32(jnp.asarray(np.array(xs, np.uint64).astype(np.uint32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j))
    i32 = torch.tensor(np.array(xs, np.uint64).astype(np.uint32).view(np.int32))
    np.testing.assert_array_equal(t_bvh._clz32(i32).numpy(), np.array(want))


def test_morton_codes_equal():
    rng = np.random.default_rng(0)
    p = rng.uniform(-0.1, 1.1, (2000, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        t_morton.morton_code(torch.from_numpy(p)).numpy(),
        _np(j_morton.morton_code(jnp.asarray(p))))
    v = rng.integers(0, 1 << 12, 4096)
    np.testing.assert_array_equal(
        t_morton.expand_bits10(torch.from_numpy(v)).numpy(),
        _np(j_morton.expand_bits10(jnp.asarray(v, jnp.uint32))))


def _jax_stage_inputs(js, cfg):
    """verts_t / normals_t / per-face leaf data as the JAX build makes
    them, for the default camera at cfg's frame size."""
    jscene = scene_to_device(js)
    wvp, wv = j_camera_matrices(J.Camera.default(), cfg.width, cfg.height)
    verts_t = j_transform_points(jscene.verts, wvp)
    normals_t = j_transform_normals(jscene.normals, wv)
    smin, smax = j_morton.scene_aabb(verts_t)
    codes, lmin, lmax, cen = j_morton.triangle_leaves(
        verts_t, jscene.indices, smin, smax)
    return jscene, wvp, wv, verts_t, normals_t, smin, smax, codes, lmin, lmax, cen


@pytest.mark.parametrize("name", sorted(SCENES))
def test_triangle_leaves_equal(name):
    js, ts = _scenes(name)
    cfg = J.RenderConfig(width=32, height=32)
    _, _, _, verts_t, _, smin, smax, codes, lmin, lmax, cen = \
        _jax_stage_inputs(js, cfg)
    got = t_morton.triangle_leaves(_t(verts_t), ts.indices, _t(smin), _t(smax))
    for g, w in zip(got, (codes, lmin, lmax, cen)):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    gmin, gmax = t_morton.scene_aabb(_t(verts_t))
    np.testing.assert_array_equal(gmin.numpy(), _np(smin))
    np.testing.assert_array_equal(gmax.numpy(), _np(smax))


def test_sort_order_equal_with_duplicates():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 64, 1000).astype(np.uint32)  # many ties
    js, jo = j_sort.sort_by_code(jnp.asarray(codes))
    ts, to = t_sort.sort_by_code(torch.from_numpy(codes.astype(np.int32)))
    np.testing.assert_array_equal(ts.numpy(), _np(js))
    np.testing.assert_array_equal(to.numpy(), _np(jo))
    assert to.dtype == torch.int32


@pytest.mark.parametrize("seed,n,span", [(0, 256, 1 << 30), (1, 512, 40),
                                         (2, 768, 1 << 12)])
def test_topology_and_links_equal(seed, n, span):
    """Sorted codes (ties included, span 40) -> the same children,
    parents, ranges and links as the JAX build_topology (its RMQ emit)."""
    rng = np.random.default_rng(seed)
    codes = np.sort(rng.integers(0, span, n)).astype(np.uint32)
    jt = jax.jit(j_bvh.build_topology)(jnp.asarray(codes))
    tt = t_bvh.build_topology(torch.from_numpy(codes.astype(np.int32)))
    for f in jt._fields:
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      _np(getattr(jt, f)), err_msg=f)
    # the links' scatter relies on unique right-child range starts
    # (torch index_put with duplicates is nondeterministic on CUDA)
    starts = tt.node_lo[tt.child_r[n:-1].long()]
    assert torch.unique(starts).numel() == n - 1
    je, js_ = jax.jit(j_bvh.compute_links, static_argnums=1)(jt, n)
    te, ts_ = t_bvh.compute_links(tt, n)
    np.testing.assert_array_equal(te.numpy(), _np(je))
    np.testing.assert_array_equal(ts_.numpy(), _np(js_))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_fit_aabbs_equal(name):
    js, _ = _scenes(name)
    jb = jax.jit(lambda s: j_build_bvh(
        s, *j_camera_matrices(J.Camera.default(), 32, 32),
        J.RenderConfig(width=32, height=32)))(scene_to_device(js))
    topo = t_bvh.build_topology(_t(jb.codes))
    n = jb.n_leaves
    lmin, lmax = _t(jb.bbmin[:n]), _t(jb.bbmax[:n])
    bbmin, bbmax = t_bvh.fit_aabbs(topo.node_lo, topo.node_hi, lmin, lmax)
    np.testing.assert_array_equal(bbmin.numpy(), _np(jb.bbmin))
    np.testing.assert_array_equal(bbmax.numpy(), _np(jb.bbmax))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_assemble_bvh_equal(name):
    """JAX's transformed vertices and leaf data -> the port's assemble_bvh
    gives the JAX BVH field for field, leaf_attrs channel for channel."""
    js, ts = _scenes(name)
    jcfg = J.RenderConfig(width=32, height=32)
    jscene, _, _, verts_t, normals_t, _, _, codes, lmin, lmax, _ = \
        _jax_stage_inputs(js, jcfg)
    jb = jax.jit(lambda *a: j_assemble_bvh(*a, jcfg))(
        jscene, verts_t, normals_t, codes, lmin, lmax)
    tb = t_assemble_bvh(ts, _t(verts_t), _t(normals_t), _t(codes), _t(lmin),
                        _t(lmax), T.RenderConfig(width=32, height=32))
    for f in BVH_FIELDS:
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      _np(getattr(jb, f)), err_msg=f)
    assert tb.leaf_attrs.shape == (jb.n_leaves, 40)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_bvh_end_to_end_equal(name):
    js, ts = _scenes(name)
    wvp, wv = j_camera_matrices(J.Camera.default(), 48, 32)
    # eager, op by op: under jit XLA fuses the vertex transform and may
    # contract it into FMAs, which the port (like PyTorch) never does
    jb = j_build_bvh(scene_to_device(js), wvp, wv,
                     J.RenderConfig(width=48, height=32))
    tb = t_build_bvh(ts, _t(wvp), _t(wv), T.RenderConfig(width=48, height=32))
    for f in BVH_FIELDS:
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      _np(getattr(jb, f)), err_msg=f)


def test_bvh_from_numpy_round_trip():
    from raytracebvh_tpu_torch.core.types import bvh_from_numpy

    js, _ = _scenes("random300")
    jb = jax.jit(lambda s: j_build_bvh(
        s, *j_camera_matrices(J.Camera.default(), 16, 16),
        J.RenderConfig(width=16, height=16)))(scene_to_device(js))
    tb = bvh_from_numpy(jb, "cpu")
    assert tb.codes.dtype == torch.int32 and tb.n_leaves == jb.n_leaves
    for f in BVH_FIELDS:
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      _np(getattr(jb, f)), err_msg=f)
