"""The port's camera matrices, rays and ray tiling against the JAX
package.  Tolerances: the default camera's matrices and the
orthographic rays exactly equal.  An orbited camera's matrices within
rtol 1e-6 (a few ulp): the JAX package's vector norm is a jitted
``jnp.linalg.norm``, whose sum XLA may contract into FMAs, where the port
rounds every product.  Pinhole rays within rtol 1e-6 for the same
reason.  The tilings are permutations and must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracebvh_tpu as J
from raytracebvh_tpu import camera as j_cam
import raytracebvh_tpu_torch as T
from raytracebvh_tpu_torch import camera as t_cam
from raytracebvh_tpu_torch.core.types import camera_from_numpy


def _cams(yaw):
    jc, tc = J.Camera.default(), T.Camera.default()
    if yaw:
        jc, tc = j_cam.orbit(jc, yaw, 0.05), t_cam.orbit(tc, yaw, 0.05)
    return jc, tc


@pytest.mark.parametrize("yaw", [0.0, 0.3])
@pytest.mark.parametrize("size", [(48, 32), (1920, 1080)])
def test_camera_matrices_equal(yaw, size):
    jc, tc = _cams(yaw)
    np.testing.assert_array_equal(tc.eye.numpy(), np.asarray(jc.eye))
    jw, jv = j_cam.camera_matrices(jc, *size)
    tw, tv = t_cam.camera_matrices(tc, *size)
    if yaw == 0.0:
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    else:
        for got, want in ((tw, jw), (tv, jv)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())


def test_camera_from_numpy_and_transforms():
    jc, _ = _cams(0.2)
    tc = camera_from_numpy(jc)
    np.testing.assert_array_equal(tc.eye.numpy(), np.asarray(jc.eye))
    # the same matrices into both transforms
    jw, jv = j_cam.camera_matrices(jc, 64, 48)
    tw, tv = torch.from_numpy(np.array(jw)), torch.from_numpy(np.array(jv))
    rng = np.random.default_rng(0)
    p = rng.normal(0.0, 30.0, (300, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        t_cam.transform_points(torch.from_numpy(p), tw).numpy(),
        np.asarray(j_cam.transform_points(jnp.asarray(p), jw)))
    np.testing.assert_array_equal(
        t_cam.transform_normals(torch.from_numpy(p), tv).numpy(),
        np.asarray(j_cam.transform_normals(jnp.asarray(p), jv)))


@pytest.mark.parametrize("w,h,scale", [(48, 32, 4.0), (33, 17, 256.0)])
def test_reference_and_perspective_rays(w, h, scale):
    jr = j_cam.reference_rays(w, h, scale)
    tr = t_cam.reference_rays(w, h, scale)
    np.testing.assert_array_equal(tr.origin.numpy(), np.asarray(jr.origin))
    np.testing.assert_array_equal(tr.direction.numpy(),
                                  np.asarray(jr.direction))
    jc, tc = _cams(0.1)
    jp = j_cam.perspective_rays(jc, w, h)
    tp = t_cam.perspective_rays(tc, w, h)
    np.testing.assert_allclose(tp.origin.numpy(), np.asarray(jp.origin))
    np.testing.assert_allclose(tp.direction.numpy(), np.asarray(jp.direction),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("order", ["row", "col"])
def test_tile_untile_equal(order):
    w, h, tile = 64, 24, 16
    th, tw = t_cam.structured_tile_shape(w, h, tile)
    assert (th, tw) == j_cam.structured_tile_shape(w, h, tile) == (8, 16)
    assert t_cam.structured_tile_shape(1920, 1080, 16) == (8, 16)
    x = np.arange(w * h, dtype=np.int32)
    tiled = t_cam.tile_flat(torch.from_numpy(x), w, h, th, tw, order)
    np.testing.assert_array_equal(
        tiled.numpy(), np.asarray(j_cam.tile_flat(jnp.asarray(x), w, h, th,
                                                  tw, order)))
    back = t_cam.untile_flat(tiled, w, h, th, tw, order)
    np.testing.assert_array_equal(back.numpy(), x)
    jr = j_cam.tile_rays(j_cam.reference_rays(w, h, 4.0), w, h, th, tw, order)
    tr = t_cam.tile_rays(t_cam.reference_rays(w, h, 4.0), w, h, th, tw, order)
    np.testing.assert_array_equal(tr.origin.numpy(), np.asarray(jr.origin))


def test_tile_order_and_permute_equal():
    w, h, tile = 40, 28, 16  # does not divide: the permutation path
    assert t_cam.structured_tile_shape(w, h, tile) is None
    jp, ji = j_cam.tile_order(w, h, tile)
    tp, ti = t_cam.tile_order(w, h, tile)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(ti, ji)
    jr = j_cam.permute_rays(j_cam.reference_rays(w, h, 2.0), jnp.asarray(jp))
    tr = t_cam.permute_rays(t_cam.reference_rays(w, h, 2.0), tp)
    np.testing.assert_array_equal(tr.origin.numpy(), np.asarray(jr.origin))


@pytest.mark.parametrize("framing", ["bench_dense", "aimed"])
def test_dense_frame_window_on_sphere_grid(framing):
    """Triangles of the 3 072-tri sphere grid whose ray-space box meets
    the 1920x1080 orthographic window, counted through the JAX package's
    and the port's transforms (must be equal).  bench.py's dense config
    (default camera, ortho_scale 256) frames no triangle, so all
    2 073 600 primary rays miss; chip_smoke.py's dense frame (camera aimed
    at the sphere at (12.5, 0, 0), ortho_scale 27) frames some."""
    from raytracebvh_tpu.models.procedural import sphere_grid as j_grid
    from raytracebvh_tpu_torch.models.procedural import sphere_grid as t_grid

    w, h = 1920, 1080
    jc, tc = _cams(0.0)
    scale = 256.0
    if framing == "aimed":
        scale = 27.0
        eye, at = [12.5, 5.0, -100.0], [12.5, 0.0, 0.0]
        jc = jc.replace(eye=jnp.asarray(eye), at=jnp.asarray(at))
        tc = tc.replace(eye=torch.tensor(eye), at=torch.tensor(at))
    js, ts = j_grid(nx=4, ny=3, subdiv=8), t_grid(nx=4, ny=3, subdiv=8)
    x0, x1 = -(w // 2) / scale, (w - 1 - w // 2) / scale
    y0, y1 = -(h // 2) / scale, (h - 1 - h // 2) / scale

    def framed(v, idx):
        tri = np.asarray(v)[np.asarray(idx).reshape(-1, 3)]
        lo, hi = tri.min(1), tri.max(1)
        return int(((lo[:, 0] <= x1) & (hi[:, 0] >= x0)
                    & (lo[:, 1] <= y1) & (hi[:, 1] >= y0)).sum())

    jw, _ = j_cam.camera_matrices(jc, w, h)
    tw, _ = t_cam.camera_matrices(tc, w, h)
    nj = framed(j_cam.transform_points(jnp.asarray(js.verts), jw), js.indices)
    nt = framed(t_cam.transform_points(ts.verts, tw), ts.indices)
    assert nt == nj
    assert (nj == 0) == (framing == "bench_dense")


def test_unknown_tile_order_raises():
    x = torch.arange(64 * 24)
    with pytest.raises(ValueError, match="ray_tile_order"):
        t_cam.tile_flat(x, 64, 24, 8, 16, "diagonal")
    with pytest.raises(ValueError, match="ray_tile_order"):
        t_cam.untile_flat(x, 64, 24, 8, 16, "Row")
