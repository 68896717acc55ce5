"""The port's depth reference image (``ref/refimage.py``) against the
JAX package's on the CPU.

Tolerance: the golden's (``tests/test_reference_image.py``): at least
99.9% of pixels exact and no channel off by more than 1 on the uint8
depth (a distance within an ulp of an integer may truncate either way
under XLA's FMAs); the hit masks exactly.  ``compare_images`` exactly.
"""

import os

import numpy as np
import pytest

from raytracebvh_tpu.core.types import scene_to_device
from raytracebvh_tpu.io.obj import load_obj as j_load_obj
from raytracebvh_tpu.models.procedural import random_triangles as j_random
from raytracebvh_tpu.ref import refimage as jref
from raytracebvh_tpu_torch.io.obj import load_obj as t_load_obj
from raytracebvh_tpu_torch.models.procedural import random_triangles as t_random
from raytracebvh_tpu_torch.ref import refimage as tref
from raytracebvh_tpu_torch.utils.assets import find_asset


def _assert_depth_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    miss_g = (got == tref.MISS_RGB).all(-1)
    miss_w = (want == jref.MISS_RGB).all(-1)
    np.testing.assert_array_equal(miss_g, miss_w)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert float((diff == 0).mean()) >= 0.999
    assert int(diff.max()) <= 1


@pytest.mark.parametrize("size,stride,scene_kw", [
    ((32, 32), 1, dict(extent=10.0, tri_size=2.0)),  # ~72% of pixels hit
    ((48, 40), 2, dict(extent=50.0, tri_size=4.0)),
])
def test_depth_image_matches_jax(size, stride, scene_kw):
    w, h = size
    want = jref.render_depth_bmp(
        scene_to_device(j_random(150, seed=4, **scene_kw)), w, h, stride)
    got = tref.render_depth_bmp(t_random(150, seed=4, device="cpu",
                                         **scene_kw), w, h, stride)
    assert got.shape == (h // stride, w // stride, 3)
    hits = ~(got == tref.MISS_RGB).all(-1)
    assert 0.05 < hits.mean() < 0.95
    _assert_depth_close(got, want)


def test_compare_images_like_jax():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (20, 24, 3), np.uint8)
    b = a.copy()
    b[:5] = tref.MISS_RGB
    b[7, 3] += 9
    for x, y in ((a, b), (a, a), (b, a)):
        assert tref.compare_images(x, y) == jref.compare_images(x, y)
    np.testing.assert_array_equal(tref.MISS_RGB, jref.MISS_RGB)


def test_depth_image_of_test_obj_matches_jax():
    path = find_asset("Test.obj")
    if path is None:
        pytest.skip("Test.obj asset not available")
    want = jref.render_depth_bmp(
        scene_to_device(j_load_obj(path, backend="python")), 500, 500,
        stride=4)
    got = tref.render_depth_bmp(t_load_obj(path, device="cpu"), 500, 500,
                                stride=4)
    _assert_depth_close(got, want)
    golden = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                                  "depth_self_golden.npz"))["img"]
    _assert_depth_close(got, golden)
