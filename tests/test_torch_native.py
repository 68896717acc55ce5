"""The port's native asset runtime (``native.py``, its own build of
``native/rtbvh_native.cpp``) against the port's pure-Python routes, on a
generated OBJ + MTL + BMP.  Tolerance: exact (bit-equal scenes).  Skips
where there is no g++."""

import shutil

import numpy as np
import pytest

from raytracebvh_tpu.io.obj import load_obj as j_load_obj
from raytracebvh_tpu_torch import _kernels, native
from raytracebvh_tpu_torch.io.obj import load_obj, write_obj
from raytracebvh_tpu_torch.models.procedural import random_triangles

SCENE_FIELDS = ("verts", "normals", "uv", "indices", "mat_index", "textures",
                "tex_hw")
MAT_FIELDS = ("ambient", "diffuse", "specular", "shininess",
              "optical_density", "alpha", "tex_id")


@pytest.fixture
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native library cannot be built")
    assert native.available()
    return native.get_lib()


def _assert_scenes_equal(a, b):
    for f in SCENE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), f)
    for f in MAT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a.materials, f)),
                                      np.asarray(getattr(b.materials, f)), f)


def test_native_loader_equals_python_loader(lib, tmp_path):
    scene = random_triangles(150, seed=9, with_texture=True, alpha=0.6,
                             optical_density=1.3, device="cpu")
    path = write_obj(scene, str(tmp_path))
    got = load_obj(path, backend="native", device="cpu")
    want = load_obj(path, backend="python", device="cpu")
    _assert_scenes_equal(got, want)
    assert bool((got.materials.tex_id >= 0).all())  # the texture was read
    _assert_scenes_equal(got, load_obj(path, device="cpu"))
    # and the JAX package's Python parser
    j = j_load_obj(path, backend="python")
    for f in SCENE_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(j, f)), f)


def test_load_obj_backends(lib, tmp_path):
    """'native' raises where the native parser refuses a file (relative
    face indices), 'auto' then parses it in Python; an unknown backend
    raises."""
    p = tmp_path / "rel.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n")
    with pytest.raises(OSError):
        load_obj(str(p), backend="native", device="cpu")
    _assert_scenes_equal(load_obj(str(p), device="cpu"),
                         load_obj(str(p), backend="python", device="cpu"))
    with pytest.raises(ValueError, match="backend"):
        load_obj(str(p), backend="cpp", device="cpu")


def test_library_is_built_beside_the_kernels(lib):
    """The port's copy lives in its build directory, named by the
    source's hash; nothing is written into native/."""
    path = native.library_path()
    assert path.parent == _kernels.BUILD_DIR and path.is_file()
    assert path.name.startswith("librtbvh_native_")
