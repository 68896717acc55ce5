"""The port's OBJ/MTL/BMP loaders against the JAX package's pure-Python
route, on a generated OBJ + MTL + BMP.  Tolerance: exact equality (the
same parser and the same float32 conversions)."""

import numpy as np
import pytest

from raytracebvh_tpu.io import bmp as j_bmp
from raytracebvh_tpu.io.obj import load_obj as j_load_obj
from raytracebvh_tpu_torch.io import bmp as t_bmp
from raytracebvh_tpu_torch.io.obj import load_obj as t_load_obj
from raytracebvh_tpu_torch.utils.assets import find_asset


def _write_scene(d, rng):
    tex = rng.integers(0, 256, (6, 10, 3)).astype(np.uint8)
    j_bmp.write_bmp(str(d / "tex.bmp"), tex)
    (d / "scene.mtl").write_text(
        "newmtl red\nKa 0.1 0.0 0.0\nKd 0.9 0.1 0.1\nKs 1 1 1\nNs 250\n"
        "Ni 1.5\nd 0.75\nmap_Kd tex.bmp\n"
        "newmtl plain\nKd 0.2 0.8 0.3\n")
    lines = ["mtllib scene.mtl"]
    pts = rng.normal(0, 5, (30, 3))
    lines += [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in pts]
    lines += [f"vt {u:.5f} {v:.5f}" for u, v in rng.uniform(0, 1, (20, 2))]
    lines += [f"vn {x:.4f} {y:.4f} {z:.4f}" for x, y, z in rng.normal(size=(10, 3))]
    for k in range(40):
        if k % 15 == 0:
            lines.append("usemtl " + ("red" if k % 2 == 0 else "plain"))
        c = rng.integers(1, 31, 3)
        t = rng.integers(1, 21, 3)
        n = rng.integers(1, 11, 3)
        # a negative (relative) index now and then
        lines.append("f " + " ".join(
            f"{c[i] - 31 if (k + i) % 7 == 0 else c[i]}/{t[i]}/{n[i]}"
            for i in range(3)))
    (d / "scene.obj").write_text("\n".join(lines) + "\n")
    return d / "scene.obj", tex


def test_load_obj_matches_jax(tmp_path):
    path, _ = _write_scene(tmp_path, np.random.default_rng(0))
    js = j_load_obj(str(path), backend="python")
    ts = t_load_obj(str(path))
    for f in ("verts", "normals", "uv", "indices", "mat_index", "textures",
              "tex_hw"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    for f in ("ambient", "diffuse", "specular", "shininess",
              "optical_density", "alpha", "tex_id"):
        np.testing.assert_array_equal(getattr(ts.materials, f).numpy(),
                                      np.asarray(getattr(js.materials, f)),
                                      err_msg=f)
    assert ts.materials.tex_id.tolist() == [0, -1]


def test_bmp_bytes_and_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (7, 13, 4)).astype(np.float32)
    j_bmp.write_bmp(str(tmp_path / "j.bmp"), img)
    t_bmp.write_bmp(str(tmp_path / "t.bmp"), img)
    assert (tmp_path / "j.bmp").read_bytes() == (tmp_path / "t.bmp").read_bytes()
    np.testing.assert_array_equal(t_bmp.read_bmp(str(tmp_path / "t.bmp")),
                                  j_bmp.read_bmp(str(tmp_path / "j.bmp")))


def test_bad_faces_raise(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n")
    with pytest.raises(ValueError, match="non-triangle"):
        t_load_obj(str(p))
    p.write_text("v 0 0 0\nf 1 2 3\n")
    with pytest.raises(ValueError, match="out of range"):
        t_load_obj(str(p))


def test_find_asset_falls_back_to_none():
    assert find_asset("no-such-asset.obj") is None
