"""The port's training CLI (``cli/train.py``) against the JAX package's
on the CPU: the same flags on the same temporary OBJ + MTL + BMP.

Tolerances: the two CLIs' checkpoints after two ``--self-target`` steps
agree leaf for leaf within atol 1e-5, ``tests/test_torch_inverse.py``'s
two-step tolerance (the JAX step is one jitted program whose FMAs move
the second gradient); ``count`` and ``step`` exactly.  The port's
resumed run equals its uninterrupted run bit for bit (the same
operations on the same CPU).
"""

import numpy as np
import pytest
import torch

from raytracebvh_tpu.cli import train as j_train
from raytracebvh_tpu_torch.cli import train as t_train
from raytracebvh_tpu_torch.io.obj import write_obj
from raytracebvh_tpu_torch.models.procedural import random_triangles

SIZE = ["--width", "32", "--height", "32"]


@pytest.fixture
def obj(tmp_path):
    # ~40% of a 32x32 frame under the CLI's default camera is hit
    scene = random_triangles(40, seed=11, extent=8.0, tri_size=2.0,
                             with_texture=True, device="cpu")
    return write_obj(scene, str(tmp_path))


def _leaves(path):
    with np.load(path) as z:
        return [z[f"leaf_{i}"] for i in range(len(z.files))]


def test_train_cli_checkpoint_matches_jax_cli(obj, tmp_path, capsys):
    args = ["--obj", obj, "--self-target", "--steps", "2", "--log-every",
            "1", *SIZE]
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    assert j_train.main([*args, "--ckpt", jpath]) == 0
    j_out = capsys.readouterr().out
    assert t_train.main([*args, "--ckpt", tpath, "--device", "cpu"]) == 0
    t_out = capsys.readouterr().out
    want, got = _leaves(jpath), _leaves(tpath)
    assert len(got) == len(want) == 11
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        if i in (3, 10):  # count, step
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5,
                                       err_msg=f"leaf {i}")
    # the same printed lines, the losses within the two-step tolerance
    j_lines, t_lines = j_out.splitlines(), t_out.splitlines()
    assert [ln.split()[:2] for ln in t_lines] == [
        ln.split()[:2] for ln in j_lines]
    for jl, tl in zip(j_lines[:2], t_lines[:2]):
        np.testing.assert_allclose(float(tl.split()[-1]),
                                   float(jl.split()[-1]), rtol=1e-4)
    # the offsets start from the JAX CLI's perturbation, so they moved
    # away from zero by it
    assert np.abs(got[0]).max() > 0.1


def test_train_cli_resume_equals_uninterrupted(obj, tmp_path, capsys):
    base = ["--obj", obj, "--self-target", "--log-every", "1", *SIZE,
            "--device", "cpu"]
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    out = str(tmp_path / "recon.bmp")
    assert t_train.main([*base, "--steps", "4", "--ckpt-every", "2",
                         "--ckpt", a, "--out", out]) == 0
    straight = capsys.readouterr().out.splitlines()
    assert t_train.main([*base, "--steps", "2", "--ckpt", b]) == 0
    capsys.readouterr()
    assert t_train.main([*base, "--steps", "4", "--ckpt", b]) == 0
    resumed = capsys.readouterr().out.splitlines()
    assert resumed[0] == f"resumed from {b} at step 2"
    assert resumed[1:3] == straight[2:4]  # steps 3/4 and 4/4, same losses
    assert straight[4].startswith("trained 4 steps in ")
    assert straight[5] == f"wrote {out}"
    losses = [float(ln.split()[-1]) for ln in straight[:4]]
    assert losses == sorted(losses, reverse=True)
    for x, y in zip(_leaves(a), _leaves(b)):
        np.testing.assert_array_equal(x, y)
    from raytracebvh_tpu_torch.io.bmp import read_bmp

    assert read_bmp(out).shape == (32, 32, 3)


def test_train_cli_needs_its_inputs(obj, tmp_path):
    if not torch.cuda.is_available():
        assert t_train.main(["--obj", obj, "--steps", "1"]) == 1
    assert t_train.main(["--obj", str(tmp_path / "missing.obj"),
                         "--device", "cpu"]) == 1
