"""The port's checkpoints (``utils/checkpoint.py``) and Adam-state
carry-across (``models/inverse.adam_state`` / ``optimizer_from_numpy``)
against the JAX package's, both ways, on the CPU.

The training state is ``(params, opt_state, step)``: 11 leaves in
``jax.tree_util.tree_flatten`` order, ``count`` int32.  Tolerances: a
checkpoint moves arrays, so every leaf restored on either side equals the
leaf written bit for bit; the port's resume after 2 + 2 steps equals 4
straight steps bit for bit (the same operations on the same CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import raytracebvh_tpu as J
from raytracebvh_tpu.core.types import scene_to_device
from raytracebvh_tpu.models import inverse as ji
from raytracebvh_tpu.models.procedural import random_triangles as j_random
from raytracebvh_tpu.utils import checkpoint as jck
import raytracebvh_tpu_torch as T
from raytracebvh_tpu_torch.models import inverse as ti
from raytracebvh_tpu_torch.models.procedural import random_triangles as t_random
from raytracebvh_tpu_torch.utils import checkpoint as tck

# tests/test_checkpoint.py's training setup
SCENE = dict(num_tris=60, seed=2)
CFG = dict(width=16, height=16, bounces=0, ortho_scale=0.2)
LR = 1e-2


def _jax_trained(steps):
    scene = scene_to_device(j_random(**SCENE))
    cfg = J.RenderConfig(**CFG)
    params = ji.init_params(scene)
    state = ji.make_optimizer(LR).init(params)
    target = jnp.zeros((16, 16, 4), jnp.float32)
    for _ in range(steps):
        params, state, _ = ji.train_step(params, state, scene,
                                         J.Camera.default(), target, cfg, LR)
    return params, state


def _port_setup():
    scene = t_random(device="cpu", **SCENE)
    params = ti.init_params(scene)
    return scene, params, ti.make_optimizer(params, LR)


def _port_steps(scene, params, opt, steps):
    for _ in range(steps):
        ti.train_step(params, opt, scene, T.Camera.default("cpu"),
                      torch.zeros(16, 16, 4), T.RenderConfig(**CFG))


def _moments(opt, params):
    return [[opt.state[p][k] for p in params]
            for k in ("exp_avg", "exp_avg_sq")]


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    """optax.adam's state after 2 JAX train_steps, saved by the JAX
    package, gives the port the same parameters, moments and step."""
    jp, js = _jax_trained(2)
    path = str(tmp_path / "jax.npz")
    jck.save_checkpoint(path, (jp, js, 2))
    with np.load(path) as z:
        assert len(z.files) == 11 and z["leaf_3"].dtype == np.int32
    _, params, opt = _port_setup()
    p_np, s_np, step = tck.restore_checkpoint(
        path, (params, ti.adam_state(opt, params), 0))
    assert step == 2 and isinstance(step, int)
    params = ti.params_from_numpy(p_np, "cpu")
    opt = ti.optimizer_from_numpy(params, s_np, LR, "cpu")
    adam = js[0]
    for f, p in zip(ti.InverseParams._fields, params):
        np.testing.assert_array_equal(p.detach().numpy(),
                                      np.asarray(getattr(jp, f)), f)
        st = opt.state[p]
        assert float(st["step"]) == 2.0
        np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                      np.asarray(getattr(adam.mu, f)), f)
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                      np.asarray(getattr(adam.nu, f)), f)


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The port's state after 2 train_steps, saved by the port, restores
    in the JAX package with the same leaves, count int32."""
    scene, params, opt = _port_setup()
    _port_steps(scene, params, opt, 2)
    path = str(tmp_path / "port.npz")
    tck.save_checkpoint(path, (params, ti.adam_state(opt, params), 2))
    jp, js = _jax_trained(0)
    rp, rs, step = jck.restore_checkpoint(path, (jp, js, 0))
    assert step == 2 and isinstance(step, int)
    adam = rs[0]
    assert np.asarray(adam.count).dtype == np.int32
    assert int(adam.count) == 2
    mu, nu = _moments(opt, params)
    for i, (f, p) in enumerate(zip(ti.InverseParams._fields, params)):
        np.testing.assert_array_equal(np.asarray(getattr(rp, f)),
                                      p.detach().numpy(), f)
        np.testing.assert_array_equal(np.asarray(getattr(adam.mu, f)),
                                      mu[i].numpy(), f)
        np.testing.assert_array_equal(np.asarray(getattr(adam.nu, f)),
                                      nu[i].numpy(), f)
    # the JAX package trains on from it
    scene_j = scene_to_device(j_random(**SCENE))
    ji.train_step(rp, rs, scene_j, J.Camera.default(),
                  jnp.zeros((16, 16, 4), jnp.float32), J.RenderConfig(**CFG),
                  LR)


def test_training_resume_matches_uninterrupted(tmp_path):
    """tests/test_checkpoint.py's resume on the port: 2 steps, save,
    restore into fresh parameters and a fresh optimizer, 2 more steps
    equal 4 steps without a break."""
    scene, p_a, opt_a = _port_setup()
    _port_steps(scene, p_a, opt_a, 4)

    _, p_b, opt_b = _port_setup()
    _port_steps(scene, p_b, opt_b, 2)
    path = str(tmp_path / "train.npz")
    tck.save_checkpoint(path, (p_b, ti.adam_state(opt_b, p_b), 2))
    _, p_fresh, opt_fresh = _port_setup()
    assert not opt_fresh.state
    p_np, s_np, step = tck.restore_checkpoint(
        path, (p_fresh, ti.adam_state(opt_fresh, p_fresh), 0))
    assert step == 2
    p_c = ti.params_from_numpy(p_np, "cpu")
    opt_c = ti.optimizer_from_numpy(p_c, s_np, LR, "cpu")
    _port_steps(scene, p_c, opt_c, 2)
    for a, c in zip(p_a, p_c):
        assert torch.equal(a, c)
    for ma, mc in zip(_moments(opt_a, p_a), _moments(opt_c, p_c)):
        for a, c in zip(ma, mc):
            assert torch.equal(a, c)


def test_fresh_optimizer_state_is_optax_init():
    """Before its first step the port's Adam has optax's initial state:
    count 0 and zero moments."""
    _, params, opt = _port_setup()
    adam, empty = ti.adam_state(opt, params)
    assert empty == () and tck.tree_leaves(empty) == []
    assert adam.count.dtype == np.int32 and int(adam.count) == 0
    want = optax.adam(LR).init(ji.init_params(scene_to_device(
        j_random(**SCENE))))
    assert len(tck.tree_leaves((adam, empty))) == len(
        jax.tree_util.tree_leaves(want)) == 7
    for m in (*adam.mu, *adam.nu):
        assert not bool(m.any())


def test_dict_round_trip_keys_out_of_order(tmp_path):
    """A dict written with its keys out of order: leaves by sorted key,
    as JAX flattens it, whichever package writes or reads."""
    t_tree = {"step": 42, "b": (np.int32(7), 3.5, None),
              "a": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    j_tree = {"step": 42, "b": (np.int32(7), 3.5, None),
              "a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3)}
    port_path, jax_path = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    tck.save_checkpoint(port_path, t_tree)
    jck.save_checkpoint(jax_path, j_tree)
    with np.load(port_path) as zp, np.load(jax_path) as zj:
        assert zp.files == zj.files
        for k in zp.files:
            np.testing.assert_array_equal(zp[k], zj[k])
            assert zp[k].dtype == zj[k].dtype, k
    for path in (port_path, jax_path):
        got_t = tck.restore_checkpoint(path, t_tree)
        got_j = jck.restore_checkpoint(path, j_tree)
        for got in (got_t, got_j):
            assert got["step"] == 42 and isinstance(got["step"], int)
            assert got["b"][0] == 7 and isinstance(got["b"][0], np.int32)
            assert got["b"][1] == 3.5 and got["b"][2] is None
            np.testing.assert_array_equal(np.asarray(got["a"]),
                                          np.arange(6.0).reshape(2, 3))
    assert list(tck.restore_checkpoint(port_path, t_tree)) == list(t_tree)


def test_missing_file_and_leaf_count(tmp_path):
    tree = (torch.zeros(2), 1)
    assert tck.restore_checkpoint(str(tmp_path / "missing.npz"), tree) is None
    path = str(tmp_path / "ck.npz")
    tck.save_checkpoint(path, tree)
    with pytest.raises(ValueError, match="1 expected"):
        tck.restore_checkpoint(path, (torch.zeros(2),))


def test_failed_write_leaves_no_file(tmp_path, monkeypatch):
    """The write is atomic: a failure removes the temporary file and
    leaves the target as it was."""
    path = tmp_path / "ck.npz"
    tck.save_checkpoint(str(path), (torch.ones(3),))
    before = path.read_bytes()

    def boom(*a, **k):
        raise RuntimeError("disk full")

    monkeypatch.setattr(tck.np, "savez", boom)
    with pytest.raises(RuntimeError, match="disk full"):
        tck.save_checkpoint(str(path), (torch.zeros(3),))
    assert path.read_bytes() == before
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ck.npz"]
