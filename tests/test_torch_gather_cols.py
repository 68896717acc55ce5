"""The port's channel-major column gather (kernel K7,
``ops/gather_cols_cuda``) against the JAX package's in-VMEM table gather
``gather_pallas.gather_rows`` in interpret mode, forward and backward,
and the ``shade_gather_backend='shared'`` training gradient against the
JAX one through ``'pallas'``.

On CPU tensors the K7 wrapper runs its plain version.  Tolerances: the
forward exactly (a gather moves values), out-of-range ids included; the
backward exactly, on a gradient of small integers, whose sums are exact
in float32 in any order; the 24x24 ``value_and_grad`` within rtol 1e-4
and atol 1e-6, as ``tests/test_traverse_pallas.py::
test_shade_gather_backend_grads`` holds the JAX pallas gather to its XLA
one, and the loss within rtol 1e-6, as
``tests/test_torch_inverse.py`` holds the float32 loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracebvh_tpu as J
from raytracebvh_tpu.models import inverse as ji
from raytracebvh_tpu.ops.gather_pallas import gather_rows as j_gather_rows
import raytracebvh_tpu_torch as T
from raytracebvh_tpu_torch.models import inverse as ti
from raytracebvh_tpu_torch.ops import gather_cols_cuda, gather_cuda

from test_torch_inverse import (FIELDS, GRAD_SCENE, _jax_value_and_grad,
                                _port_value_and_grad, _scenes)


def _inputs(channels, width, nrays, seed):
    """A [C, width] table and ids with some outside [0, width) on both
    sides (the JAX kernel needs width a multiple of 128).  No id lies in
    [-127, -1]: there the interpret-mode JAX forward reads lane 128 + id
    of tile 0 (``take_along_axis`` wraps a negative lane), while its
    backward adds nothing for them (``test_k7_negative_ids_read_zero``)."""
    rng = np.random.default_rng(seed)
    tbl = rng.normal(size=(channels, width)).astype(np.float32)
    idx = rng.integers(-300, width + 140, nrays).astype(np.int32)
    idx = np.where((idx < 0) & (idx > -128), idx - 128, idx)
    return tbl, idx


def _jax_gather(tbl, idx):
    return np.asarray(j_gather_rows(jnp.asarray(tbl), jnp.asarray(idx),
                                    2048, True))


@pytest.mark.parametrize("channels,width,nrays,seed", [
    (40, 256, 3000, 0),  # the leaf-attribute table's 40 channels
    (16, 384, 5000, 1),
    (3, 128, 700, 2),  # channels padded to 8 inside the JAX kernel
])
def test_k7_entry_matches_interpret_mode_gather_rows(channels, width, nrays,
                                                     seed):
    tbl, idx = _inputs(channels, width, nrays, seed)
    before = gather_cols_cuda.launches
    got = gather_cols_cuda.gather_cols(torch.from_numpy(tbl),
                                       torch.from_numpy(idx))
    assert gather_cols_cuda.launches == before  # CPU tensors: plain version
    want = _jax_gather(tbl, idx)
    assert got.shape == (channels, nrays) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    bad = (idx < 0) | (idx >= width)
    assert bad.any() and (got.numpy()[:, bad] == 0).all()


def test_k7_negative_ids_read_zero():
    """Every id outside [0, width) reads 0, the TPU kernel's zeroed scratch
    (and what its backward and K3 add for such an id: nothing).  The
    interpret-mode JAX forward differs for ids in [-127, -1] only, where
    it reads tbl[:, 128 + id]; the pipeline's leaf ids are never
    negative."""
    tbl = np.arange(3 * 128, dtype=np.float32).reshape(3, 128)
    idx = np.array([-300, -128, -127, -5, -1, 0, 5, 127, 128, 200],
                   np.int32)
    got = gather_cols_cuda.gather_cols(torch.from_numpy(tbl),
                                       torch.from_numpy(idx)).numpy()
    want = np.where((idx >= 0) & (idx < 128), tbl[:, np.clip(idx, 0, 127)], 0)
    np.testing.assert_array_equal(got, want)
    jax_got = _jax_gather(tbl, idx)
    wrapped = (idx < 0) & (idx > -128)
    np.testing.assert_array_equal(jax_got[:, ~wrapped], want[:, ~wrapped])
    np.testing.assert_array_equal(jax_got[:, wrapped],
                                  tbl[:, 128 + idx[wrapped]])


def test_k7_backward_matches_jax_vjp():
    """The gradient of the table: the JAX custom_vjp through the TPU
    scatter kernel, the port's autograd through its plain version; both
    equal K3's plain version (the CUDA backward) transposed."""
    tbl, idx = _inputs(40, 256, 4000, 3)
    rng = np.random.default_rng(4)
    g = rng.integers(-8, 9, (40, 4000)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: j_gather_rows(t, jnp.asarray(idx), 2048, True),
                     jnp.asarray(tbl))
    (want,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(tbl).requires_grad_()
    gather_cols_cuda.gather_cols(t, torch.from_numpy(idx)).backward(
        torch.from_numpy(g))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
    k3 = gather_cuda.scatter_add_rows_torch(torch.from_numpy(g),
                                            torch.from_numpy(idx), 256).t()
    assert torch.equal(t.grad, k3)


def test_shared_gather_value_and_grad_match_jax_pallas():
    """24x24 loss_fn and its gradients through the 'shared' leaf gather
    against jax.value_and_grad through 'pallas' (interpret mode): both
    bounces' gathers carry gradient."""
    js, ts = _scenes(**GRAD_SCENE)
    cfg_kw = dict(width=24, height=24, bounces=1)
    target = np.zeros((24, 24, 4), np.float32)
    want_loss, want = _jax_value_and_grad(
        js, J.RenderConfig(**cfg_kw, shade_gather_backend="pallas"), target)
    params = ti.params_from_numpy(ji.init_params(js), device="cpu")
    loss, got = _port_value_and_grad(
        params, ts, T.RenderConfig(**cfg_kw, shade_gather_backend="shared"),
        target)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    for f, a, b in zip(FIELDS, got, want):
        assert np.abs(b).max() > 0, f
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=f)
