"""K3's plain version (``gather_cuda.scatter_add_rows_torch``, and the
wrapper on CPU tensors) against the JAX package's backward of the
windowed gather: ``jax.vjp`` of ``gather_hbm.gather_rows_hbm``, which for
tables of at most 32 768 rows runs the TPU kernel ``_scatter_add_impl``
(in interpret mode here) and above that XLA's scatter-add.

Tolerance: 1e-6 of the largest |value| of the result.  Both sides sum in
float32 but in another order (the TPU kernel as one-hot matrix products
over 2048-ray blocks, the plain version ray by ray); the measured gap is
below 2e-7 of it.  An index outside [0, rows) adds nothing on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracebvh_tpu.ops.gather_hbm import gather_rows_hbm
from raytracebvh_tpu_torch.ops import gather_cuda

C = 40


def _ids(rng, rows, r, coherent, wild=0):
    if coherent:  # clustered runs + jumps + repeats
        base = np.repeat(rng.integers(0, max(rows - 300, 1), 16), -(-r // 16))[:r]
        ids = np.clip(base + rng.integers(0, 300, r), 0, rows - 1)
    else:
        ids = rng.integers(0, rows, r)
    if wild:  # ids outside [0, rows), both sides
        pick = rng.choice(r, wild, replace=False)
        ids[pick] = rng.choice([-1, -129, rows, rows + 200, 1 << 30], wild)
    return ids.astype(np.int32)


def _jax_vjp(rows, g, idx):
    tbl = jnp.zeros((rows, g.shape[0]), jnp.float32)
    _, vjp = jax.vjp(lambda t: gather_rows_hbm(t, jnp.asarray(idx)), tbl)
    return np.asarray(vjp(jnp.asarray(g))[0])


def _assert_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("rows,r,coherent,wild", [
    (3072, 2500, True, 0),  # unpadded R (the kernel pads to 2048-ray blocks)
    (300, 1000, False, 40),  # out-of-range ids
    (512, 4096, True, 7),  # R a whole number of 2048-ray blocks
])
def test_plain_scatter_matches_jax_kernel_vjp(rows, r, coherent, wild):
    rng = np.random.default_rng(rows + r)
    g = rng.normal(size=(C, r)).astype(np.float32)
    idx = _ids(rng, rows, r, coherent, wild)
    want = _jax_vjp(rows, g, idx)
    got = gather_cuda.scatter_add_rows_torch(torch.from_numpy(g),
                                             torch.from_numpy(idx), rows)
    _assert_close(got.numpy(), want)
    # the wrapper on CPU tensors is the plain version, and launches nothing
    before = gather_cuda.scatter_launches
    again = gather_cuda.scatter_add_rows(torch.from_numpy(g),
                                         torch.from_numpy(idx), rows)
    assert torch.equal(again, got)
    assert gather_cuda.scatter_launches == before
    if wild:  # the same as the sum over the valid ids alone
        valid = (idx >= 0) & (idx < rows)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jnp.zeros((rows, C)).at[idx[valid]].add(
                g[:, valid].T)), rtol=0, atol=1e-6 * np.abs(want).max())


def test_plain_scatter_above_the_kernel_cap_matches_xla_scatter():
    """Above 32 768 rows the JAX backward is XLA's scatter-add; K3 (and
    its plain version) serves that size too."""
    rng = np.random.default_rng(3)
    rows, r = 40000, 3000
    g = rng.normal(size=(C, r)).astype(np.float32)
    idx = _ids(rng, rows, r, True)
    want = _jax_vjp(rows, g, idx)
    got = gather_cuda.scatter_add_rows_torch(torch.from_numpy(g),
                                             torch.from_numpy(idx), rows)
    _assert_close(got.numpy(), want)


def test_plain_scatter_of_no_rays_is_zero():
    """R = 0: a zero table.  The JAX kernel path takes no empty ray
    batch, so the comparison is with its XLA scatter-add."""
    g = np.zeros((C, 0), np.float32)
    idx = np.zeros((0,), np.int32)
    got = gather_cuda.scatter_add_rows(torch.from_numpy(g),
                                       torch.from_numpy(idx), 17)
    want = np.asarray(jnp.zeros((17, C), jnp.float32).at[idx].add(g.T))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (17, C) and got.dtype == torch.float32


def test_cuda_autograd_wires_k2_forward_to_k3_backward(monkeypatch):
    """The CUDA branch's autograd Function, with both launches replaced by
    the plain versions (the kernels run only on a GPU): its forward is the
    K2 launch, its backward the K3 wrapper on the contiguous [C, R]
    gradient, and the table's gradient is the plain gather's."""
    calls = []

    def k2(tbl, idx):
        calls.append("K2")
        return gather_cuda.gather_rows_torch(tbl, idx)

    def k3(g, idx, rows):
        calls.append(("K3", tuple(g.shape), g.is_contiguous(), rows))
        return gather_cuda.scatter_add_rows_torch(g, idx, rows)

    monkeypatch.setattr(gather_cuda, "_launch_gather", k2)
    monkeypatch.setattr(gather_cuda, "scatter_add_rows", k3)
    rng = np.random.default_rng(4)
    tbl = torch.from_numpy(rng.normal(size=(64, C)).astype(np.float32))
    idx = torch.from_numpy(_ids(rng, 64, 500, True, 20))
    w = torch.from_numpy(rng.normal(size=(C, 500)).astype(np.float32))

    t = tbl.clone().requires_grad_()
    out = gather_cuda._GatherRows.apply(t, idx)
    (out[::2] * w[::2]).sum().backward()  # a gradient with zero rows
    t2 = tbl.clone().requires_grad_()
    (gather_cuda.gather_rows_torch(t2, idx)[::2] * w[::2]).sum().backward()
    assert calls == ["K2", ("K3", (C, 500), True, 64)]
    np.testing.assert_allclose(t.grad.numpy(), t2.grad.numpy(), rtol=0,
                               atol=1e-6 * float(t2.grad.abs().max()))
    with torch.no_grad():
        assert not gather_cuda._GatherRows.apply(t, idx).requires_grad

