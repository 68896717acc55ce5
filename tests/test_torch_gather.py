"""The port's row gather (K2's plain version, and the wrapper on CPU
tensors) against the JAX package's windowed gather, run in interpret
mode.  Tolerance: exact equality (a gather moves bits; the UNORM8 unpack
is the same true division by 255)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracebvh_tpu.ops.gather_hbm import gather_rows_hbm
from raytracebvh_tpu_torch.ops import gather_cuda


def _ids(rng, rows, r, coherent):
    if coherent:  # clustered runs + jumps + repeats
        base = np.repeat(rng.integers(0, rows - 300, 16), -(-r // 16))[:r]
        return np.clip(base + rng.integers(0, 300, r), 0, rows - 1)
    return rng.integers(0, rows, r)


@pytest.mark.parametrize("channels", [40, 16])
@pytest.mark.parametrize("coherent", [True, False])
def test_f32_gather_matches_jax(channels, coherent):
    rng = np.random.default_rng(channels + coherent)
    rows, r = 1500, 1024
    tbl = rng.normal(size=(rows, channels)).astype(np.float32)
    idx = _ids(rng, rows, r, coherent).astype(np.int32)
    want = np.asarray(gather_rows_hbm(jnp.asarray(tbl), jnp.asarray(idx)))
    got = gather_cuda.gather_rows_torch(torch.from_numpy(tbl),
                                        torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (channels, r) and got.is_contiguous()


@pytest.mark.parametrize("coherent", [True, False])
def test_u8_gather_unpacks_as_jax(coherent):
    """uint8 quads: the JAX row-major texture path's
    ``q.astype(float32) / 255.0`` after the gather."""
    rng = np.random.default_rng(5 + coherent)
    rows, r = 4096, 1500
    tbl = rng.integers(0, 256, (rows, 16)).astype(np.uint8)
    idx = _ids(rng, rows, r, coherent).astype(np.int32)
    want = np.asarray(jnp.asarray(tbl)[jnp.asarray(idx)].astype(jnp.float32)
                      / 255.0).T
    got = gather_cuda.gather_rows(torch.from_numpy(tbl), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.float32
    # every byte value, in one row each
    every = np.arange(256, dtype=np.uint8).repeat(16).reshape(256, 16)
    got = gather_cuda.gather_rows(torch.from_numpy(every),
                                  torch.arange(256, dtype=torch.int32))
    np.testing.assert_array_equal(
        got.numpy()[0], np.arange(256, dtype=np.float32) / np.float32(255.0))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_out_of_range_indices_give_zero_rows(dtype):
    rng = np.random.default_rng(1)
    tbl = rng.integers(1, 200, (50, 16)).astype(dtype)
    idx = np.array([0, -1, 49, 50, 7, 1 << 30, -(1 << 30)], np.int32)
    got = gather_cuda.gather_rows(torch.from_numpy(tbl),
                                  torch.from_numpy(idx)).numpy()
    valid = (idx >= 0) & (idx < 50)
    assert (got[:, ~valid] == 0).all()
    scale = 255.0 if dtype == np.uint8 else 1.0
    np.testing.assert_array_equal(
        got[:, valid], (tbl[idx[valid]].astype(np.float32) / np.float32(scale)).T)


def test_cpu_wrapper_does_not_launch_and_keeps_grad():
    tbl = torch.randn(64, 40, dtype=torch.float32, requires_grad=True)
    idx = torch.tensor([3, 3, 9, 63], dtype=torch.int32)
    before = gather_cuda.launches
    out = gather_cuda.gather_rows(tbl, idx)
    assert gather_cuda.launches == before
    out.sum().backward()
    want = torch.zeros(64, 40)
    want[3] = 2.0
    want[9] = want[63] = 1.0
    assert torch.equal(tbl.grad, want)
