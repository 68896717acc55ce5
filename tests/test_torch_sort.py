"""The port's sorts against the JAX package's: the radix sort
(``ops/sort.radix_sort_by_code``) against JAX ``radix_sort_by_code``, and
the bitonic sort (kernel K8's entry point ``ops/sort_cuda``, which runs
its plain network on CPU tensors) against JAX ``bitonic_sort_by_code``
(the same network as plain XLA ops off the TPU); each also against the
stable sort.  Exact: a sort moves values.

The JAX package's codes are uint32 and the port's int32; 30-bit codes
order alike in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracebvh_tpu.ops.sort import radix_sort_by_code as j_radix
from raytracebvh_tpu.ops.sort_pallas import bitonic_sort_by_code as j_bitonic
from raytracebvh_tpu_torch.ops import sort as t_sort
from raytracebvh_tpu_torch.ops import sort_cuda

SENTINEL = 0x3FFFFFFF


def _codes(case, n, seed):
    rng = np.random.default_rng(seed)
    if case == "random":
        return rng.integers(0, 1 << 30, n).astype(np.uint32)
    if case == "duplicates":
        return rng.integers(0, 7, n).astype(np.uint32)
    # the build's shape: real codes, then the sentinel padding
    return np.concatenate([rng.integers(0, 1 << 30, n - n // 8),
                           np.full(n // 8, SENTINEL)]).astype(np.uint32)


def _check(got, want, codes):
    gc, go = got
    wc, wo = (np.asarray(a) for a in want)
    assert gc.dtype == torch.int32 and go.dtype == torch.int32
    np.testing.assert_array_equal(gc.numpy(), wc.astype(np.int64))
    np.testing.assert_array_equal(go.numpy(), wo)
    # and the stable sort's permutation
    np.testing.assert_array_equal(go.numpy(),
                                  np.argsort(codes, kind="stable"))


CASES = [(case, n) for case in ("random", "duplicates", "sentinels")
         for n in (256, 768, 4096)]


@pytest.mark.parametrize("case,n", CASES)
def test_bitonic_entry_matches_jax_bitonic(case, n):
    codes = _codes(case, n, n)
    before = sort_cuda.launches
    got = sort_cuda.bitonic_sort_by_code(
        torch.from_numpy(codes.astype(np.int32)))
    assert sort_cuda.launches == before  # CPU tensors: the plain network
    _check(got, j_bitonic(jnp.asarray(codes)), codes)


@pytest.mark.parametrize("case,n", CASES)
def test_radix_matches_jax_radix(case, n):
    codes = _codes(case, n, n + 1)
    got = t_sort.radix_sort_by_code(torch.from_numpy(codes.astype(np.int32)))
    _check(got, j_radix(jnp.asarray(codes)), codes)


@pytest.mark.parametrize("n,npad", [(1, 1024), (1024, 1024), (1025, 2048),
                                    (3072, 4096), (102400, 131072)])
def test_padded_size(n, npad):
    """The JAX kernel's padding: a power of two >= 1 024 (8 x 128)."""
    assert sort_cuda.padded_size(n) == npad


def test_plain_network_sorts_padded_pairs():
    """The plain network on the padded (code, index) pairs directly, with
    INT_MAX padding codes: the whole padded array comes out sorted by
    (code, index), the padding last."""
    rng = np.random.default_rng(9)
    codes = torch.from_numpy(rng.integers(0, 5, 1500).astype(np.int32))
    keys, idx = sort_cuda._padded(codes)
    assert keys.shape == (2048,) and int(keys[1500:].min()) == sort_cuda.INT_MAX
    sk, si = sort_cuda.bitonic_network_torch(keys, idx)
    order = np.lexsort((idx.numpy(), keys.numpy()))
    assert torch.equal(si, idx[order]) and torch.equal(sk, keys[order])
