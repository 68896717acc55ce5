"""The port's sorts against the JAX package's: the radix sort
(``ops/sort.radix_sort_by_code``) against JAX ``radix_sort_by_code``, and
the bitonic sort (kernel K8's entry point ``ops/sort_cuda``, which runs
its plain network on CPU tensors) against JAX ``bitonic_sort_by_code``
(the same network as plain XLA ops off the TPU); each also against the
stable sort.  Exact: a sort moves values.  Also K8's key: any sort of
the packed 64-bit (code, index) keys is the stable sort of the codes.

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
    if case == "equal":
        return np.full(n, 5, np.uint32)
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


@pytest.mark.parametrize("n", [1, 2, 1025, 4097])
@pytest.mark.parametrize("case", ["random", "duplicates", "equal"])
def test_bitonic_entry_edge_sizes_match_jax_bitonic(case, n):
    """K8's entry point on CPU tensors at sizes just past a power of two
    (and 1, 2): the plain network, equal to the JAX one."""
    codes = _codes(case, n, 7 * n)
    got = sort_cuda.bitonic_sort_by_code(
        torch.from_numpy(codes.astype(np.int32)))
    _check(got, j_bitonic(jnp.asarray(codes)), codes)


@pytest.mark.parametrize("case", ["random", "duplicates", "negative"])
def test_packed_key_sort_is_the_stable_sort(case):
    """K8 sorts one 64-bit key a code: the code in the high word and its
    index in the low word.  torch.sort of (code << 32) | index (int64) gives
    sort_by_code's permutation and codes, ties in index order; so does an
    unsigned sort of the kernel's own key, whose code has its sign bit
    flipped, on codes of either sign."""
    rng = np.random.default_rng(11)
    n = 5000
    if case == "negative":
        codes = rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
        codes[:50] = codes[50:100]  # ties across the sign too
    else:
        codes = _codes(case, n, 12).astype(np.int32)
    t = torch.from_numpy(codes)
    want_c, want_o = t_sort.sort_by_code(t)
    idx = torch.arange(n, dtype=torch.int64)
    keys, perm = torch.sort((t.to(torch.int64) << 32) | idx)
    assert torch.equal(perm.to(torch.int32), want_o)
    assert torch.equal((keys >> 32).to(torch.int32), want_c)
    assert torch.equal((keys & 0xFFFFFFFF).to(torch.int32), want_o)
    flipped = (codes.view(np.uint32) ^ np.uint32(0x80000000)).astype(np.uint64)
    kernel_keys = (flipped << np.uint64(32)) | np.arange(n, dtype=np.uint64)
    np.testing.assert_array_equal(np.sort(kernel_keys) & np.uint64(0xFFFFFFFF),
                                  want_o.numpy())


@pytest.mark.parametrize("n,kernels", [(0, 0), (1, 1), (3072, 1), (16384, 1),
                                       (16385, 4), (102400, 6),
                                       (131073, 7)])
def test_k8_launches_per_call(n, kernels):
    """One kernel up to 16 384 codes; above, the tile launch and one merge
    pass a doubling of the 4 096-code runs (102 400: 25 runs, 5 passes)."""
    assert sort_cuda.launches_per_call(n) == kernels
