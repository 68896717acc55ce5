"""The build's Karras emit on the CPU: the port's range-min emit
``karras_children_rmq`` (what ``build_topology`` runs) against the JAX
package's and against the port's exponential + binary search
``karras_children``, its parity oracle, and a guard on the number of
torch ops ``build_topology`` issues.

Tolerance: exact equality (integer outputs).  The op count is
deterministic: ``torch.profiler``'s top-level ops of one call on the CPU,
held under a stated bound.
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raytracebvh_tpu.ops import bvh as j_bvh
from raytracebvh_tpu_torch.ops import bvh as t_bvh

FIELDS = ("child_l", "child_r", "lo", "hi")
# tests/test_bvh.py::test_rmq_matches_search's cases, then one past a power
# of two (the table's padding) and the large frame's leaf count
CASES = [(8, 0, False), (256, 1, False), (1000, 2, False), (4096, 3, False),
         (512, 4, True), (2, 5, False), (3, 6, False), (4097, 7, False),
         (102400, 8, False)]


def _codes(n, seed, dup):
    rng = np.random.default_rng(seed)
    hi = 1 << 8 if dup else 1 << 30  # dup: many equal codes
    return np.sort(rng.integers(0, hi, n)).astype(np.uint32)


@pytest.mark.parametrize("n,seed,dup", CASES)
def test_rmq_matches_jax_rmq_and_the_search(n, seed, dup):
    codes = _codes(n, seed, dup)
    want = j_bvh.karras_children_rmq(jnp.asarray(codes, jnp.uint32))
    tcodes = torch.from_numpy(codes.astype(np.int32))
    got = t_bvh.karras_children_rmq(tcodes)
    oracle = t_bvh.karras_children(tcodes)
    for g, w, o, name in zip(got, want, oracle, FIELDS):
        assert g.dtype == torch.int32 and g.shape == (n - 1,), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        assert torch.equal(g, o), name


def test_build_topology_runs_the_rmq_emit(monkeypatch):
    """build_topology no longer reaches the search."""
    codes = torch.from_numpy(_codes(300, 9, False).astype(np.int32))
    want = t_bvh.build_topology(codes)

    def refuse(_):
        raise AssertionError("build_topology called karras_children")

    monkeypatch.setattr(t_bvh, "karras_children", refuse)
    got = t_bvh.build_topology(codes)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_past_its_key_bits_the_build_takes_the_search(monkeypatch):
    """The rmq emit's int32 keys hold 2^KEY_BITS + 1 leaves: with KEY_BITS
    lowered to 4, 17 leaves still give the search's bits, 300 raise, and
    build_topology of 300 leaves takes the search, whose tree is the rmq
    emit's."""
    small = torch.from_numpy(_codes(17, 10, False).astype(np.int32))
    codes = torch.from_numpy(_codes(300, 9, False).astype(np.int32))
    want = t_bvh.build_topology(codes)
    monkeypatch.setattr(t_bvh, "KEY_BITS", 4)
    got = t_bvh.karras_children_rmq(small)
    assert all(torch.equal(a, b)
               for a, b in zip(got, t_bvh.karras_children(small)))
    with pytest.raises(ValueError, match="2\\^4 \\+ 1"):
        t_bvh.karras_children_rmq(codes)
    got = t_bvh.build_topology(codes)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _top_level_ops(fn, *args):
    fn(*args)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(*args)
    return Counter(e.name for e in prof.events() if e.cpu_parent is None)


# top-level torch ops of one build_topology call (views included): the
# search issued 3 893 at 3 072 leaves and 5 058 at 102 400, the rmq emit
# 244 and 299 (torch 2.13 on the CPU); the bound leaves room for a few
# more ops a level, never for the search's ~300 a level
OP_BOUND = 400


@pytest.mark.parametrize("n", [3072, 102400])
def test_build_topology_op_count(n):
    codes = torch.from_numpy(_codes(n, 0, False).astype(np.int32))
    ops = _top_level_ops(t_bvh.build_topology, codes)
    total = sum(ops.values())
    assert total <= OP_BOUND, (total, ops.most_common(8))
    assert ops["aten::__rshift__"] == 0  # the clz's bit smear is gone


def test_clz32_edges():
    """_clz32 by the float64 exponent against a bit-by-bit count, at the
    powers of two, one either side, zero and the int32 sign bit."""
    vals = [0, 1, 2, 3, 0x7FFFFFFF, -1, -2 ** 31]
    for b in range(32):
        vals += [(1 << b) - 1, 1 << b, (1 << b) + 1]
    x = torch.tensor([v - (1 << 32) if v >= 1 << 31 else v for v in vals],
                     dtype=torch.int64)
    want = [32 - (v & 0xFFFFFFFF).bit_length() for v in vals]
    got = t_bvh._clz32(x)
    assert got.dtype == torch.int32 and got.tolist() == want
