"""Bitonic sort of morton codes with their leaf index as payload: kernel
K8 (``csrc/sort.cu``), which replaces the JAX package's in-VMEM bitonic
sort (``ops/sort_pallas.py`` ``bitonic_sort_by_code``, kernel
``_sort_kernel``), and its plain PyTorch version, the same network.

The codes are padded to a power of two >= 1 024 with INT_MAX codes and
indices >= n; the compare key is the pair (code, original index), a
total order, so the network gives exactly the stable sort's
(sorted_codes, order) (``ops/sort.sort_by_code``).  The port's codes are
non-negative int32, so the JAX package's sign flip is not needed.  K8
sorts in shared memory in one launch up to 16 384 padded codes, and
above that with global-memory phases for the large strides
(``csrc/sort.cu``).
"""

from __future__ import annotations

import torch

from .. import _kernels

MIN_PAD = 1024  # the JAX kernel's smallest network: 8 rows of 128 lanes
TILE = 16384  # the most codes K8 sorts in one block's shared memory
INT_MAX = 0x7FFFFFFF

launches = 0  # K8 launches (chip_smoke.py checks the main path reaches it)


def padded_size(n: int) -> int:
    """The network's size for ``n`` codes: a power of two >= 1 024."""
    p = MIN_PAD
    while p < n:
        p *= 2
    return p


def _padded(codes):
    """(keys, idx): [padded_size(n)] int32 codes padded with INT_MAX, and
    the indices 0 .. padded_size(n) - 1."""
    n = codes.shape[0]
    npad = padded_size(n)
    keys = torch.full((npad,), INT_MAX, dtype=torch.int32, device=codes.device)
    keys[:n] = codes
    return keys, torch.arange(npad, dtype=torch.int32, device=codes.device)


def bitonic_network_torch(keys, idx):
    """The plain version: the bitonic network over power-of-two [npad]
    int32 ``keys`` with ``idx`` as payload (the JAX package's
    ``_network``, every phase written as its row-group case: pairs at
    stride s in blocks of 2s, ascending where bit k of the block's first
    index is clear).  Returns new (keys, idx)."""
    npad = keys.shape[0]
    log_n = npad.bit_length() - 1
    for k in range(1, log_n + 1):
        g = 1 << k
        for j in range(k - 1, -1, -1):
            s = 1 << j
            c2, i2 = keys.view(-1, 2, s), idx.view(-1, 2, s)
            clo, chi, ilo, ihi = c2[:, 0], c2[:, 1], i2[:, 0], i2[:, 1]
            first = torch.arange(npad // (2 * s), device=keys.device) * (2 * s)
            asc = ((first & g) == 0)[:, None]
            gt = (clo > chi) | ((clo == chi) & (ilo > ihi))
            swap = gt == asc
            keys = torch.stack([torch.where(swap, chi, clo),
                                torch.where(swap, clo, chi)], 1).reshape(npad)
            idx = torch.stack([torch.where(swap, ihi, ilo),
                               torch.where(swap, ilo, ihi)], 1).reshape(npad)
    return keys, idx


def bitonic_sort_by_code(codes):
    """K8 for CUDA tensors, the plain network for CPU tensors: [n]
    non-negative int32 ``codes`` -> (sorted_codes, order), both int32,
    ``ops.sort.sort_by_code``'s result."""
    if codes.dtype != torch.int32 or codes.dim() != 1:
        raise ValueError(f"bitonic_sort_by_code: codes must be [n] int32; "
                         f"got {codes.dtype} {tuple(codes.shape)}")
    n = codes.shape[0]
    keys, idx = _padded(codes)
    if codes.device.type == "cpu":
        keys, idx = bitonic_network_torch(keys, idx)
        return keys[:n], idx[:n]
    if codes.device.type != "cuda":
        raise ValueError(f"bitonic_sort_by_code: codes on {codes.device}")
    global launches
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels.load().rtbvh_bitonic_sort(
            keys.data_ptr(), idx.data_ptr(), keys.shape[0], stream)
    _kernels.check(err, "K8 bitonic_sort launch")
    launches += 1
    return keys[:n], idx[:n]
