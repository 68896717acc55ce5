"""Stable sort of morton codes with their leaf index as payload: kernel
K8 (``csrc/sort.cu``), which replaces the JAX package's in-VMEM bitonic
sort (``ops/sort_pallas.py`` ``bitonic_sort_by_code``, kernel
``_sort_kernel``), and its plain PyTorch version, the JAX package's
bitonic network.

Both give exactly the stable sort's (sorted_codes, order)
(``ops/sort.sort_by_code``, ``torch.sort(stable=True)``).  The plain
network sorts the pairs (code, original index), a total order, padded to
a power of two >= 1 024 with INT_MAX codes and indices >= n.  K8 sorts
the same order packed in one 64-bit key a code, and pads and numbers
inside the kernel: a call allocates its two outputs and launches.  Up to
16 384 codes one block sorts them in registers, warp shuffles and shared
memory, in one launch; above that, blocks sort 4 096-code tiles and
merge passes merge the sorted runs pairwise (``launches_per_call``).
"""

from __future__ import annotations

import torch

from .. import _kernels

MIN_PAD = 1024  # the JAX kernel's smallest network: 8 rows of 128 lanes
SMALL_MAX = 16384  # the most codes K8 sorts in one block, one launch
TILE = 4096  # above SMALL_MAX: the codes a block sorts before the merges
INT_MAX = 0x7FFFFFFF

# K8 launches (chip_smoke.py checks the main path reaches it); a CUDA
# graph's capture counts, its replays do not (they skip this wrapper)
launches = 0


def padded_size(n: int) -> int:
    """The plain network's size for ``n`` codes: a power of two >= 1 024."""
    p = MIN_PAD
    while p < n:
        p *= 2
    return p


def launches_per_call(n: int) -> int:
    """CUDA kernels one K8 call on ``n`` codes runs (``csrc/sort.cu``):
    one up to SMALL_MAX codes; above, one tile launch and one merge pass
    for each doubling of the TILE-code runs."""
    if n <= 0:
        return 0
    if n <= SMALL_MAX:
        return 1
    runs, passes = -(-n // TILE), 0
    while (1 << passes) < runs:
        passes += 1
    return 1 + passes


def _padded(codes):
    """(keys, idx): [padded_size(n)] int32 codes padded with INT_MAX, and
    the indices 0 .. padded_size(n) - 1: the plain network's input."""
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
    """K8 for CUDA tensors, the plain network for CPU tensors: [n] int32
    ``codes`` -> (sorted_codes, order), both int32,
    ``ops.sort.sort_by_code``'s result."""
    if codes.dtype != torch.int32 or codes.dim() != 1:
        raise ValueError(f"bitonic_sort_by_code: codes must be [n] int32; "
                         f"got {codes.dtype} {tuple(codes.shape)}")
    n = codes.shape[0]
    if codes.device.type == "cpu":
        keys, idx = bitonic_network_torch(*_padded(codes))
        return keys[:n], idx[:n]
    if codes.device.type != "cuda":
        raise ValueError(f"bitonic_sort_by_code: codes on {codes.device}")
    if not codes.is_contiguous():
        raise ValueError("bitonic_sort_by_code: codes must be contiguous")
    sorted_codes = torch.empty_like(codes)
    order = torch.empty_like(codes)
    if n == 0:
        return sorted_codes, order
    # the large route's two buffers of 64-bit keys
    scratch = (torch.empty(2 * n, dtype=torch.int64, device=codes.device)
               if n > SMALL_MAX else None)
    global launches
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels.load().rtbvh_sort_by_code(
            codes.data_ptr(), n, sorted_codes.data_ptr(), order.data_ptr(),
            None if scratch is None else scratch.data_ptr(), stream)
    _kernels.check(err, "K8 sort_by_code launch")
    launches += 1
    return sorted_codes, order
