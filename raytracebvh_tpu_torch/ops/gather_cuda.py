"""Row gather into channel-major output: ``out[c, r] = tbl[idx[r], c]``.

Kernel K2 (``csrc/gather.cu``), which replaces the JAX package's windowed
HBM gather (``ops/gather_hbm.py`` ``_gather_kernel``), and its plain
PyTorch version.  It serves the shading pass's two per-ray lookups: the
``[n, 40]`` float32 leaf-attribute rows and the ``[T*H*W, 16]`` texture
quad rows, float32 or UNORM8 (a uint8 table is unpacked as ``x / 255``,
a true division: ``x * (1/255)`` differs by one ulp for 126 of the 256
byte values).  An index outside ``[0, rows)`` gives a zero row, as the
TPU kernel leaves its zero-initialized output.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .ieee import div

launches = 0  # K2 launches (chip_smoke.py checks the main path reaches it)


def gather_rows_torch(tbl, idx):
    """The plain version: [rows, C] table, [R] int indices -> [C, R]
    float (float tables keep their dtype and their autograd graph)."""
    valid = (idx >= 0) & (idx < tbl.shape[0])
    rows = tbl[torch.where(valid, idx, 0)]
    if tbl.dtype == torch.uint8:
        rows = div(rows.to(torch.float32), 255.0)
    rows = torch.where(valid[:, None], rows, 0.0)
    return rows.t().contiguous()


def gather_rows(tbl, idx):
    """K2: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors.  ``tbl`` is a contiguous [rows, C] float32 table (C a
    multiple of 4) or uint8 table (C a multiple of 16); ``idx`` a
    contiguous [R] int32 tensor on the same device.  Returns [C, R]
    float32.  No gradient: the backward is kernel K3, not ported yet."""
    if tbl.device.type == "cpu" and idx.device.type == "cpu":
        return gather_rows_torch(tbl, idx)
    if tbl.device.type != "cuda" or idx.device != tbl.device:
        raise ValueError(
            f"gather_rows: table on {tbl.device}, indices on {idx.device}")
    if tbl.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "gather_rows has no backward on CUDA: its gradient is kernel K3 "
            "(the JAX package's ops/gather_pallas.py _scatter_add_kernel), "
            "not ported yet")
    if tbl.dtype == torch.float32:
        fn, vec = "rtbvh_gather_f32", 4
    elif tbl.dtype == torch.uint8:
        fn, vec = "rtbvh_gather_u8", 16
    else:
        raise TypeError(f"gather_rows: table dtype {tbl.dtype} "
                        "(expected float32 or uint8)")
    if tbl.dim() != 2 or tbl.shape[1] % vec or not tbl.is_contiguous():
        raise ValueError(
            f"gather_rows: table must be a contiguous [rows, C] tensor with "
            f"C a multiple of {vec} for {tbl.dtype}; got {tuple(tbl.shape)}")
    if tbl.data_ptr() % 16:
        raise ValueError("gather_rows: table storage is not 16-byte aligned")
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError("gather_rows: indices must be a contiguous [R] "
                         f"int32 tensor; got {idx.dtype} {tuple(idx.shape)}")
    rows, c = tbl.shape
    nrays = idx.shape[0]
    out = torch.empty((c, nrays), dtype=torch.float32, device=tbl.device)
    if nrays == 0:
        return out
    global launches
    with torch.cuda.device(tbl.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_kernels.load(), fn)(
            tbl.data_ptr(), rows, c, idx.data_ptr(), nrays, out.data_ptr(),
            stream)
    _kernels.check(err, "K2 gather_rows launch")
    launches += 1
    return out


def gather_for(backend: str):
    """The gather a resolved backend names (``config.resolve_backend``):
    'cuda' -> ``gather_rows``, 'torch' -> ``gather_rows_torch``."""
    return gather_rows if backend == "cuda" else gather_rows_torch
