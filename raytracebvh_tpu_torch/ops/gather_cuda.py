"""Row gather into channel-major output, ``out[c, r] = tbl[idx[r], c]``,
and its backward, the scatter-add ``dtbl[idx[r], c] += g[c, r]``.

Kernel K2 (``csrc/gather.cu``), which replaces the JAX package's windowed
HBM gather (``ops/gather_hbm.py`` ``_gather_kernel``), and its plain
PyTorch version.  It serves the shading pass's two per-ray lookups: the
``[n, 40]`` float32 leaf-attribute rows and the ``[T*H*W, 16]`` texture
quad rows, float32 or UNORM8 (a uint8 table is unpacked as ``x / 255``,
a true division: ``x * (1/255)`` differs by one ulp for 126 of the 256
byte values).  An index outside ``[0, rows)`` gives a zero row, as the
TPU kernel leaves its zero-initialized output.

Kernel K3 (``csrc/scatter.cu``) is K2's backward on CUDA: it replaces the
JAX package's one-hot-matmul scatter (``ops/gather_pallas.py``
``_scatter_add_kernel``, which ``gather_hbm.py``'s backward takes for
tables of at most 32 768 rows).  That cap was a VMEM limit: K3 serves any
row count, and above it stands in for the XLA scatter-add the JAX package
used there.  K3 reads g once: a block of 256 rays sums each of its rows
in float64 in a fixed order, and the blocks' partials are added in 64-bit
fixed point, so it gives the same bits on every launch; its error against
the float64 sum is stated in its source.
An index outside ``[0, rows)`` adds nothing, matching K2's zero row.  A
uint8 table has no backward (the pipeline detaches it before packing).
"""

from __future__ import annotations

import torch

from .. import _kernels
from .ieee import div

# K2 launches (chip_smoke.py checks the main path reaches it); a CUDA
# graph's capture counts, its replays do not (they skip this wrapper)
launches = 0
# tables of these dtypes go through the float32 kernels, exactly, and the
# result comes back in the table's dtype, as the JAX gathers return it
HALF_FLOATS = (torch.bfloat16, torch.float16)
scatter_launches = 0  # K3 launches (counted as K2's)


def gather_rows_torch(tbl, idx):
    """The plain version: [rows, C] table, [R] int indices -> [C, R]
    float (float tables keep their dtype and their autograd graph)."""
    valid = (idx >= 0) & (idx < tbl.shape[0])
    rows = tbl[torch.where(valid, idx, 0)]
    if tbl.dtype == torch.uint8:
        rows = div(rows.to(torch.float32), 255.0)
    rows = torch.where(valid[:, None], rows, 0.0)
    return rows.t().contiguous()


def scatter_add_rows_torch(g, idx, rows: int):
    """K3's plain version: [C, R] float ``g``, [R] int indices -> [rows, C]
    with ``out[idx[r], c] += g[c, r]``; indices outside [0, rows) add
    nothing."""
    valid = (idx >= 0) & (idx < rows)
    out = torch.zeros((rows, g.shape[0]), dtype=g.dtype, device=g.device)
    return out.index_add_(0, idx[valid].long(), g.t()[valid])


def _check_ids(idx, what):
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"{what}: indices must be a contiguous [R] int32 "
                         f"tensor; got {idx.dtype} {tuple(idx.shape)}")


def _launch_gather(tbl, idx):
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
    _check_ids(idx, "gather_rows")
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


class _GatherRows(torch.autograd.Function):
    """K2 forward, K3 backward."""

    @staticmethod
    def forward(ctx, tbl, idx):
        ctx.save_for_backward(idx)
        ctx.rows = tbl.shape[0]
        return _launch_gather(tbl, idx)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return scatter_add_rows(g.contiguous(), idx, ctx.rows), None


def gather_rows(tbl, idx):
    """K2: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors.  ``tbl`` is a contiguous [rows, C] float32 table (C a
    multiple of 4) or uint8 table (C a multiple of 16); ``idx`` a
    contiguous [R] int32 tensor on the same device.  Returns [C, R]
    float32.  On CUDA a float32 table's gradient is kernel K3.  A
    bfloat16 or float16 table is gathered as float32 (an exact cast) and
    returns [C, R] in its own dtype, as the JAX gather does; its gradient
    is K3's float32 sum, rounded once to that dtype."""
    if tbl.device.type == "cpu" and idx.device.type == "cpu":
        return gather_rows_torch(tbl, idx)
    if tbl.device.type != "cuda" or idx.device != tbl.device:
        raise ValueError(
            f"gather_rows: table on {tbl.device}, indices on {idx.device}")
    if tbl.dtype in HALF_FLOATS:
        return _GatherRows.apply(tbl.float(), idx).to(tbl.dtype)
    return _GatherRows.apply(tbl, idx)


def scatter_add_rows(g, idx, rows: int):
    """K3: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors.  ``g`` is a contiguous [C, R] float32 tensor (channel-major,
    as K2 writes it), ``idx`` a contiguous [R] int32 tensor on the same
    device.  Returns [rows, C] float32, ``out[idx[r], c] += g[c, r]``,
    the same bits on every launch."""
    if g.device.type == "cpu" and idx.device.type == "cpu":
        return scatter_add_rows_torch(g, idx, rows)
    if g.device.type != "cuda" or idx.device != g.device:
        raise ValueError(
            f"scatter_add_rows: g on {g.device}, indices on {idx.device}")
    if g.dtype != torch.float32 or g.dim() != 2 or not g.is_contiguous():
        raise ValueError("scatter_add_rows: g must be a contiguous [C, R] "
                         f"float32 tensor; got {g.dtype} {tuple(g.shape)}")
    _check_ids(idx, "scatter_add_rows")
    c, nrays = g.shape
    if idx.shape[0] != nrays:
        raise ValueError(f"scatter_add_rows: {nrays} columns of g, "
                         f"{idx.shape[0]} indices")
    if rows < 0 or rows * c >= 2 ** 31:
        raise ValueError(f"scatter_add_rows: {rows} rows x {c} channels")
    out = torch.empty((rows, c), dtype=torch.float32, device=g.device)
    if nrays == 0 or rows * c == 0:
        return out.zero_()
    lib = _kernels.load()
    # per cell its sum, max |partial| and flags; per block its partials
    nbytes = lib.rtbvh_scatter_scratch_bytes(nrays, rows, c)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=g.device)
    global scatter_launches
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rtbvh_scatter_add_f32(
            g.data_ptr(), idx.data_ptr(), nrays, rows, c, scratch.data_ptr(),
            nbytes, out.data_ptr(), stream)
    _kernels.check(err, "K3 scatter_add_rows launch")
    scatter_launches += 1
    return out


def gather_for(backend: str):
    """The gather a resolved backend names (``config.resolve_backend``):
    'cuda' -> ``gather_rows``, 'torch' -> ``gather_rows_torch``."""
    return gather_rows if backend == "cuda" else gather_rows_torch
