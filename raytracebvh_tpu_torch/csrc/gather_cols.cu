// K7: column gather from a channel-major table, out[c, r] = tbl[c, idx[r]],
// one thread per (c, r).
//
// Replaces the JAX package's in-VMEM table gather
// (raytracebvh_tpu/ops/gather_pallas.py, _gather_kernel, launched by
// _gather_fwd_impl through gather_rows): the shading pass's leaf-attribute
// lookup when shade_gather_backend is 'shared' (the JAX 'pallas'), on the
// [40, n] transpose of the leaf-attribute table.  Its backward is K3
// (csrc/scatter.cu) on the same g and ids, as the TPU kernel's custom_vjp
// took _scatter_add_kernel.
//
// What bounds it on an H100: bytes moved.  It reads the ids and the table
// (0.5 MB for 3 072 leaves x 40 channels) and writes C floats a ray.  The
// design: threadIdx.x runs along the rays, so a warp writes 32 neighbouring
// floats of one channel (coalesced) and reads 32 ids that are coherent
// along the ray order (morton-sorted leaves, tiled rays): its loads from a
// table row land on a few neighbouring words, mostly out of L2, where the
// whole table stays.  blockIdx.y runs over the channels.  The TPU kernel's
// tile-predicated 128-lane shuffles answered the TPU's lack of a per-lane
// gather; a GPU thread loads its own word, so none of it is carried over.
//
// An index outside [0, width) gives 0, as the TPU kernel's zeroed scratch
// leaves such lanes, and as K2 gives a zero row.

#include <cuda_runtime.h>

namespace {

__global__ void gather_cols_f32_kernel(const float* __restrict__ tbl,
                                       int width, const int* __restrict__ idx,
                                       int nrays, float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nrays) return;
  const int c = blockIdx.y;
  const int col = __ldg(&idx[r]);
  const bool valid = col >= 0 && col < width;
  const size_t row = static_cast<size_t>(c) * width;
  out[static_cast<size_t>(c) * nrays + r] = valid ? __ldg(&tbl[row + col]) : 0.0f;
}

}  // namespace

extern "C" int rtbvh_gather_cols_f32(const float* tbl, int channels, int width,
                                     const int* idx, int nrays, float* out,
                                     void* stream) {
  const int block = 256;
  if (nrays > 0 && channels > 0) {
    const dim3 grid((nrays + block - 1) / block, channels);
    gather_cols_f32_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        tbl, width, idx, nrays, out);
  }
  return static_cast<int>(cudaGetLastError());
}
