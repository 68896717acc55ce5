// K7: column gather from a channel-major table, out[c, r] = tbl[c, idx[r]],
// four consecutive rays a thread.
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
// design: a thread loads the ids of four consecutive rays once (one int4
// where the ray count is a multiple of 4 and the pointers are 16-byte
// aligned, else four scalars), then loops over the channels, eight at a
// time, so that 32 independent table loads are in flight before their
// stores, and writes each channel's four values as one float4 (or four
// scalars).  A warp's stores to one channel land on 128 neighbouring
// floats and coalesce; its ids are coherent along the ray order
// (morton-sorted leaves, tiled rays), so its loads from a table row land
// on a few neighbouring words, mostly out of L2, where the whole table
// stays.  Blocks run along the rays only.  The TPU kernel's
// tile-predicated 128-lane shuffles answered the TPU's lack of a per-lane
// gather; a GPU thread loads its own word, so none of it is carried over.
//
// An index outside [0, width) gives 0, as the TPU kernel's zeroed scratch
// leaves such lanes, and as K2 gives a zero row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kRays = 4;    // consecutive rays a thread
constexpr int kUnroll = 8;  // channels whose loads are in flight together

template <bool Vec>
__global__ void __launch_bounds__(kBlock)
gather_cols_f32_kernel(const float* __restrict__ tbl, int channels, int width,
                       const int* __restrict__ idx, int nrays,
                       float* __restrict__ out) {
  const size_t r0 =
      (static_cast<size_t>(blockIdx.x) * kBlock + threadIdx.x) * kRays;
  const size_t R = static_cast<size_t>(nrays);
  if (r0 >= R) return;
  int col[kRays];
  if (Vec) {  // nrays % 4 == 0: all four rays exist
    const int4 q = __ldg(reinterpret_cast<const int4*>(idx + r0));
    col[0] = q.x;
    col[1] = q.y;
    col[2] = q.z;
    col[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < kRays; ++k) col[k] = r0 + k < R ? __ldg(idx + r0 + k) : -1;
  }
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    if (col[k] < 0 || col[k] >= width) col[k] = -1;
  }
  for (int c0 = 0; c0 < channels; c0 += kUnroll) {
    float v[kUnroll][kRays];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float* row = tbl + static_cast<size_t>(c0 + u) * width;
#pragma unroll
      for (int k = 0; k < kRays; ++k) {
        v[u][k] = c0 + u < channels && col[k] >= 0 ? __ldg(row + col[k]) : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c0 + u >= channels) break;
      float* o = out + static_cast<size_t>(c0 + u) * R + r0;
      if (Vec) {
        *reinterpret_cast<float4*>(o) =
            make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
      } else {
#pragma unroll
        for (int k = 0; k < kRays; ++k) {
          if (r0 + k < R) o[k] = v[u][k];
        }
      }
    }
  }
}

}  // namespace

extern "C" int rtbvh_gather_cols_f32(const float* tbl, int channels, int width,
                                     const int* idx, int nrays, float* out,
                                     void* stream) {
  if (nrays > 0 && channels > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int threads = (nrays + kRays - 1) / kRays;
    const int grid = (threads + kBlock - 1) / kBlock;
    const bool vec = nrays % kRays == 0
        && reinterpret_cast<uintptr_t>(idx) % 16 == 0
        && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    if (vec) {
      gather_cols_f32_kernel<true><<<grid, kBlock, 0, st>>>(
          tbl, channels, width, idx, nrays, out);
    } else {
      gather_cols_f32_kernel<false><<<grid, kBlock, 0, st>>>(
          tbl, channels, width, idx, nrays, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
