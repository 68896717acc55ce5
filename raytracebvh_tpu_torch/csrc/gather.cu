// K2: row gather into channel-major output, out[c, r] = tbl[idx[r], c],
// one thread per ray.
//
// Replaces the JAX package's windowed HBM gather
// (raytracebvh_tpu/ops/gather_hbm.py, _gather_kernel, launched by
// _gather_hbm_fwd_impl through gather_rows_hbm and gather_rows_packed).  It
// serves the shading pass: the [n, 40] float32 leaf-attribute rows and the
// [T*H*W, 16] texture-quad rows, float32 or UNORM8.
//
// What bounds it on an H100: bytes moved.  A ray reads one row (160, 64
// or 16 bytes) and writes C floats.  The design: a thread reads its row
// with 16-byte vector loads (rows are 16-byte multiples and the wrapper
// checks the table's alignment), and writes out[c, r] for each c, so a
// warp's stores to one channel land on 32 neighbouring floats and
// coalesce.  Indices are coherent along the ray order (morton-sorted
// leaves, tiled rays, screen-space texels), so neighbouring threads read
// neighbouring rows, mostly out of L2.  The TPU kernel's window DMAs and
// lane shuffles answered the TPU's lack of a per-lane gather; a GPU thread
// loads its own row, so none of it is carried over.
//
// The UNORM8 unpack is a true division, x / 255.0f (IEEE, no fast math):
// x * (1/255) differs by one ulp for 126 of the 256 byte values, and the
// uint8 path is held to bit parity.
//
// An index outside [0, rows) gives a zero row: the TPU kernel leaves such
// lanes at its zero-initialized output.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void gather_f32_kernel(const float4* __restrict__ tbl, int rows,
                                  int c4, const int* __restrict__ idx,
                                  int nrays, float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nrays) return;
  const int row = idx[r];
  const bool valid = row >= 0 && row < rows;
  const float4* src = tbl + static_cast<size_t>(valid ? row : 0) * c4;
  const size_t R = static_cast<size_t>(nrays);
  for (int k = 0; k < c4; ++k) {
    const float4 v = valid ? __ldg(src + k) : make_float4(0.f, 0.f, 0.f, 0.f);
    float* o = out + static_cast<size_t>(4 * k) * R + r;
    o[0] = v.x;
    o[R] = v.y;
    o[2 * R] = v.z;
    o[3 * R] = v.w;
  }
}

__global__ void gather_u8_kernel(const uint4* __restrict__ tbl, int rows,
                                 int c16, const int* __restrict__ idx,
                                 int nrays, float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nrays) return;
  const int row = idx[r];
  const bool valid = row >= 0 && row < rows;
  const uint4* src = tbl + static_cast<size_t>(valid ? row : 0) * c16;
  const size_t R = static_cast<size_t>(nrays);
  for (int k = 0; k < c16; ++k) {
    const uint4 q = valid ? __ldg(src + k) : make_uint4(0u, 0u, 0u, 0u);
    const unsigned int words[4] = {q.x, q.y, q.z, q.w};
    float* o = out + static_cast<size_t>(16 * k) * R + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {  // little-endian: byte 4j+b of the row
        const unsigned int byte = (words[j] >> (8 * b)) & 0xFFu;
        o[static_cast<size_t>(4 * j + b) * R] = static_cast<float>(byte) / 255.0f;
      }
    }
  }
}

int blocks_for(int nrays, int block) { return (nrays + block - 1) / block; }

}  // namespace

extern "C" int rtbvh_gather_f32(const void* tbl, int rows, int channels,
                                const int* idx, int nrays, float* out,
                                void* stream) {
  const int block = 256;
  if (nrays > 0) {
    gather_f32_kernel<<<blocks_for(nrays, block), block, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(tbl), rows, channels / 4, idx, nrays, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtbvh_gather_u8(const void* tbl, int rows, int channels,
                               const int* idx, int nrays, float* out,
                               void* stream) {
  const int block = 256;
  if (nrays > 0) {
    gather_u8_kernel<<<blocks_for(nrays, block), block, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(tbl), rows, channels / 16, idx, nrays, out);
  }
  return static_cast<int>(cudaGetLastError());
}
