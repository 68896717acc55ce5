// K3: scatter-add of channel-major rows, the backward of K2:
// out[idx[r], c] += g[c, r], with out [rows, C] float32 row-major.
//
// Replaces the JAX package's one-hot-matmul scatter
// (raytracebvh_tpu/ops/gather_pallas.py, _scatter_add_kernel, launched by
// _scatter_add_impl from gather_hbm.py's _gather_rows_hbm_bwd for tables of
// at most 32 768 rows; that cap was a VMEM limit, and above it the JAX
// package used XLA's scatter-add, which this kernel stands in for too).
// An index outside [0, rows) adds nothing, as in the TPU kernel.
//
// Deterministic: the same inputs give the same bits on every launch.  A
// float sum by atomics depends on the order the atomics land in; the TPU's
// sequential grid did not.  So every cell (row, c) is summed in 64-bit fixed
// point, where addition is exact and so independent of order:
//   1. cell max: the largest finite |g| of each cell, by atomicMax on the
//      float's bits (order-free); a NaN or an infinity only sets a flag.
//   2. sum: each g is scaled by 2^k, k = 62 - e - s, where the cell's max is
//      below 2^e and the ray count at most 2^s, rounded to int64 and added
//      by integer atomicAdd.  |scaled g| < 2^(62-s), so no sum of at most
//      2^s of them overflows.
//   3. finish: out = acc * 2^-k, rounded once to float32; a flagged cell is
//      NaN or +-inf, as IEEE addition makes it.
// Quantisation error against the exact (float64) sum: at most 2^(e+s-63)
// a ray, so n rays into one cell are off by at most n * 2^(e+s-63) <=
// 2^(2s-62) times the cell's max |g| (2^-20 for 2 073 600 rays; rounding
// errors of random sign make it far smaller), then one float32 rounding.
//
// What bounds it on an H100: bytes.  g [C, R] float32 is most of them
// (332 MB at 1080p, C = 40), and this design reads it twice, once in each
// of the first two passes.  Atomics are cut down a warp at a time: lanes
// with the same row (rays in 16-px tiles over morton-sorted leaves mostly
// share one) combine their values first, and one lane per row adds.
// Nothing of the TPU kernel's one-hot selector or MXU contraction is
// carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = 256;
constexpr unsigned kNaN = 1u, kPosInf = 2u, kNegInf = 4u;

struct Max {
  __device__ unsigned operator()(unsigned a, unsigned b) const { return max(a, b); }
};
struct Sum {
  __device__ long long operator()(long long a, long long b) const { return a + b; }
};

// The combination by `op` of v over the lanes of this lane's group (the lanes
// whose key equals this lane's, `peers` from __match_any_sync), exact in the
// group's lowest lane.  Every lane of the warp must call it.  `buf` is the
// warp's 32 slots of shared memory.  A whole-warp group (the common case) is
// reduced by shuffles; `peers == kFull` is the same in every lane.
template <typename T, typename Op>
__device__ __forceinline__ T group_combine(T v, unsigned peers, int lane,
                                           T* buf, Op op) {
  if (peers == kFull) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFull, v, o));
    return v;
  }
  buf[lane] = v;
  __syncwarp();
  if (lane == __ffs(peers) - 1) {
    for (unsigned m = peers & (peers - 1); m; m &= m - 1)
      v = op(v, buf[__ffs(m) - 1]);
  }
  __syncwarp();
  return v;
}

// A lane's ray (one a thread) and its group in the warp.
struct Ray {
  size_t r;       // ray index
  int key;        // its row, or -1: past the end, or an index outside [0, rows)
  unsigned peers; // the lanes with the same key
  bool leader;    // the group's lowest lane, with a valid key: it adds
  size_t cell0;   // the row's first cell
};

__device__ __forceinline__ Ray ray_of(const int* idx, int nrays, int rows,
                                      int channels) {
  Ray ray;
  ray.r = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  ray.key = -1;
  if (ray.r < static_cast<size_t>(nrays)) {
    const int row = idx[ray.r];
    if (row >= 0 && row < rows) ray.key = row;
  }
  ray.peers = __match_any_sync(kFull, ray.key);
  ray.leader = ray.key >= 0 && (threadIdx.x & 31) == __ffs(ray.peers) - 1;
  ray.cell0 = static_cast<size_t>(ray.key >= 0 ? ray.key : 0) * channels;
  return ray;
}

__device__ __forceinline__ bool finite_f32(float x) {
  return (__float_as_uint(x) & 0x7f800000u) != 0x7f800000u;
}

// k of a cell whose largest finite |g| has the bits `maxbits` (0: all zero).
__device__ __forceinline__ int cell_shift(unsigned maxbits, int s) {
  if (maxbits == 0u) return 0;
  int e;
  frexpf(__uint_as_float(maxbits), &e);  // max < 2^e
  return 62 - e - s;
}

__global__ void __launch_bounds__(kBlock)
scatter_max_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                   int nrays, int rows, int channels,
                   unsigned* __restrict__ cellmax, unsigned* __restrict__ flags) {
  __shared__ unsigned buf[kBlock];
  const Ray ray = ray_of(idx, nrays, rows, channels);
  const size_t R = static_cast<size_t>(nrays);
  for (int c = 0; c < channels; ++c) {
    unsigned m = 0u;
    if (ray.key >= 0) {
      const float x = g[c * R + ray.r];
      if (finite_f32(x)) {
        m = __float_as_uint(x) & 0x7fffffffu;  // |x|
      } else {
        atomicOr(flags + ray.cell0 + c,
                 x != x ? kNaN : (x > 0.f ? kPosInf : kNegInf));
      }
    }
    m = group_combine(m, ray.peers, threadIdx.x & 31,
                      buf + (threadIdx.x & ~31), Max());
    if (ray.leader && m != 0u) atomicMax(cellmax + ray.cell0 + c, m);
  }
}

__global__ void __launch_bounds__(kBlock)
scatter_sum_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                   int nrays, int rows, int channels, int s,
                   const unsigned* __restrict__ cellmax,
                   unsigned long long* __restrict__ acc) {
  __shared__ long long buf[kBlock];
  const Ray ray = ray_of(idx, nrays, rows, channels);
  const size_t R = static_cast<size_t>(nrays);
  for (int c = 0; c < channels; ++c) {
    long long q = 0;
    if (ray.key >= 0) {
      const float x = g[c * R + ray.r];
      if (finite_f32(x)) {  // exact scaling by 2^k, one rounding to int64
        q = __double2ll_rn(scalbn(static_cast<double>(x),
                                  cell_shift(cellmax[ray.cell0 + c], s)));
      }
    }
    q = group_combine(q, ray.peers, threadIdx.x & 31,
                      buf + (threadIdx.x & ~31), Sum());
    if (ray.leader && q != 0) {  // two's complement: unsigned addition is exact
      atomicAdd(acc + ray.cell0 + c, static_cast<unsigned long long>(q));
    }
  }
}

__global__ void __launch_bounds__(kBlock)
scatter_finish_kernel(const unsigned long long* __restrict__ acc,
                      const unsigned* __restrict__ cellmax,
                      const unsigned* __restrict__ flags, int cells, int s,
                      float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  const unsigned f = flags[i];
  float v;
  if ((f & kNaN) || ((f & kPosInf) && (f & kNegInf))) {
    v = __uint_as_float(0x7fc00000u);
  } else if (f & kPosInf) {
    v = __uint_as_float(0x7f800000u);
  } else if (f & kNegInf) {
    v = __uint_as_float(0xff800000u);
  } else {
    const long long a = static_cast<long long>(acc[i]);
    v = static_cast<float>(scalbn(static_cast<double>(a),
                                  -cell_shift(cellmax[i], s)));
  }
  out[i] = v;
}

int blocks_for(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace

// g [channels, nrays] float32, idx [nrays] int32, out [rows, channels]
// float32; scratch: 16 bytes a cell (rows * channels cells), 8-byte
// aligned, cleared here.  nrays >= 1, rows * channels < 2^31.
extern "C" int rtbvh_scatter_add_f32(const float* g, const int* idx, int nrays,
                                     int rows, int channels, void* scratch,
                                     float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cells = rows * channels;
  unsigned long long* acc = static_cast<unsigned long long*>(scratch);
  unsigned* cellmax = reinterpret_cast<unsigned*>(acc + cells);
  unsigned* flags = cellmax + cells;
  cudaError_t err = cudaMemsetAsync(scratch, 0, static_cast<size_t>(cells) * 16, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  int s = 0;  // nrays <= 2^s
  while ((1ll << s) < nrays) ++s;
  scatter_max_kernel<<<blocks_for(nrays), kBlock, 0, st>>>(
      g, idx, nrays, rows, channels, cellmax, flags);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_sum_kernel<<<blocks_for(nrays), kBlock, 0, st>>>(
      g, idx, nrays, rows, channels, s, cellmax, acc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_finish_kernel<<<blocks_for(cells), kBlock, 0, st>>>(
      acc, cellmax, flags, cells, s, out);
  return static_cast<int>(cudaGetLastError());
}
