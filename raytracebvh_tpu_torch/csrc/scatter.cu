// K3: scatter-add of channel-major rows, the backward of K2 and K7:
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
// sequential grid did not.  So the sum is taken in two stages, each in an
// order that does not depend on scheduling:
//   A. partials (one pass over g): a block takes 256 consecutive rays and
//      finds its distinct rows (__match_any_sync in each warp, then a
//      search of the earlier warps' rows in shared memory).  For each of
//      its rows and each channel it sums its rays' values in float64, in
//      an order fixed by lane and warp index: a warp transposes eight
//      channels through shared memory, lane 4j + q adds channel j over
//      quarter q of the row's lanes in lane order, two shuffles add the
//      quarters, and then the warps that have the row are added in order.
//      Each cell's largest |partial| goes to `cellmax` by 64-bit
//      atomicMax on the double's bits (order-free); a NaN or an infinity
//      in g only sets a flag, and counts as 0 in the partial.  A block
//      with at most kBudget rows writes its partials to its own slots.
//   B. fixed point: each partial is scaled by 2^k, k = 62 - e - s, where
//      the cell's max |partial| is below 2^e and a cell gets at most 2^s
//      partials (one a block), rounded to int64 and added by integer
//      atomicAdd, which is exact and so independent of order.  |scaled
//      partial| <= 2^(62-s), so no sum of 2^s of them overflows.  A block
//      with more than kBudget rows kept no partials: here it reads its g
//      again and computes them anew, with the same code and so the same
//      bits.  Coherent ids (tiled rays over morton-sorted leaves) keep g
//      read once; ids that scatter a block over more than kBudget rows
//      read that block's g twice.
//   finish: out = acc * 2^-k, rounded once to float32; a flagged cell is
//      NaN or +-inf, as IEEE addition makes it.
// Error against the exact (float64) sum of a cell: each partial is a
// float64 sum of at most 256 float32 values, off by at most 255 * 2^-53 of
// the sum of their |values|; its quantisation is off by at most
// 2^(e+s-63) <= 2^(s-62) times the cell's max |partial| M, so n <= 2^s
// partials are off by at most 2^(2s-62) M (2^-36 M for the 8 100 blocks of
// 2 073 600 rays, s = 13); then one float32 rounding.
//
// What bounds it on an H100: bytes.  g [C, R] float32 is most of them
// (332 MB at 1080p, C = 40); pass A reads it once, eight channels of
// loads in flight a lane and the next eight issued before the current
// ones are summed; pass B reads the partials (a few MB for coherent ids).
// A warp's transposed sums take ~40 instructions for eight channels of a
// row (a float64 shuffle tree takes ~160).  Atomics: one 64-bit max and
// one 64-bit add a (block, row, channel).  Nothing of the TPU kernel's
// one-hot selector or MXU contraction is carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = 256;  // rays a block
constexpr int kWarps = kBlock / 32;
constexpr int kGroup = 8;    // channels a step: a lane's loads in flight, and
                             // the channels of a warp's transposed sums
constexpr int kBudget = 32;  // rows a block keeps partials of
constexpr unsigned kNaN = 1u, kPosInf = 2u, kNegInf = 4u;
static_assert(kGroup * 4 == 32, "a warp sums kGroup channels in quarters");

struct Shared {
  float val[kWarps][kGroup][33];  // a warp's values by channel and lane (padded:
                                  // the quarter sums read without conflicts)
  double part[kGroup][kBlock];    // a warp's sum of each of its rows, by entry
  int key[kBlock];       // entry (warp * 32 + rank of the row in the warp) -> row
  unsigned peers[kBlock];  // entry -> the warp's lanes on that row
  int next[kBlock];      // entry -> the same row's entry in the next warp that
                         // has it, or -1
  int first[kBlock];     // the block's row (by rank) -> its first entry
  int rows[kWarps];      // rows of each warp
  int heads[kWarps];     // rows of each warp that no earlier warp has
};

// A lane's ray: its row, or -1 (past the end, or an index outside [0, rows)).
struct Ray {
  size_t r;
  int key;
};

// Finds the block's rows, ranked by their first ray; returns how many there
// are.  After it, sh.first and sh.next give each row's entries in warp order.
__device__ __forceinline__ int block_rows(Shared& sh, const int* __restrict__ idx,
                                          int nrays, int rows, Ray& ray) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  ray.r = static_cast<size_t>(blockIdx.x) * kBlock + tid;
  ray.key = -1;
  if (ray.r < static_cast<size_t>(nrays)) {
    const int row = __ldg(idx + ray.r);
    if (row >= 0 && row < rows) ray.key = row;
  }
  const unsigned peers = __match_any_sync(kFull, ray.key);
  const bool lead = ray.key >= 0 && lane == __ffs(peers) - 1;
  const unsigned leads = __ballot_sync(kFull, lead);
  const int entry = w * 32 + __popc(leads & below);
  sh.next[tid] = -1;
  if (lead) {
    sh.key[entry] = ray.key;
    sh.peers[entry] = peers;
  }
  if (lane == 0) sh.rows[w] = __popc(leads);
  __syncthreads();
  int prev = -1;  // the row's entry in the nearest earlier warp that has it
  if (lead) {
    for (int v = 0; v < w; ++v) {
      const int n = sh.rows[v];
      for (int p = 0; p < n; ++p) {
        if (sh.key[v * 32 + p] == ray.key) {
          prev = v * 32 + p;
          break;
        }
      }
    }
    if (prev >= 0) sh.next[prev] = entry;  // one writer: the chain is unique
  }
  const bool head = lead && prev < 0;
  const unsigned heads = __ballot_sync(kFull, head);
  if (lane == 0) sh.heads[w] = __popc(heads);
  __syncthreads();
  int before = 0, total = 0;
  for (int v = 0; v < kWarps; ++v) {
    const int n = sh.heads[v];
    before += v < w ? n : 0;
    total += n;
  }
  if (head) sh.first[before + __popc(heads & below)] = entry;
  __syncthreads();
  return total;
}

__device__ __forceinline__ bool finite_f32(float x) {
  return (__float_as_uint(x) & 0x7f800000u) != 0x7f800000u;
}

// This lane's values of channels c0 .. c0 + kGroup - 1 (0 past the end).
__device__ __forceinline__ void load_group(float (&x)[kGroup],
                                           const float* __restrict__ g,
                                           size_t R, int channels, int c0,
                                           const Ray& ray) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    x[j] = ray.key >= 0 && c0 + j < channels
               ? __ldcs(g + static_cast<size_t>(c0 + j) * R + ray.r)
               : 0.0f;
  }
}

// The block's float64 sum of each (row, channel), in an order fixed by lane
// and warp index: emit(row rank, c, sum), once for every row and channel.
// `flags` (nullable) gets the non-finite values, which count as 0.
// In a warp, lane 4j + q sums channel j over quarter q of a row's lanes, in
// lane order, and two shuffles add the quarters; then the warps that have
// the row are added in order.  A block without rows does nothing.
template <typename Emit>
__device__ __forceinline__ void block_sums(Shared& sh, const Ray& ray, int nrows,
                                           const float* __restrict__ g,
                                           int nrays, int channels,
                                           unsigned* __restrict__ flags,
                                           Emit emit) {
  if (nrows == 0) return;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int j = lane >> 2, q = lane & 3;
  const int wrows = sh.rows[w];
  const size_t R = static_cast<size_t>(nrays);
  float next[kGroup];
  load_group(next, g, R, channels, 0, ray);
  for (int c0 = 0; c0 < channels; c0 += kGroup) {
    float x[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) x[k] = next[k];
    if (c0 + kGroup < channels) {  // in flight while this group is summed
      load_group(next, g, R, channels, c0 + kGroup, ray);
    }
    if (wrows > 0) {
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (!finite_f32(x[k])) {
          if (flags != nullptr) {
            atomicOr(flags + static_cast<size_t>(ray.key) * channels + c0 + k,
                     x[k] != x[k] ? kNaN : (x[k] > 0.0f ? kPosInf : kNegInf));
          }
          x[k] = 0.0f;
        }
        sh.val[w][k][lane] = x[k];
      }
      __syncwarp();
      const float* mine = sh.val[w][j] + 8 * q;
      for (int e = 0; e < wrows; ++e) {
        const unsigned m = sh.peers[w * 32 + e] >> (8 * q);
        double s = 0.0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (m >> i & 1u) s += static_cast<double>(mine[i]);
        }
        s += __shfl_xor_sync(kFull, s, 1);  // a + b == b + a: every lane of
        s += __shfl_xor_sync(kFull, s, 2);  // the four gets the same bits
        if (q == 0) sh.part[j][w * 32 + e] = s;
      }
      __syncwarp();
    }
    __syncthreads();
    for (int p = tid; p < nrows * kGroup; p += kBlock) {
      const int h = p / kGroup, k = p - h * kGroup;
      if (c0 + k < channels) {
        int e = sh.first[h];
        double s = sh.part[k][e];
        for (e = sh.next[e]; e >= 0; e = sh.next[e]) s += sh.part[k][e];
        emit(h, c0 + k, s);
      }
    }
    __syncthreads();
  }
}

// k of a cell whose largest |partial| has the bits `maxbits` (0: all zero).
__device__ __forceinline__ int cell_shift(unsigned long long maxbits, int s) {
  if (maxbits == 0ull) return 0;
  int e;
  frexp(__longlong_as_double(static_cast<long long>(maxbits)), &e);  // max < 2^e
  return 62 - e - s;
}

__device__ __forceinline__ void add_fixed(unsigned long long* acc, double p,
                                          unsigned long long maxbits, int s) {
  if (p == 0.0) return;
  const long long q = __double2ll_rn(scalbn(p, cell_shift(maxbits, s)));
  // two's complement: unsigned addition is exact
  atomicAdd(acc, static_cast<unsigned long long>(q));
}

__global__ void __launch_bounds__(kBlock)
scatter_partials_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                        int nrays, int rows, int channels,
                        unsigned long long* __restrict__ cellmax,
                        unsigned* __restrict__ flags, int* __restrict__ count,
                        int* __restrict__ slot_row, double* __restrict__ partial) {
  __shared__ Shared sh;
  Ray ray;
  const int n = block_rows(sh, idx, nrays, rows, ray);
  const bool kept = n <= kBudget;
  if (threadIdx.x == 0) count[blockIdx.x] = n;
  if (kept && static_cast<int>(threadIdx.x) < n) {
    slot_row[blockIdx.x * kBudget + threadIdx.x] = sh.key[sh.first[threadIdx.x]];
  }
  double* part = partial + static_cast<size_t>(blockIdx.x) * channels * kBudget;
  block_sums(sh, ray, n, g, nrays, channels, flags, [&](int h, int c, double s) {
    if (s != 0.0) {
      atomicMax(cellmax + static_cast<size_t>(sh.key[sh.first[h]]) * channels + c,
                static_cast<unsigned long long>(__double_as_longlong(fabs(s))));
    }
    if (kept) part[static_cast<size_t>(c) * kBudget + h] = s;
  });
}

__global__ void __launch_bounds__(kBlock)
scatter_fixed_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                     int nrays, int rows, int channels, int s,
                     const unsigned long long* __restrict__ cellmax,
                     const int* __restrict__ count,
                     const int* __restrict__ slot_row,
                     const double* __restrict__ partial,
                     unsigned long long* __restrict__ acc) {
  __shared__ Shared sh;
  const int n = count[blockIdx.x];
  if (n <= kBudget) {  // the block's partials: C x n of them
    const double* part = partial + static_cast<size_t>(blockIdx.x) * channels * kBudget;
    const int* row = slot_row + blockIdx.x * kBudget;
    for (int i = threadIdx.x; i < n * channels; i += kBlock) {
      const int c = i / n, slot = i - c * n;
      const size_t cell = static_cast<size_t>(row[slot]) * channels + c;
      add_fixed(acc + cell, part[static_cast<size_t>(c) * kBudget + slot],
                cellmax[cell], s);
    }
    return;
  }
  Ray ray;  // more rows than slots: the same partials, from g again
  block_rows(sh, idx, nrays, rows, ray);
  block_sums(sh, ray, n, g, nrays, channels, nullptr, [&](int h, int c, double p) {
    const size_t cell = static_cast<size_t>(sh.key[sh.first[h]]) * channels + c;
    add_fixed(acc + cell, p, cellmax[cell], s);
  });
}

__global__ void __launch_bounds__(kBlock)
scatter_finish_kernel(const unsigned long long* __restrict__ acc,
                      const unsigned long long* __restrict__ cellmax,
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

size_t align8(size_t n) { return (n + 7) & ~static_cast<size_t>(7); }

}  // namespace

// Scratch bytes for a launch: per cell an int64 sum, the max |partial| and
// the non-finite flags (cleared here); per block its row count, and
// kBudget rows' slots and partials.
extern "C" long long rtbvh_scatter_scratch_bytes(int nrays, int rows,
                                                 int channels) {
  const size_t cells = static_cast<size_t>(rows) * channels;
  const size_t blocks = (static_cast<size_t>(nrays) + kBlock - 1) / kBlock;
  return static_cast<long long>(
      align8(cells * 20 + blocks * 4 * (1 + kBudget))
      + blocks * kBudget * static_cast<size_t>(channels) * 8);
}

// The blocking: rays a block, and the rows a block keeps partials of (a
// block of more rows reads its g again in pass B).
extern "C" int rtbvh_scatter_blocking(int* rays, int* budget) {
  *rays = kBlock;
  *budget = kBudget;
  return 0;
}

// g [channels, nrays] float32, idx [nrays] int32, out [rows, channels]
// float32; scratch: rtbvh_scatter_scratch_bytes of them, 8-byte aligned
// (a smaller `scratch_bytes` is refused).  nrays >= 1, rows * channels <
// 2^31.
extern "C" int rtbvh_scatter_add_f32(const float* g, const int* idx, int nrays,
                                     int rows, int channels, void* scratch,
                                     long long scratch_bytes, float* out,
                                     void* stream) {
  if (scratch_bytes < rtbvh_scatter_scratch_bytes(nrays, rows, channels)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cells = rows * channels;
  const int blocks = (nrays + kBlock - 1) / kBlock;
  unsigned long long* acc = static_cast<unsigned long long*>(scratch);
  unsigned long long* cellmax = acc + cells;
  unsigned* flags = reinterpret_cast<unsigned*>(cellmax + cells);
  int* count = reinterpret_cast<int*>(flags + cells);
  int* slot_row = count + blocks;
  double* partial = reinterpret_cast<double*>(
      static_cast<char*>(scratch)
      + align8(static_cast<size_t>(cells) * 20
               + static_cast<size_t>(blocks) * 4 * (1 + kBudget)));
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, static_cast<size_t>(cells) * 20, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  int s = 0;  // a cell gets at most one partial a block: blocks <= 2^s
  while ((1ll << s) < blocks) ++s;
  scatter_partials_kernel<<<blocks, kBlock, 0, st>>>(
      g, idx, nrays, rows, channels, cellmax, flags, count, slot_row, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_fixed_kernel<<<blocks, kBlock, 0, st>>>(
      g, idx, nrays, rows, channels, s, cellmax, count, slot_row, partial, acc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_finish_kernel<<<(cells + kBlock - 1) / kBlock, kBlock, 0, st>>>(
      acc, cellmax, flags, cells, s, out);
  return static_cast<int>(cudaGetLastError());
}
