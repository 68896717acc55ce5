// K8: bitonic sort of the morton codes with their leaf index as payload:
// (sorted codes, order), the result of a stable ascending sort.
//
// Replaces the JAX package's in-VMEM bitonic sort
// (raytracebvh_tpu/ops/sort_pallas.py, _sort_kernel, launched by
// bitonic_sort_by_code): sort_backend 'bitonic', and 'auto' on CUDA.
// Contract: the same (sorted_codes, order) as a stable sort
// (ops/sort.sort_by_code, torch.sort(stable=True)).  The compare key is
// the pair (code, original index), a total order with no ties, so any
// correct sorting network gives exactly the stable permutation.  The
// wrapper pads the codes to a power of two n >= 1 024 with INT_MAX codes
// and indices >= the real count; the port's codes are non-negative int32
// (30 bits, sentinel 0x3FFFFFFF), so the TPU kernel's sign flip is not
// needed.
//
// The network: for each stage k (sorted runs of 2^k) and each phase j < k
// (stride 2^j), element i and its partner i + 2^j (bit j of i clear) are
// compare-exchanged, ascending where bit k of i is clear.  That is
// n/2 * log2(n) * (log2(n) + 1) / 2 compare-exchanges.
//
// What bounds it on an H100: latency and barriers, not bytes (the 131 072
// codes of the large scene are 1 MB with their payload).  The design keeps
// the phases in shared memory wherever the stride allows:
//  * n <= 16 384 (8 bytes an element, 128 KB): one block sorts everything
//    in shared memory, one launch, a barrier between phases.  The dense
//    scene's 3 072 leaves pad to 4 096.
//  * n > 16 384: each 16 384-element tile is first sorted in shared memory
//    (stages k <= 14, one launch).  Each later stage runs its phases with
//    strides >= 16 384 as global-memory launches, one thread per pair, and
//    then its phases with smaller strides as one shared-memory launch per
//    tile.  The large scene's 102 400 leaves pad to 131 072: 10 launches.
// The TPU kernel's row-group reshapes and static lane shuffles answered
// the (8, 128) vreg layout; none of it is carried over.

#include <cuda_runtime.h>

namespace {

constexpr int kTileLog = 14;
constexpr int kTile = 1 << kTileLog;  // elements a block sorts in shared memory
constexpr int kThreads = 1024;

// (code, index) of i is greater than that of l
__device__ __forceinline__ bool greater(int ci, int xi, int cl, int xl) {
  return ci > cl || (ci == cl && xi > xl);
}

// The p-th pair of phase j: its lower element (bit j clear).
__device__ __forceinline__ int lower_of(int p, int j) {
  return ((p >> j) << (j + 1)) | (p & ((1 << j) - 1));
}

// Stages k_first..k_last of the tile at blockIdx.x * tile_n, phases
// min(k - 1, j_max)..0 of each, in shared memory.  tile_n is a power of
// two <= kTile; every stride here is < tile_n.
__global__ void __launch_bounds__(kThreads)
bitonic_tile_kernel(int* __restrict__ codes, int* __restrict__ idx,
                    int tile_n, int k_first, int k_last, int j_max) {
  extern __shared__ int smem[];
  int* c = smem;
  int* x = smem + tile_n;
  const int base = blockIdx.x * tile_n;
  for (int i = threadIdx.x; i < tile_n; i += blockDim.x) {
    c[i] = codes[base + i];
    x[i] = idx[base + i];
  }
  __syncthreads();
  for (int k = k_first; k <= k_last; ++k) {
    const int j_top = k - 1 < j_max ? k - 1 : j_max;
    for (int j = j_top; j >= 0; --j) {
      for (int p = threadIdx.x; p < tile_n / 2; p += blockDim.x) {
        const int i = lower_of(p, j);
        const int l = i + (1 << j);
        const bool asc = ((base + i) & (1 << k)) == 0;
        const int ci = c[i], xi = x[i], cl = c[l], xl = x[l];
        if (greater(ci, xi, cl, xl) == asc) {
          c[i] = cl;
          x[i] = xl;
          c[l] = ci;
          x[l] = xi;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < tile_n; i += blockDim.x) {
    codes[base + i] = c[i];
    idx[base + i] = x[i];
  }
}

// Phase j of stage k over all n elements in global memory, a pair a thread.
__global__ void bitonic_global_kernel(int* __restrict__ codes,
                                      int* __restrict__ idx, int n, int k,
                                      int j) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n / 2) return;
  const int i = lower_of(p, j);
  const int l = i + (1 << j);
  const bool asc = (i & (1 << k)) == 0;
  const int ci = codes[i], xi = idx[i], cl = codes[l], xl = idx[l];
  if (greater(ci, xi, cl, xl) == asc) {
    codes[i] = cl;
    idx[i] = xl;
    codes[l] = ci;
    idx[l] = xi;
  }
}

int log2_of(int n) {
  int k = 0;
  while ((1 << k) < n) ++k;
  return k;
}

cudaError_t tile_launch(int* codes, int* idx, int n, int tile_n, int k_first,
                        int k_last, int j_max, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(tile_n) * 2 * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      bitonic_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int threads = tile_n / 2 < kThreads ? tile_n / 2 : kThreads;
  bitonic_tile_kernel<<<n / tile_n, threads, smem, stream>>>(
      codes, idx, tile_n, k_first, k_last, j_max);
  return cudaGetLastError();
}

}  // namespace

// Sorts codes[0:n] (with idx as payload) in place; n a power of two
// >= 1 024.  Returns a cudaError_t.
extern "C" int rtbvh_bitonic_sort(int* codes, int* idx, int n, void* stream) {
  const int log_n = log2_of(n);
  if (n < 1024 || (1 << log_n) != n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= kTile) {
    return static_cast<int>(tile_launch(codes, idx, n, n, 1, log_n, log_n, s));
  }
  cudaError_t err = tile_launch(codes, idx, n, kTile, 1, kTileLog, kTileLog, s);
  const int block = 256;
  const int grid = (n / 2 + block - 1) / block;
  for (int k = kTileLog + 1; k <= log_n && err == cudaSuccess; ++k) {
    for (int j = k - 1; j >= kTileLog && err == cudaSuccess; --j) {
      bitonic_global_kernel<<<grid, block, 0, s>>>(codes, idx, n, k, j);
      err = cudaGetLastError();
    }
    if (err == cudaSuccess) {
      err = tile_launch(codes, idx, n, kTile, k, k, kTileLog - 1, s);
    }
  }
  return static_cast<int>(err);
}
