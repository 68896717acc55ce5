// K8: stable sort of the morton codes with their leaf index as payload:
// (sorted codes, order), exactly torch.sort(codes, stable=True).
//
// Replaces the JAX package's in-VMEM bitonic sort
// (raytracebvh_tpu/ops/sort_pallas.py, _sort_kernel, launched by
// bitonic_sort_by_code): sort_backend 'bitonic', and 'auto' on CUDA.
//
// One 64-bit key an element: (code with its sign bit flipped) << 32 |
// index.  Unsigned order of the keys is the order of the pairs (code,
// index), a total order with no ties, so any correct sort of the keys is
// the stable sort of the codes, for every int32 code.  The kernels read
// the n codes and number them themselves; slots past n hold the key
// UINT64_MAX in registers and are never written, so the wrapper pads
// nothing and writes nothing before the launch.
//
// What bounds it on an H100: latency and barriers, not bytes (the large
// scene's 102 400 codes are 1.2 MB in and out).  The design keeps every
// compare-exchange it can in registers:
//  * A block sorts a tile of P = T * E keys (T threads, E keys each, in
//    the blocked layout: thread t holds elements t*E .. t*E+E-1).  Each
//    phase of the bitonic network with a stride below E is an exchange
//    between two registers of one thread; a stride below 32 E is a
//    __shfl_xor_sync with the lane that holds the partner; only a stride
//    that crosses warps goes through shared memory, with a barrier.  The
//    stages up to 32 E keys need no barrier at all.  For 4 096 keys
//    (E = 8, 512 threads) that is 14 barriers where the plain network
//    has 78 phases.
//  * n <= 16 384 (the dense scene's 3 072): one block, one launch, P the
//    power of two >= n (>= 32 E), and the block writes (sorted codes,
//    order) itself.
//  * n > 16 384 (the large scene's 102 400): blocks of 4 096-key tiles
//    (only the last tile is padded) write sorted runs of keys; then
//    each merge pass merges runs pairwise, one thread an element: its
//    place in the merged run is its place in its own run plus the count
//    of smaller keys in the other run (a binary search), so every pass
//    keeps every SM busy and, on a total order, is stable.  102 400
//    codes make 25 tiles and 5 passes: 6 launches, no padding to 131 072.
// The TPU kernel's row-group reshapes and static lane shuffles answered
// the (8, 128) vreg layout; none of it is carried over.

#include <cuda_runtime.h>

namespace {

using Key = unsigned long long;
constexpr Key kPadKey = ~0ull;
constexpr int kSmallMax = 16384;  // the most codes one block sorts
constexpr int kTileLog = 12;      // large route: keys a tile block sorts
constexpr int kMergeBlock = 256;

__device__ __forceinline__ Key make_key(const int* __restrict__ codes, int n,
                                        int i) {
  return i < n ? (static_cast<Key>(static_cast<unsigned>(codes[i]) ^
                                   0x80000000u) << 32) |
                     static_cast<unsigned>(i)
               : kPadKey;
}

__device__ __forceinline__ int key_code(Key k) {
  return static_cast<int>(static_cast<unsigned>(k >> 32) ^ 0x80000000u);
}

__device__ __forceinline__ int key_index(Key k) {
  return static_cast<int>(static_cast<unsigned>(k));
}

// a if it is the smaller and take_min, or the larger and not take_min
__device__ __forceinline__ Key pick(Key a, Key b, bool take_min) {
  return (a < b) == take_min ? a : b;
}

// Shared-memory slot of element i: one spare slot each E, so that the
// lanes of a warp reading their blocked keys spread over all banks.
template <int E>
__device__ __forceinline__ int slot(int i) {
  return i + i / E;
}

// The p-th pair of phase j: its lower element (bit j clear).
__device__ __forceinline__ int lower_of(int p, int j) {
  return ((p >> j) << (j + 1)) | (p & ((1 << j) - 1));
}

__host__ __device__ constexpr int log2_of(int e) {
  return e <= 1 ? 0 : 1 + log2_of(e / 2);
}

// Phases j_top .. 0 of stage k on one thread's keys v (elements base ..
// base + E - 1 of the tile), j_top < log2(32 E): the strides of a warp by
// shuffles, then the strides of a thread in registers.  Ascending where
// bit k of the element's index is clear.
template <int E>
__device__ __forceinline__ void register_phases(Key (&v)[E], int base,
                                                int lane, int k, int j_top) {
  constexpr int kLogE = log2_of(E);
  for (int j = j_top; j >= kLogE; --j) {
    const int lane_mask = 1 << (j - kLogE);
    const bool upper = (lane & lane_mask) != 0;
    const bool asc = ((base >> k) & 1) == 0;
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const Key other = __shfl_xor_sync(0xffffffffu, v[r], lane_mask);
      v[r] = pick(v[r], other, asc != upper);
    }
  }
#pragma unroll
  for (int j = kLogE - 1; j >= 0; --j) {
    if (j > j_top) continue;
    const int s = 1 << j;
#pragma unroll
    for (int r = 0; r < E; ++r) {
      if (r & s) continue;
      const bool asc = (((base + r) >> k) & 1) == 0;
      const Key a = v[r], b = v[r | s];
      v[r] = pick(a, b, asc);
      v[r | s] = pick(a, b, !asc);
    }
  }
}

// Sorts the tile of 2^tile_log keys at blockIdx.x << tile_log (T = blockDim.x
// = 2^tile_log / E threads, T >= 32): elements >= n are padding.  Final:
// writes (sorted codes, order) of the elements < n; else their keys.
template <int E, bool Final>
__global__ void __launch_bounds__(1024)
sort_tile_kernel(const int* __restrict__ codes, int n, int tile_log,
                 Key* __restrict__ keys_out, int* __restrict__ sorted_out,
                 int* __restrict__ order_out) {
  extern __shared__ Key sm[];
  constexpr int kLogW = log2_of(E) + 5;  // stages a warp sorts alone
  const int lane = threadIdx.x & 31;
  const int base = threadIdx.x * E;  // within the tile
  const int tile0 = blockIdx.x << tile_log;
  Key v[E];
#pragma unroll
  for (int r = 0; r < E; ++r) v[r] = make_key(codes, n, tile0 + base + r);

  const int k_reg = tile_log < kLogW ? tile_log : kLogW;
  for (int k = 1; k <= k_reg; ++k) register_phases<E>(v, base, lane, k, k - 1);
  const int half = 1 << (tile_log - 1);
  for (int k = kLogW + 1; k <= tile_log; ++k) {
    // each thread stores and later reloads only its own slots, so the
    // barrier after the store is the only one the hand-over needs
#pragma unroll
    for (int r = 0; r < E; ++r) sm[slot<E>(base + r)] = v[r];
    __syncthreads();
    for (int j = k - 1; j >= kLogW; --j) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int i = lower_of(p, j);
        const int l = i + (1 << j);
        const bool asc = ((i >> k) & 1) == 0;
        const Key a = sm[slot<E>(i)], b = sm[slot<E>(l)];
        sm[slot<E>(i)] = pick(a, b, asc);
        sm[slot<E>(l)] = pick(a, b, !asc);
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < E; ++r) v[r] = sm[slot<E>(base + r)];
    register_phases<E>(v, base, lane, k, kLogW - 1);
  }
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int i = tile0 + base + r;
    if (i < n) {
      if (Final) {
        sorted_out[i] = key_code(v[r]);
        order_out[i] = key_index(v[r]);
      } else {
        keys_out[i] = v[r];
      }
    }
  }
}

// One merge pass: runs of `run` sorted keys in `in` (the last may be
// short) merged pairwise.  Final: writes (sorted codes, order); else keys.
template <bool Final>
__global__ void __launch_bounds__(kMergeBlock)
merge_kernel(const Key* __restrict__ in, int n, long long run,
             Key* __restrict__ keys_out, int* __restrict__ sorted_out,
             int* __restrict__ order_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  const long long a0 = i / (2 * run) * (2 * run);
  const long long b0 = a0 + run;
  const Key key = in[i];
  long long rank, other0, other_len;
  if (i < b0) {  // in run A: count B's keys below it
    rank = i - a0;
    other0 = b0;
    other_len = b0 >= n ? 0 : (n - b0 < run ? n - b0 : run);
  } else {  // in run B: count A's keys below it
    rank = i - b0;
    other0 = a0;
    other_len = run;
  }
  long long lo = 0, hi = other_len;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(&in[other0 + mid]) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const long long dst = a0 + rank + lo;
  if (Final) {
    sorted_out[dst] = key_code(key);
    order_out[dst] = key_index(key);
  } else {
    keys_out[dst] = key;
  }
}

int log2_ceil(int n) {
  int k = 0;
  while ((1 << k) < n) ++k;
  return k;
}

template <int E, bool Final>
cudaError_t tile_launch(const int* codes, int n, int tile_log, Key* keys,
                        int* sorted, int* order, cudaStream_t stream) {
  constexpr int kLogW = log2_of(E) + 5;
  const int tile = 1 << tile_log;
  const size_t smem =
      tile_log > kLogW ? static_cast<size_t>(tile + tile / E) * sizeof(Key) : 0;
  auto kernel = sort_tile_kernel<E, Final>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (n + tile - 1) / tile;
  kernel<<<grid, tile / E, smem, stream>>>(codes, n, tile_log, keys, sorted,
                                           order);
  return cudaGetLastError();
}

}  // namespace

// (sorted, order)[0:n] = torch.sort(codes[0:n], stable=True), int32.
// scratch: 2n 8-byte keys for n > 16 384 (unused, may be null, below).
// Returns a cudaError_t.
extern "C" int rtbvh_sort_by_code(const int* codes, int n, int* sorted,
                                  int* order, void* scratch, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (n <= kSmallMax) {
    // P = 2^tile_log >= 32 E: at least one full warp
    const int tile_log = log2_ceil(n) < 8 ? 8 : log2_ceil(n);
    const cudaError_t err =
        tile_log <= 13
            ? tile_launch<8, true>(codes, n, tile_log, nullptr, sorted, order, s)
            : tile_launch<16, true>(codes, n, tile_log, nullptr, sorted, order,
                                    s);
    return static_cast<int>(err);
  }
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Key* buf[2] = {static_cast<Key*>(scratch), static_cast<Key*>(scratch) + n};
  cudaError_t err =
      tile_launch<8, false>(codes, n, kTileLog, buf[0], nullptr, nullptr, s);
  const int grid = (n + kMergeBlock - 1) / kMergeBlock;
  int cur = 0;
  for (long long run = 1 << kTileLog; run < n && err == cudaSuccess;
       run *= 2) {
    if (2 * run >= n) {
      merge_kernel<true><<<grid, kMergeBlock, 0, s>>>(buf[cur], n, run,
                                                      nullptr, sorted, order);
    } else {
      merge_kernel<false><<<grid, kMergeBlock, 0, s>>>(
          buf[cur], n, run, buf[1 - cur], nullptr, nullptr);
    }
    err = cudaGetLastError();
    cur = 1 - cur;
  }
  return static_cast<int>(err);
}
