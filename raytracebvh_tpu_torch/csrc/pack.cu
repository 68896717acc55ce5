// The build's leaf pack: every table a frame reads from the tree, written
// in one launch after the links (raytracebvh_tpu_torch/pipeline.py
// assemble_bvh's tail, then ops/traverse_cuda.py pack_tables):
//
//   leaf_attrs [n, 40]  t0|t1|t2 xyz, n0|n1|n2, uv0|uv1|uv2, then the
//     material's ambient, diffuse, specular, shininess, optical density,
//     alpha and tex_id (an integer-valued float), for the face prim[i]
//     (face 0 for a padding leaf, prim -1, as clamp(prim, min=0) gives);
//   tri_mat [n]         the face's material index;
//   K1's leaf table [n, 12]  v0, e1 = v1 - v0, e2 = v2 - v0, zeros;
//   K1's node table [2n, 8]  bbmin, bbmax, and the entry and skip links as
//     int32 bits.
//
// It replaces no TPU kernel: the JAX package leaves the pack to XLA,
// which fuses it.  Plain PyTorch runs it as ~30 gathers, stacks and
// concatenations, each writing a table that narrow columns (3, 2 or 1
// floats wide) fill, and each read again by the next.
//
// What bounds it on an H100: bytes.  At n = 1 048 576 leaves it reads the
// sorted prim, each face's 3 indices and 3 corners of 32 bytes (position,
// normal, uv), the material index and the [2n] boxes and links, ~190 MB,
// and writes ~290 MB: ~0.14 ms at 3.35 TB/s.  The design: one thread a
// leaf t, which writes node rows t and n + t (two 16-byte stores each, a
// warp's pair filling 1 KB end to end) and leaf row t, its corners read
// once and kept in registers for the three leaf tables.  The attribute
// and K1 rows go through shared memory: each thread stores its row there,
// and the warp then copies its 32 rows out as one contiguous block, lane
// by lane in 16-byte words.  Stored straight from each thread, a warp's
// store hits 32 rows a stride of 160 or 48 bytes apart, and the pack took
// 0.48 ms on an H100 (700 W) at n = 1 048 576; staged, 0.18 ms, about a
// plain copy of the same bytes.  The staged row is padded to 11 words of
// 16 bytes, so a warp's stores into it meet no bank conflict.

// Parity with the plain PyTorch version, bit for bit: every value but
// three is a copy, moved as its 32-bit pattern (so a NaN keeps its
// payload); the two edges are one IEEE subtraction each, as PyTorch's
// elementwise subtraction computes them, and tex_id's conversion rounds
// to nearest, as Tensor.to(float32) does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct PackIn {
  const int* prim;       // [n], -1 = padding
  const int* indices;    // [nf * 3]
  const int* verts;      // [nv, 3] float32 bits
  const int* normals;    // [nv, 3] float32 bits
  const int* uv;         // [nv, 2] float32 bits
  const int* mat_index;  // [nf]
  const int* ambient;    // [k, 4] float32 bits
  const int* diffuse;    // [k, 4]
  const int* specular;   // [k, 4]
  const int* shininess;  // [k]
  const int* optical_density;  // [k]
  const int* alpha;      // [k]
  const int* tex_id;     // [k] int32
  const int* bbmin;      // [2n, 3] float32 bits
  const int* bbmax;      // [2n, 3]
  const int* entry;      // [2n]
  const int* skip;       // [2n]
};

struct PackOut {
  int4* leaf_attrs;  // [n, 40] float32 bits: 10 int4 a row
  int* tri_mat;      // [n]
  int4* node_table;  // [2n, 8]: 2 int4 a row
  float4* leaf_table;  // [n, 12]: 3 float4 a row
};

__device__ __forceinline__ int ld(const int* p, size_t i) {
  return __ldg(p + i);
}

__device__ __forceinline__ void node_row(const PackIn& a, int4* out,
                                         size_t i) {
  out[2 * i] = make_int4(ld(a.bbmin, 3 * i), ld(a.bbmin, 3 * i + 1),
                         ld(a.bbmin, 3 * i + 2), ld(a.bbmax, 3 * i));
  out[2 * i + 1] = make_int4(ld(a.bbmax, 3 * i + 1), ld(a.bbmax, 3 * i + 2),
                             ld(a.entry, i), ld(a.skip, i));
}

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kRow = 11;  // a staged attribute row: 10 words of 16 B + 1

__global__ void __launch_bounds__(kBlock)
    leaf_pack_kernel(PackIn a, int n, PackOut o) {
  __shared__ int4 stage[kWarps][32 * kRow];
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const size_t N = static_cast<size_t>(n);
  const int first = t - lane;  // the warp's first leaf
  if (first >= n) return;  // the whole warp: no __syncwarp below waits
  const int rows = n - first < 32 ? n - first : 32;  // the warp's leaves
  int4* buf = stage[threadIdx.x >> 5];
  float f[3][3];
  if (t < n) {
    node_row(a, o.node_table, t);
    node_row(a, o.node_table, N + t);

    const int p = ld(a.prim, t);
    const size_t face = p < 0 ? 0 : static_cast<size_t>(p);
    int v[3][3], nr[3][3], uv[3][2];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const size_t c = static_cast<size_t>(ld(a.indices, 3 * face + k));
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        v[k][j] = ld(a.verts, 3 * c + j);
        nr[k][j] = ld(a.normals, 3 * c + j);
        f[k][j] = __int_as_float(v[k][j]);
      }
      uv[k][0] = ld(a.uv, 2 * c);
      uv[k][1] = ld(a.uv, 2 * c + 1);
    }
    const int m = ld(a.mat_index, face);
    const size_t m4 = 4 * static_cast<size_t>(m);
    const float tex = static_cast<float>(ld(a.tex_id, m));
    o.tri_mat[t] = m;

    int4* row = buf + lane * kRow;
    row[0] = make_int4(v[0][0], v[0][1], v[0][2], v[1][0]);
    row[1] = make_int4(v[1][1], v[1][2], v[2][0], v[2][1]);
    row[2] = make_int4(v[2][2], nr[0][0], nr[0][1], nr[0][2]);
    row[3] = make_int4(nr[1][0], nr[1][1], nr[1][2], nr[2][0]);
    row[4] = make_int4(nr[2][1], nr[2][2], uv[0][0], uv[0][1]);
    row[5] = make_int4(uv[1][0], uv[1][1], uv[2][0], uv[2][1]);
    row[6] = make_int4(ld(a.ambient, m4), ld(a.ambient, m4 + 1),
                       ld(a.ambient, m4 + 2), ld(a.ambient, m4 + 3));
    row[7] = make_int4(ld(a.diffuse, m4), ld(a.diffuse, m4 + 1),
                       ld(a.diffuse, m4 + 2), ld(a.diffuse, m4 + 3));
    row[8] = make_int4(ld(a.specular, m4), ld(a.specular, m4 + 1),
                       ld(a.specular, m4 + 2), ld(a.specular, m4 + 3));
    row[9] = make_int4(ld(a.shininess, m), ld(a.optical_density, m),
                       ld(a.alpha, m), __float_as_int(tex));
  }
  __syncwarp();
  int4* attrs = o.leaf_attrs + 10 * static_cast<size_t>(first);
  for (int j = lane; j < 10 * rows; j += 32) {
    attrs[j] = buf[(j / 10) * kRow + j % 10];
  }
  __syncwarp();

  if (t < n) {  // K1's leaf row: v0, e1, e2, zeros; 3 words of 16 B
    float4* k1 = reinterpret_cast<float4*>(buf) + 3 * lane;
    const float e1x = f[1][0] - f[0][0], e1y = f[1][1] - f[0][1],
                e1z = f[1][2] - f[0][2];
    const float e2x = f[2][0] - f[0][0], e2y = f[2][1] - f[0][1],
                e2z = f[2][2] - f[0][2];
    k1[0] = make_float4(f[0][0], f[0][1], f[0][2], e1x);
    k1[1] = make_float4(e1y, e1z, e2x, e2y);
    k1[2] = make_float4(e2z, 0.f, 0.f, 0.f);
  }
  __syncwarp();
  int4* table =
      reinterpret_cast<int4*>(o.leaf_table) + 3 * static_cast<size_t>(first);
  for (int j = lane; j < 3 * rows; j += 32) table[j] = buf[j];
}

}  // namespace

extern "C" int rtbvh_leaf_pack(
    const int* prim, const int* indices, const void* verts,
    const void* normals, const void* uv, const int* mat_index,
    const void* ambient, const void* diffuse, const void* specular,
    const void* shininess, const void* optical_density, const void* alpha,
    const int* tex_id, const void* bbmin, const void* bbmax,
    const int* entry, const int* skip, int n, void* leaf_attrs,
    int* tri_mat, void* node_table, void* leaf_table, void* stream) {
  const PackIn a{prim, indices,
                 static_cast<const int*>(verts),
                 static_cast<const int*>(normals),
                 static_cast<const int*>(uv), mat_index,
                 static_cast<const int*>(ambient),
                 static_cast<const int*>(diffuse),
                 static_cast<const int*>(specular),
                 static_cast<const int*>(shininess),
                 static_cast<const int*>(optical_density),
                 static_cast<const int*>(alpha), tex_id,
                 static_cast<const int*>(bbmin),
                 static_cast<const int*>(bbmax), entry, skip};
  const PackOut o{static_cast<int4*>(leaf_attrs), tri_mat,
                  static_cast<int4*>(node_table),
                  static_cast<float4*>(leaf_table)};
  if (n > 0) {
    leaf_pack_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(a, n, o);
  }
  return static_cast<int>(cudaGetLastError());
}
