// The frames' shading: the arithmetic of one shading pass of
// raytracebvh_tpu_torch/pipeline.py (_shade_hit_soa, then the colour and
// spawn logic of _launch_soa, _bounce_soa or _bounce_refract_soa) as two
// kernels, one thread per ray, around the pass's texture gather (K2):
//
//   shade_surface_kernel  reads the gathered [40, R] leaf block's corner,
//     normal, uv and texture-id channels, the rays and the hit flag, and
//     writes the hit position [3, R], the interpolated normal [3, R], the
//     texel quad's row [R] and the bilinear fractions [2, R]: the
//     Moeller-Trumbore distance recomputed, the barycentric weights, and
//     ops/shade.py sample_texture_quads up to the row index.
//   shade_finish_kernel<Kind>  reads K2's [16, R] quad block, the material
//     channels 24-39, the first kernel's outputs, the rays, the hit flag,
//     the shadow factor (nullable) and, in bounces, the carried colour and
//     intensity, and writes what the plain pass returns: colour, spawned
//     rays and intensities.  Kind: kLaunch (the primary pass, both
//     spawns), kBounce (a reflection pass), kRefract (a transmission pass).
//
// It replaces no TPU kernel: the JAX package leaves the shading to XLA,
// which fuses it.  Plain PyTorch runs each operation as its own kernel
// (~380 a primary pass), each reading and writing [R] float tensors.
//
// What bounds it on an H100: bytes.  A ray's pass reads ~25 + 16 of the
// block's 40 channels, the 16 texels, its ray, hit flag and carried state,
// and writes its colour and spawns, ~430 bytes a ray or ~0.9 GB at 1080p
// (0.27 ms at 3.35 TB/s); the arithmetic, ~300 float operations a ray, is
// a tenth of that time.  The design: channel-major loads and stores, a
// warp's 32 rays on 32 neighbouring floats of each channel, so every
// access coalesces; one pass over the block, its channels read once (the
// texture id twice); the quad gather stays K2, whose launches the
// benchmark's gather roofline times.
//
// Parity with the plain PyTorch version, bit for bit on every output and
// every lane, hit or not: each PyTorch operation is one IEEE operation
// here, in the same order (the library is built with -fmad=false, so no
// product is fused into a sum; Python's left-to-right sums are kept as
// written).  Python scalars enter as float32 constants, as PyTorch casts
// them.  1.0 / x is PyTorch's reciprocal times 1, one IEEE division;
// ops/ieee.py's div(x, 1000.0) is a true division, x / 1000.0f; its sqrt
// (a float64 root rounded once) equals IEEE sqrtf.  torch.clamp returns
// NaN for NaN (clamp_nan below), the .to(int32) casts truncate, and
// torch.where selects, so lanes that miss compute on the block's row as
// the plain path does and select the same values.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Kind { kLaunch = 0, kBounce = 1, kRefract = 2 };

struct F3 {
  float x, y, z;
};

// three component arrays of one vector, element i at p[k][i * stride]
struct Vec3In {
  const float* p[3];
  long long stride;
};

__device__ __forceinline__ F3 load3(const Vec3In& v, int r) {
  const long long i = static_cast<long long>(r) * v.stride;
  return {v.p[0][i], v.p[1][i], v.p[2][i]};
}

// component k of a channel-major [3, R] block
__device__ __forceinline__ void store3(float* out, size_t R, int r, F3 v) {
  out[r] = v.x;
  out[R + r] = v.y;
  out[2 * R + r] = v.z;
}

__device__ __forceinline__ F3 load_block3(const float* in, size_t R, int r) {
  return {in[r], in[R + r], in[2 * R + r]};
}

__device__ __forceinline__ F3 sub3(F3 a, F3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}

__device__ __forceinline__ F3 cross3(F3 a, F3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ float dot3(F3 a, F3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ float norm3(F3 a) { return sqrtf(dot3(a, a)); }

__device__ __forceinline__ F3 select3(bool c, F3 a, F3 b) {
  return c ? a : b;
}

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min_nan(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// torch.clamp(x, lo, hi)
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// ops/shade.py normalize3 (eps 1e-30)
__device__ __forceinline__ F3 normalize3(F3 v) {
  const float inv = 1.0f / clamp_min_nan(norm3(v), 1e-30f);
  return {v.x * inv, v.y * inv, v.z * inv};
}

// ops/shade.py reflect3
__device__ __forceinline__ F3 reflect3(F3 d, F3 n) {
  const float s = dot3(d, n) * 2.0f;
  return {d.x - s * n.x, d.y - s * n.y, d.z - s * n.z};
}

// ops/shade.py refract3: the raw (unnormalised) direction, 0 on total
// internal reflection
__device__ __forceinline__ F3 refract3(F3 d, F3 n, float eta) {
  const float cosi = dot3(d, n);
  const float k = 1.0f - eta * eta * (1.0f - cosi * cosi);
  const float s = eta * cosi + sqrtf(clamp_min_nan(k, 0.0f));
  if (!(k >= 0.0f)) return {0.0f, 0.0f, 0.0f};
  return {eta * d.x - s * n.x, eta * d.y - s * n.y, eta * d.z - s * n.z};
}

struct SurfaceArgs {
  const float* a;  // [40, R] gathered leaf block
  Vec3In o, d;
  const unsigned char* hit;
  const int* tex_hw;  // [ntex, 2] int32 (h, w)
  int ntex, hmax, wmax, nrays;
  float* pos;     // [3, R]
  float* normal;  // [3, R]
  int* flat;      // [R]
  float* frac;    // [2, R] (fx, fy)
};

__global__ void shade_surface_kernel(const SurfaceArgs s) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= s.nrays) return;
  const size_t R = static_cast<size_t>(s.nrays);
  const float* a = s.a + r;
  const auto ch = [&](int c) { return __ldg(a + c * R); };
  const F3 t0{ch(0), ch(1), ch(2)};
  const F3 t1{ch(3), ch(4), ch(5)};
  const F3 t2{ch(6), ch(7), ch(8)};
  const F3 o = load3(s.o, r);
  const F3 d = load3(s.d, r);
  const bool hit = s.hit[r] != 0;

  // the hit distance, recomputed as Moeller-Trumbore
  const F3 e1 = sub3(t1, t0);
  const F3 e2 = sub3(t2, t0);
  const F3 p = cross3(d, e2);
  const float det = dot3(e1, p);
  const bool det_ok = fabsf(det) >= 1e-12f;
  const float inv_det = det_ok ? 1.0f / det : 0.0f;
  const F3 tv = sub3(o, t0);
  const float u = dot3(tv, p) * inv_det;
  const F3 q = cross3(tv, e1);
  const float v = dot3(d, q) * inv_det;
  float t = dot3(e2, q) * inv_det;
  const bool ok = det_ok && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                  u + v <= 1.0f && t > 1e-12f;
  t = ok ? t : -1.0f;
  t = hit ? t : 0.0f;
  const F3 P{o.x + d.x * t, o.y + d.y * t, o.z + d.z * t};

  // barycentric weights (ops/shade.py barycentric_weights3)
  const F3 v0 = sub3(t0, P);
  const F3 v1 = sub3(t1, P);
  const F3 v2 = sub3(t2, P);
  float a0 = norm3(cross3(sub3(t0, t1), sub3(t0, t2)));
  a0 = a0 == 0.0f ? 1.0f : a0;
  const float w0 = norm3(cross3(v1, v2)) / a0;
  const float w1 = norm3(cross3(v2, v0)) / a0;
  const float w2 = norm3(cross3(v0, v1)) / a0;

  const F3 N{ch(9) * w0 + ch(12) * w1 + ch(15) * w2,
             ch(10) * w0 + ch(13) * w1 + ch(16) * w2,
             ch(11) * w0 + ch(14) * w1 + ch(17) * w2};
  float uvu = ch(18) * w0 + ch(20) * w1 + ch(22) * w2;
  float uvv = ch(19) * w0 + ch(21) * w1 + ch(23) * w2;

  // the quad row and bilinear fractions (sample_texture_quads)
  const int tex_id = static_cast<int>(ch(39));
  uvu = hit ? uvu : 0.0f;
  uvv = hit ? uvv : 0.0f;
  const int tid = tex_id < 0 ? 0 : tex_id;
  const int k = s.ntex == 1 ? 0 : tid;
  const float h = static_cast<float>(s.tex_hw[2 * k]);
  const float w = static_cast<float>(s.tex_hw[2 * k + 1]);
  const float uu = uvu - floorf(uvu);
  const float vv = uvv - floorf(uvv);
  const float x = uu * w - 0.5f;
  const float y = vv * h - 0.5f;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  int xi = static_cast<int>(x0);
  int yi = static_cast<int>(y0);
  xi = xi < 0 ? xi + static_cast<int>(w) : xi;
  yi = yi < 0 ? yi + static_cast<int>(h) : yi;
  // int32 arithmetic that wraps, as the int32 tensors' does
  const unsigned int row =
      (static_cast<unsigned int>(tid) * static_cast<unsigned int>(s.hmax) +
       static_cast<unsigned int>(yi)) *
          static_cast<unsigned int>(s.wmax) +
      static_cast<unsigned int>(xi);

  store3(s.pos, R, r, P);
  store3(s.normal, R, r, N);
  s.flat[r] = static_cast<int>(row);
  s.frac[r] = x - x0;
  s.frac[R + r] = y - y0;
}

struct FinishArgs {
  const float* a;  // [40, R] gathered leaf block
  const float* q;  // [16, R] gathered texel quads
  const float* pos;
  const float* normal;
  const float* frac;
  Vec3In o, d;
  const unsigned char* hit;
  const float* vis;       // [R] shadow factor, nullable (launch only)
  const float* color[4];  // carried colour (bounces)
  const float* intensity;  // carried intensity (bounces)
  int nrays;
  float bg[4];
  float reflection_decay, refraction_decay, offset, intensity_min;
  float* out_color;  // [4, R]
  float* out_o;      // [3, R]
  float* out_d;      // [3, R]
  float* out_int;    // [R]
  float* out_o2;     // [3, R] the launch's refraction spawn
  float* out_d2;     // [3, R]
  float* out_int2;   // [R]
};

template <int K>
__global__ void shade_finish_kernel(const FinishArgs s) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= s.nrays) return;
  const size_t R = static_cast<size_t>(s.nrays);
  const float* a = s.a + r;
  const auto ch = [&](int c) { return __ldg(a + c * R); };
  const float* qr = s.q + r;
  const auto texel = [&](int c) { return __ldg(qr + c * R); };

  // the bilinear sample; tex_id -1 samples white
  const bool has_tex = static_cast<int>(ch(39)) >= 0;
  const float fx = s.frac[r];
  const float fy = s.frac[R + r];
  const float w00 = (1.0f - fx) * (1.0f - fy);
  const float w10 = fx * (1.0f - fy);
  const float w01 = (1.0f - fx) * fy;
  const float w11 = fx * fy;
  // saturate(ambient + vis * diffuse * tex) * specular
  float hc[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float col = texel(c) * w00 + texel(4 + c) * w10 +
                      texel(8 + c) * w01 + texel(12 + c) * w11;
    const float tex = has_tex ? col : 1.0f;
    const float diffuse =
        s.vis == nullptr ? ch(28 + c) : s.vis[r] * ch(28 + c);
    hc[c] = clamp_nan(ch(24 + c) + diffuse * tex, 0.0f, 1.0f) * ch(32 + c);
  }
  const float shininess = ch(36);
  const float optical = ch(37);
  const float alpha = ch(38);

  const F3 P = load_block3(s.pos, R, r);
  const F3 N = load_block3(s.normal, R, r);
  const F3 o = load3(s.o, r);
  const F3 d = load3(s.d, r);
  const bool rec_hit = s.hit[r] != 0;

  if (K == kLaunch) {
    const bool hit = rec_hit;
#pragma unroll
    for (int c = 0; c < 4; ++c) s.out_color[c * R + r] = hit ? hc[c] : s.bg[c];
    s.out_int[r] = hit ? (shininess / 1000.0f) * s.reflection_decay : 0.0f;
    const F3 refl = normalize3(reflect3(d, N));
    const F3 off{N.x * s.offset, N.y * s.offset, N.z * s.offset};
    store3(s.out_o, R, r,
           select3(hit, F3{P.x + off.x, P.y + off.y, P.z + off.z}, o));
    store3(s.out_d, R, r, select3(hit, refl, d));
    const F3 raw = refract3(d, N, optical);
    const bool tir = dot3(raw, raw) == 0.0f;
    const bool live_q = hit && !tir;
    s.out_int2[r] = live_q ? (1.0f - alpha) * s.refraction_decay : 0.0f;
    store3(s.out_o2, R, r,
           select3(hit, F3{P.x - off.x, P.y - off.y, P.z - off.z}, o));
    store3(s.out_d2, R, r, select3(live_q, normalize3(raw), d));
    return;
  }

  // a bounce: live rays lerp toward what they hit (the background on a
  // miss) and respawn; dead rays keep their colour
  const float inten = s.intensity[r];
  const bool live = inten > s.intensity_min;
  const bool hit = rec_hit && live;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float cur = s.color[c][r];
    const float target = hit ? hc[c] : s.bg[c];
    s.out_color[c * R + r] = live ? cur + inten * (target - cur) : cur;
  }
  const F3 off{N.x * s.offset, N.y * s.offset, N.z * s.offset};
  if (K == kBounce) {
    const bool upd = live && hit;
    s.out_int[r] =
        upd ? ((inten * shininess) / 1000.0f) * s.reflection_decay : 0.0f;
    const F3 refl = normalize3(reflect3(d, N));
    store3(s.out_o, R, r,
           select3(upd, F3{P.x + off.x, P.y + off.y, P.z + off.z}, o));
    store3(s.out_d, R, r, select3(upd, refl, d));
  } else {
    const F3 raw = refract3(d, N, optical);
    const bool tir = dot3(raw, raw) == 0.0f;
    const bool upd = live && hit && !tir;
    s.out_int[r] = upd ? (inten * (1.0f - alpha)) * s.refraction_decay : 0.0f;
    store3(s.out_o, R, r,
           select3(upd, F3{P.x - off.x, P.y - off.y, P.z - off.z}, o));
    store3(s.out_d, R, r, select3(upd, normalize3(raw), d));
  }
}

int blocks_for(int nrays, int block) { return (nrays + block - 1) / block; }

Vec3In vec3(const float* x, const float* y, const float* z, long long stride) {
  Vec3In v;
  v.p[0] = x;
  v.p[1] = y;
  v.p[2] = z;
  v.stride = stride;
  return v;
}

constexpr int kBlock = 256;

}  // namespace

extern "C" int rtbvh_shade_surface(
    const float* a, const float* ox, const float* oy, const float* oz,
    long long o_stride, const float* dx, const float* dy, const float* dz,
    long long d_stride, const unsigned char* hit, const int* tex_hw, int ntex,
    int hmax, int wmax, int nrays, float* pos, float* normal, int* flat,
    float* frac, void* stream) {
  if (nrays > 0) {
    SurfaceArgs s;
    s.a = a;
    s.o = vec3(ox, oy, oz, o_stride);
    s.d = vec3(dx, dy, dz, d_stride);
    s.hit = hit;
    s.tex_hw = tex_hw;
    s.ntex = ntex;
    s.hmax = hmax;
    s.wmax = wmax;
    s.nrays = nrays;
    s.pos = pos;
    s.normal = normal;
    s.flat = flat;
    s.frac = frac;
    shade_surface_kernel<<<blocks_for(nrays, kBlock), kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtbvh_shade_finish(
    int kind, const float* a, const float* q, const float* pos,
    const float* normal, const float* frac, const float* ox, const float* oy,
    const float* oz, long long o_stride, const float* dx, const float* dy,
    const float* dz, long long d_stride, const unsigned char* hit,
    const float* vis, const float* c0, const float* c1, const float* c2,
    const float* c3, const float* intensity, int nrays, float bg0, float bg1,
    float bg2, float bg3, float reflection_decay, float refraction_decay,
    float offset, float intensity_min, float* out_color, float* out_o,
    float* out_d, float* out_int, float* out_o2, float* out_d2,
    float* out_int2, void* stream) {
  if (kind < kLaunch || kind > kRefract) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nrays > 0) {
    FinishArgs s;
    s.a = a;
    s.q = q;
    s.pos = pos;
    s.normal = normal;
    s.frac = frac;
    s.o = vec3(ox, oy, oz, o_stride);
    s.d = vec3(dx, dy, dz, d_stride);
    s.hit = hit;
    s.vis = vis;
    s.color[0] = c0;
    s.color[1] = c1;
    s.color[2] = c2;
    s.color[3] = c3;
    s.intensity = intensity;
    s.nrays = nrays;
    s.bg[0] = bg0;
    s.bg[1] = bg1;
    s.bg[2] = bg2;
    s.bg[3] = bg3;
    s.reflection_decay = reflection_decay;
    s.refraction_decay = refraction_decay;
    s.offset = offset;
    s.intensity_min = intensity_min;
    s.out_color = out_color;
    s.out_o = out_o;
    s.out_d = out_d;
    s.out_int = out_int;
    s.out_o2 = out_o2;
    s.out_d2 = out_d2;
    s.out_int2 = out_int2;
    const dim3 grid(blocks_for(nrays, kBlock));
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (kind == kLaunch) {
      shade_finish_kernel<kLaunch><<<grid, kBlock, 0, st>>>(s);
    } else if (kind == kBounce) {
      shade_finish_kernel<kBounce><<<grid, kBlock, 0, st>>>(s);
    } else {
      shade_finish_kernel<kRefract><<<grid, kBlock, 0, st>>>(s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
