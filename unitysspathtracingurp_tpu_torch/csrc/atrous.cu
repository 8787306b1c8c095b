// A1: one edge-avoiding À-Trous iteration (shader pass 5,
// ScreenSpacePathTracing.shader:421-639).
//
// Replaces unitysspathtracingurp_tpu/ops/atrous.py atrous_filter
// (:32-151), which the JAX package writes in XLA as some 200 whole-image
// operations an iteration (every dilation radius as a static shift, then
// a per-pixel select). It is no Pallas kernel; in plain PyTorch it is
// ~150 small launches an iteration, up to five iterations a frame. The
// plain PyTorch version is ops/atrous.py atrous_filter_ref.
//
// Per pixel: the blur gate from the history sample count, its remap
// 1 - (1 - b)^4; sky and blur-0 pixels pass through. Else the dilation
// radius floor(3 + 6 hash(x, y + row_offset, 1)), then 9 taps of the 3x3
// Gaussian at that radius with clamp-to-edge addressing, each weighted by
// exp(-|dc|^2 1.1) exp(-|de|^2 2000) exp(-|dn|^2 20) exp(-|d sqrt a|^2 400)
// (each capped at 1), and the center blended toward the weighted mean by
// the remapped gate. With refraction (REFR), a refractive texel takes the
// transparent normal / albedo where that layer is non-zero, and a
// refractive center drops the emission weight.
//
// What bounds it. Bytes: each pixel's color, emission, normal and albedo
// (3 floats each), its count and depth read once, its color written once:
// 68 B a pixel, 141 MB at 1080p, 0.042 ms at 3.35 TB/s (REFR adds the
// transparent type, normal and albedo: 32 B). The taps re-read
// neighbours within 9 px; those reads hit L1 / L2. The arithmetic is
// ~560 f32 operations a filtered pixel (its 36 exp counted as one each),
// ~1.2 GFLOP at 1080p, 0.017 ms at the f32 rate: the bytes bound it. The
// weights are per-pixel nonlinear functions of each tap (exp of squared
// differences), not a product of two operands: tensor cores do not apply.
//
// The design: one thread a pixel in 32 x 8 blocks, every read through
// __ldg (read-only path, L1). Each pixel's taps sit at its own hashed
// radius of 3-9 px, so a warp's load of a tap with dy != 0 lands on up to
// seven rows. On the H100 that scatter is about a fifth of the kernel's
// time, the 27 square roots of tap albedos a twentieth and expf against
// __expf a fiftieth (scripts/atrous_ablation.py); the rest is the
// arithmetic. Designs that read each texel once from shared memory (a
// tile of the block's pixels and a 9-px halo; a ring of rows walked down
// a 32-column strip with the next rows fetched by cp.async behind the
// taps) were measured against this one on the same inputs and lost:
// their fill costs more than the scatter it saves (the script's tile-*
// and ring-* copies). The radius is hashed by each thread for itself in
// uint32 arithmetic (the plain version's int64 with masks gives the same
// bits). One launch an iteration: an iteration reads its neighbours'
// previous output up to 9 px away, so iterations cannot fuse in one
// launch without a halo exchange across blocks.
//
// Numerics: --fmad=false, IEEE divides and square roots, expf (no fast
// math), and every expression in the order of the plain version: channel
// sums (x*x + y*y) + z*z, the weight product left to right, the taps
// summed in order from 0. Clamps propagate NaN as torch.clamp does. Each
// output bit equals atrous_filter_ref's on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BX = 32, BY = 8;
constexpr int SURFACE_TYPE_REFRACTION = 2;

// The 3x3 Gaussian's weight of tap k (row-major, center 4).
__host__ __device__ constexpr float tap_weight(int k) {
  return k == 4 ? 0.25f : (k & 1) ? 0.125f : 0.0625f;
}

struct Args {
  const float* color;     // (H, W, 3)
  const float* emission;  // (H, W, 3)
  const float* normal;    // (H, W, 3)
  const float* albedo;    // (H, W, 3)
  const float* count;     // (H, W) history sample count
  const float* depth;     // (H, W) layer-1 raw depth
  const int64_t* t_type;  // (H, W) transparent surface type (REFR)
  const float* t_normal;  // (H, W, 3) (REFR)
  const float* t_albedo;  // (H, W, 3) (REFR)
  float* out;             // (H, W, 3)
  int h, w, row_offset;
  float max_n, inv_n;
};

// torch.clamp's: NaN stays NaN.
__device__ __forceinline__ float clamp_max(float x, float hi) { return isnan(x) ? x : fminf(x, hi); }
__device__ __forceinline__ float clamp_min(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }
__device__ __forceinline__ float saturate(float x) {
  return isnan(x) ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ uint32_t jenkins(uint32_t x) {
  x += x << 10;
  x ^= x >> 6;
  x += x << 3;
  x ^= x >> 11;
  x += x << 15;
  return x;
}

// ops/rng.py hashed_random_float: 23 hashed mantissa bits in [1, 2), minus 1.
__device__ __forceinline__ float hashed_random_float(uint32_t x, uint32_t y, uint32_t z) {
  const uint32_t m = jenkins(x ^ jenkins(y ^ jenkins(z)));
  return __uint_as_float((m & 0x007FFFFFu) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ float sum_sq(float a, float b, float c) { return a * a + b * b + c * c; }

__device__ __forceinline__ void load3(const float* p, int i, float v[3]) {
  v[0] = __ldg(p + 3 * i);
  v[1] = __ldg(p + 3 * i + 1);
  v[2] = __ldg(p + 3 * i + 2);
}

// The normal and albedo guides of texel q.
template <bool REFR>
__device__ __forceinline__ void guides(const Args& a, int q, float n[3], float al[3]) {
  load3(a.normal, q, n);
  load3(a.albedo, q, al);
  if (REFR && __ldg(a.t_type + q) == SURFACE_TYPE_REFRACTION) {
    float t[3];
    load3(a.t_normal, q, t);
    if (t[0] != 0.0f || t[1] != 0.0f || t[2] != 0.0f) {
      n[0] = t[0];
      n[1] = t[1];
      n[2] = t[2];
    }
    load3(a.t_albedo, q, t);
    if (t[0] != 0.0f || t[1] != 0.0f || t[2] != 0.0f) {
      al[0] = t[0];
      al[1] = t[1];
      al[2] = t[2];
    }
  }
}

template <bool REFR>
__global__ void __launch_bounds__(BX * BY) atrous_kernel(Args a) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= a.w || y >= a.h) return;
  const int p = y * a.w + x;
  float c[3];
  load3(a.color, p, c);
  float* o = a.out + 3 * static_cast<size_t>(p);
  const float ratio = __ldg(a.count + p) / a.max_n;
  const float blur = 1.0f - saturate(clamp_max(ratio, a.max_n) - a.inv_n);
  if (__ldg(a.depth + p) == 0.0f || blur == 0.0f) {
    o[0] = c[0];
    o[1] = c[1];
    o[2] = c[2];
    return;
  }
  float inv = 1.0f - blur;
  inv = inv * inv;
  inv = inv * inv;
  const float remapped = 1.0f - inv;
  const uint32_t hy = static_cast<uint32_t>(y) + static_cast<uint32_t>(a.row_offset);
  const int r = static_cast<int>(floorf(3.0f + 6.0f * hashed_random_float(x, hy, 1u)));

  float cn[3], ca[3], ce[3];
  guides<REFR>(a, p, cn, ca);
  const bool use_ew = !REFR || __ldg(a.t_type + p) != SURFACE_TYPE_REFRACTION;
  load3(a.emission, p, ce);
  if (!use_ew) ce[0] = ce[1] = ce[2] = 0.0f;
  const float sa[3] = {sqrtf(clamp_min(ca[0], 0.0f)), sqrtf(clamp_min(ca[1], 0.0f)),
                       sqrtf(clamp_min(ca[2], 0.0f))};

  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, sw = 0.0f;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int dx = k % 3 - 1, dy = k / 3 - 1;
    const int qx = min(max(x + dx * r, 0), a.w - 1);
    const int qy = min(max(y + dy * r, 0), a.h - 1);
    const int q = qy * a.w + qx;
    float tc[3], te[3], tn[3], ta[3];
    load3(a.color, q, tc);
    load3(a.emission, q, te);
    guides<REFR>(a, q, tn, ta);
    const float cw = clamp_max(expf(-sum_sq(c[0] - tc[0], c[1] - tc[1], c[2] - tc[2]) * 1.1f), 1.0f);
    float ew = clamp_max(
        expf(-sum_sq(ce[0] - te[0], ce[1] - te[1], ce[2] - te[2]) * 2000.0f), 1.0f);
    if (!use_ew) ew = 1.0f;
    const float nw = clamp_max(
        expf(-clamp_min(sum_sq(cn[0] - tn[0], cn[1] - tn[1], cn[2] - tn[2]), 0.0f) * 20.0f),
        1.0f);
    const float aw = clamp_max(
        expf(-sum_sq(sa[0] - sqrtf(clamp_min(ta[0], 0.0f)), sa[1] - sqrtf(clamp_min(ta[1], 0.0f)),
                     sa[2] - sqrtf(clamp_min(ta[2], 0.0f))) *
             400.0f),
        1.0f);
    const float wt = cw * ew * nw * aw * tap_weight(k);
    s0 = s0 + tc[0] * wt;
    s1 = s1 + tc[1] * wt;
    s2 = s2 + tc[2] * wt;
    sw = sw + wt;
  }
  const float den = clamp_min(sw, 1e-12f);
  o[0] = c[0] + (s0 / den - c[0]) * remapped;
  o[1] = c[1] + (s1 / den - c[1]) * remapped;
  o[2] = c[2] + (s2 / den - c[2]) * remapped;
}

}  // namespace

extern "C" int sspt_atrous(const void* color, const void* emission, const void* normal,
                           const void* albedo, const void* count, const void* depth,
                           const void* t_type, const void* t_normal, const void* t_albedo,
                           void* out, int h, int w, int row_offset, int refr, float max_n,
                           float inv_n, void* stream) {
  const Args a = {static_cast<const float*>(color),    static_cast<const float*>(emission),
                  static_cast<const float*>(normal),   static_cast<const float*>(albedo),
                  static_cast<const float*>(count),    static_cast<const float*>(depth),
                  static_cast<const int64_t*>(t_type), static_cast<const float*>(t_normal),
                  static_cast<const float*>(t_albedo), static_cast<float*>(out),
                  h, w, row_offset, max_n, inv_n};
  if (h > 0 && w > 0) {
    const dim3 grid((w + BX - 1) / BX, (h + BY - 1) / BY), block(BX, BY);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (refr) {
      atrous_kernel<true><<<grid, block, 0, s>>>(a);
    } else {
      atrous_kernel<false><<<grid, block, 0, s>>>(a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
