// T1: temporal reprojection, both branches (accumulationFrag,
// PathTracingDenoise.hlsl:111-294).
//
// Replaces unitysspathtracingurp_tpu/ops/temporal.py temporal_reproject
// (:165-343, its direct-read form, packed_temporal=False), which the JAX
// package writes in XLA as whole-image operations and gathers. It is no
// Pallas kernel; in plain PyTorch it is ~250 small launches a frame. The
// plain PyTorch version is ops/temporal.py temporal_reproject_ref.
//
// Per pixel: prev_uv = uv - motion; the point reads of history depth and
// emission (floor(uv * size), clamped) and the bilinear reads of history
// color and count at prev_uv; rejection on sky, off screen, the world
// radius the pixel footprint scales and an emission change; the rough
// branch (linear accumulation n / (n + 1), then _TemporalIntensity) and
// the smooth branch (the neighborhood box of the two diagonal
// neighbours with a velocity-scaled nudge, the virtual reprojection of
// the reflected hit and a bilinear history read there, the box clip, the
// parallax-aware accumulation speed); the two-branch decision; the
// color and the new count written.
//
// What bounds it. Bytes: current, emission, normal (3 floats each),
// motion (2), layer-1 depth, smoothness, history count and depth (1
// each), history color and emission (3 each, f32 or bf16) read once, the
// color (3) and count (1) written once: 100 B a pixel with f32 history
// (88 B with bf16), 207 MB at 1080p, 0.062 ms at 3.35 TB/s; refraction
// adds the transparent type, normal and smoothness (24 B). The
// neighbour, bilinear-corner and virtual-uv reads land on texels other
// threads read; they are L1 / L2 traffic. The arithmetic is ~400 f32
// operations a pixel (3 divides a component, log, 2 pow, exp2, sqrt):
// ~0.8 GFLOP at 1080p, 0.012 ms at the f32 rate. The bytes bound it.
//
// The design: one thread a pixel in 32 x 8 blocks (a warp's rows of
// bilinear corners share sectors). The camera matrices (this frame's
// inverse view-projection and position, the previous frame's inverse
// view-projection, view-projection and position: 54 floats) come as a
// small device array per call, read into shared memory once a block:
// passed by value they would need a device-to-host copy of the camera
// every frame, and a __constant__ copy would be shared by every stream.
// History reads widen bf16 to f32 (exact); interpolation is f32. Every
// read goes through __ldg.
//
// Numerics: --fmad=false, IEEE divides and square roots, expf / exp2f /
// logf / powf (no fast math), and every expression in the order of the
// plain version: three-term sums left to right, the bilinear blend as
// rows across x then across y. Clamps, minima and maxima propagate NaN
// as torch does. With a bf16 history, the luminance of the history
// emission is taken in bf16 (the JAX package's weak-typed constants):
// bf16 weights, each product and sum rounded to nearest even. Each
// output bit equals temporal_reproject_ref's on the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BX = 32, BY = 8;
constexpr int N_CAM = 54;
constexpr int SURFACE_TYPE_REFRACTION = 2;
// Offsets in the camera array.
constexpr int IVP = 0, POS = 16, PIVP = 19, PVP = 35, PPOS = 51;

struct Args {
  const float* current;   // (H, W, 3)
  const float* emission;  // (H, W, 3)
  const float* depth;     // (H, W) layer-1 raw depth
  const float* normal;    // (H, W, 3)
  const float* smooth;    // (H, W)
  const float* h_count;   // (H, W)
  const float* h_depth;   // (H, W)
  const void* h_color;    // (H, W, 3) f32 or bf16
  const void* h_emis;     // (H, W, 3) f32 or bf16
  const int64_t* t_type;  // (H, W) (REFR)
  const float* t_normal;  // (H, W, 3) (REFR)
  const float* t_smooth;  // (H, W) (REFR)
  const float* motion;    // (H, W, 2) or null: zero velocity
  const float* cams;      // (54,)
  float* out_color;       // (H, W, 3)
  float* out_count;       // (H, W)
  int h, w;
  float max_n, intensity, spread, proj_eps, max_dist, max_tol, clamp_hi, rough_thr, curve,
      base_power;
};

// torch's NaN propagation.
__device__ __forceinline__ float clamp_max(float x, float hi) { return isnan(x) ? x : fminf(x, hi); }
__device__ __forceinline__ float clamp_min(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }
__device__ __forceinline__ float clamp2(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float saturate(float x) { return clamp2(x, 0.0f, 1.0f); }
__device__ __forceinline__ float tmax(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : fmaxf(a, b);
}
__device__ __forceinline__ float tmin(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : fminf(a, b);
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}
__device__ __forceinline__ float norm3(const float v[3]) { return sqrtf(dot3(v, v)); }
__device__ __forceinline__ void normalize(float v[3]) {
  const float n = clamp_min(norm3(v), 1e-12f);
  v[0] = v[0] / n;
  v[1] = v[1] / n;
  v[2] = v[2] / n;
}
__device__ __forceinline__ float luminance(const float c[3]) {
  return 0.2126729f * c[0] + 0.7151522f * c[1] + 0.0721750f * c[2];
}
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// utils/image.luminance of a bf16 image as the JAX package computes it.
__device__ __forceinline__ float luminance_bf16(const float c[3]) {
  const float w0 = bf16_round(0.2126729f), w1 = bf16_round(0.7151522f),
              w2 = bf16_round(0.0721750f);
  return bf16_round(bf16_round(bf16_round(w0 * c[0]) + bf16_round(w1 * c[1])) +
                    bf16_round(w2 * c[2]));
}

__device__ __forceinline__ void load3(const float* p, int i, float v[3]) {
  v[0] = __ldg(p + 3 * i);
  v[1] = __ldg(p + 3 * i + 1);
  v[2] = __ldg(p + 3 * i + 2);
}

// History texel i, widened to f32.
template <bool BF16>
__device__ __forceinline__ float hist(const void* p, int i) {
  if (BF16) {
    const uint32_t bits = __ldg(static_cast<const unsigned short*>(p) + i);
    return __uint_as_float(bits << 16);
  }
  return __ldg(static_cast<const float*>(p) + i);
}

// camera.world_from_uv_depth, the planar expansion left to right.
__device__ __forceinline__ void world_from_uv_depth(const float* m, float u, float v, float d,
                                                    float p[3]) {
  const float nx = u * 2.0f - 1.0f, ny = v * 2.0f - 1.0f;
  const float hx = nx * m[0] + ny * m[1] + d * m[2] + m[3];
  const float hy = nx * m[4] + ny * m[5] + d * m[6] + m[7];
  const float hz = nx * m[8] + ny * m[9] + d * m[10] + m[11];
  const float hw = nx * m[12] + ny * m[13] + d * m[14] + m[15];
  p[0] = hx / hw;
  p[1] = hy / hw;
  p[2] = hz / hw;
}

// floor(t * n) clamped to [0, n - 1] (NaN gives 0, as torch's clamp of
// the integer conversion does on the card).
__device__ __forceinline__ int point_index(float t, int n) {
  const float f = floorf(t * static_cast<float>(n));
  return f < 0.0f ? 0 : f > static_cast<float>(n - 1) ? n - 1 : static_cast<int>(f);
}

// envprobe.sample_bilinear of a C-channel history at (u, v).
template <bool BF16, int C>
__device__ __forceinline__ void bilinear(const void* img, int h, int w, float u, float v,
                                         float out[C]) {
  const float x = clamp2(u * static_cast<float>(w) - 0.5f, 0.0f, static_cast<float>(w - 1));
  const float y = clamp2(v * static_cast<float>(h) - 0.5f, 0.0f, static_cast<float>(h - 1));
  const int x0 = static_cast<int>(floorf(x)), y0 = static_cast<int>(floorf(y));
  const int x1 = min(x0 + 1, w - 1), y1 = min(y0 + 1, h - 1);
  const float fx = x - static_cast<float>(x0), fy = y - static_cast<float>(y0);
  const float gx = 1.0f - fx, gy = 1.0f - fy;
  const int i00 = (y0 * w + x0) * C, i01 = (y0 * w + x1) * C;
  const int i10 = (y1 * w + x0) * C, i11 = (y1 * w + x1) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float top = hist<BF16>(img, i00 + c) * gx + hist<BF16>(img, i01 + c) * fx;
    const float bot = hist<BF16>(img, i10 + c) * gx + hist<BF16>(img, i11 + c) * fx;
    out[c] = top * gy + bot * fy;
  }
}

template <bool REFR, bool BF16>
__global__ void __launch_bounds__(BX * BY) temporal_kernel(Args a) {
  __shared__ float m[N_CAM];
  const int tid = threadIdx.y * BX + threadIdx.x;
  if (tid < N_CAM) m[tid] = __ldg(a.cams + tid);
  __syncthreads();
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= a.w || y >= a.h) return;
  const int h = a.h, w = a.w, p = y * w + x;
  const float max_n = a.max_n;

  const float u = (static_cast<float>(x) + 0.5f) / static_cast<float>(w);
  const float v = (static_cast<float>(y) + 0.5f) / static_cast<float>(h);
  float vel_x = 0.0f, vel_y = 0.0f;
  if (a.motion != nullptr) {
    vel_x = __ldg(a.motion + 2 * p);
    vel_y = __ldg(a.motion + 2 * p + 1);
  }
  const float pu = u - vel_x, pv = v - vel_y;

  // History at prev_uv: depth and emission by point, count and color bilinear.
  const int pp = point_index(pv, h) * w + point_index(pu, w);
  const float prev_depth = __ldg(a.h_depth + pp);
  const float prev_emis[3] = {hist<BF16>(a.h_emis, 3 * pp), hist<BF16>(a.h_emis, 3 * pp + 1),
                              hist<BF16>(a.h_emis, 3 * pp + 2)};
  float hs;
  bilinear<false, 1>(a.h_count, h, w, pu, pv, &hs);
  float prev_mv[3];
  bilinear<BF16, 3>(a.h_color, h, w, pu, pv, prev_mv);

  const float device_depth = __ldg(a.depth + p);
  float nrm[3];
  load3(a.normal, p, nrm);
  float smoothness = __ldg(a.smooth + p);
  if (REFR && __ldg(a.t_type + p) == SURFACE_TYPE_REFRACTION) {
    load3(a.t_normal, p, nrm);
    smoothness = __ldg(a.t_smooth + p);
  }
  const float roughness = 1.0f - smoothness;

  const bool off_screen = pu > 1.0f || pu < 0.0f || pv > 1.0f || pv < 0.0f;
  bool can = !(device_depth == 0.0f || off_screen);

  float pos[3], prev_pos[3];
  world_from_uv_depth(m + IVP, u, v, device_depth, pos);
  world_from_uv_depth(m + PIVP, pu, pv, prev_depth, prev_pos);
  float view[3] = {m[POS] - pos[0], m[POS + 1] - pos[1], m[POS + 2] - pos[2]};
  normalize(view);
  const float ndotv = fabsf(dot3(nrm, view));
  float prev_view[3] = {m[PPOS] - prev_pos[0], m[PPOS + 1] - prev_pos[1],
                        m[PPOS + 2] - prev_pos[2]};
  normalize(prev_view);
  const float cosa = saturate(dot3(view, prev_view));
  const float parallax = sqrtf(clamp_min(1.0f - cosa * cosa, 0.0f)) / clamp_min(cosa, 1e-6f);

  const float pos_len = norm3(pos);
  const float real_footprint = a.spread * pos_len / clamp_min(ndotv, a.proj_eps);
  const float max_radius = clamp_min(real_footprint * a.max_tol, a.max_dist);
  const float dpos[3] = {prev_pos[0] - pos[0], prev_pos[1] - pos[1], prev_pos[2] - pos[2]};
  const float radius = norm3(dpos) / max_radius;
  can = can && radius <= 1.0f;

  float cur_emis[3];
  load3(a.emission, p, cur_emis);
  const float el = luminance(cur_emis);
  const float pl = BF16 ? luminance_bf16(prev_emis) : luminance(prev_emis);
  float ediff = 1.0f - fabsf(el - pl) / clamp_min(tmax(el, pl), 0.2f);
  ediff = ediff * ediff;
  const float emission_diff = can ? ediff : 1.0f;
  can = can && emission_diff >= 0.5f;

  float cur[3];
  load3(a.current, p, cur);
  const float count = clamp2(hs + 1.0f, 0.0f, max_n);
  const bool use_rough = roughness > a.rough_thr && emission_diff > 0.5f;
  float* o = a.out_color + 3 * static_cast<size_t>(p);

  if (use_rough) {  // Denoise.hlsl:200-238
    const float acc = (hs >= max_n ? a.intensity : hs / (hs + 1.0f)) *
                      clamp_min(emission_diff, 0.1f) * (1.0f - radius);
    const bool rough_ok = can && hs != 0.0f;
    const float keep = 1.0f - acc;
#pragma unroll
    for (int c = 0; c < 3; ++c) o[c] = rough_ok ? cur[c] * keep + prev_mv[c] * acc : cur[c];
    a.out_count[p] = rough_ok ? count : 1.0f;
    return;
  }

  // Smooth branch (Denoise.hlsl:239-288).
  if (!can) {
    o[0] = cur[0];
    o[1] = cur[1];
    o[2] = cur[2];
    a.out_count[p] = 1.0f;
    return;
  }
  float tl[3], br[3], color[3], average[3];
  load3(a.current, max(y - 1, 0) * w + max(x - 1, 0), tl);
  load3(a.current, min(y + 1, h - 1) * w + min(x + 1, w - 1), br);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float corners = 4.0f * (tl[c] + br[c]) - 2.0f * cur[c];
    color[c] = clamp2(cur[c], 0.0f, a.clamp_hi);
    average[c] = (corners + color[c]) / 7.0f;
  }
  const float color_luma = luminance(color);
  const float average_luma = luminance(average);
  const float vel_len = sqrtf(vel_x * vel_x + vel_y * vel_y);
  const float nudge_scale = 4.0f + -3.75f * saturate(vel_len * 100.0f);
  const float nudge = nudge_scale * fabsf(average_luma - color_luma);

  const float dom_a = 0.298475f * logf(39.4115f - 39.0029f * roughness);
  const float dominant =
      saturate(powf(saturate(1.0f - ndotv), 10.8649f) * (1.0f - dom_a) + dom_a);
  const float reach = pos_len * dominant;
  const float vp[3] = {pos[0] - view[0] * reach, pos[1] - view[1] * reach,
                       pos[2] - view[2] * reach};
  const float* pm = m + PVP;
  const float clipx = vp[0] * pm[0] + vp[1] * pm[1] + vp[2] * pm[2] + pm[3];
  const float clipy = vp[0] * pm[4] + vp[1] * pm[5] + vp[2] * pm[6] + pm[7];
  const float clipw = vp[0] * pm[12] + vp[1] * pm[13] + vp[2] * pm[14] + pm[15];
  const float wdiv = fabsf(clipw) < 1e-12f ? 1e-12f : clipw;
  float prev_virtual[3];
  bilinear<BF16, 3>(a.h_color, h, w, clipx / wdiv * 0.5f + 0.5f, clipy / wdiv * 0.5f + 0.5f,
                    prev_virtual);

  // DirectClipToAABB (Denoise.hlsl:46-61).
  float center[3], offset[3], unit[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float mn = tmin(br[c], tl[c]) - nudge, mx = tmax(tl[c], br[c]) + nudge;
    center[c] = 0.5f * (mx + mn);
    const float extents = clamp_min(0.5f * (mx - mn), 1e-12f);
    offset[c] = prev_virtual[c] - center[c];
    unit[c] = fabsf(offset[c] / extents);
  }
  const float max_unit = tmax(tmax(unit[0], unit[1]), unit[2]);
  float clipped[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    clipped[c] = max_unit > 1.0f ? center[c] + offset[c] / max_unit : prev_virtual[c];
  }

  const float hist_luma = luminance(clipped);
  const float diff =
      fabsf(color_luma - hist_luma) / clamp_min(tmax(color_luma, hist_luma), 0.2f);
  const float weight = 1.0f - diff;
  const float w2 = weight * weight;
  const float lr = clamp_min(roughness, 0.06f) * (1.0f - w2);
  // GetSpecAccumSpeed (Denoise.hlsl:75-85).
  const float sa = powf(saturate(1.0f - ndotv), a.curve);
  const float sb = 1.1f + lr * lr;
  const float sensitivity = (sb + sa) / (sb - sa);
  const float power_scale = 1.0f + parallax * sensitivity;
  float f = 1.0f - exp2f(-200.0f * lr * lr);
  f = f * powf(saturate(lr), a.base_power * power_scale);
  const float n1 = hs + 1.0f;
  const float acc = n1 >= max_n ? a.intensity : saturate(tmin(max_n * f, n1 / max_n));
#pragma unroll
  for (int c = 0; c < 3; ++c) o[c] = clamp2(color[c] + (clipped[c] - color[c]) * acc, 0.0f,
                                            a.clamp_hi);
  a.out_count[p] = count;
}

template <bool REFR, bool BF16>
void launch(const Args& a, cudaStream_t s) {
  const dim3 grid((a.w + BX - 1) / BX, (a.h + BY - 1) / BY), block(BX, BY);
  temporal_kernel<REFR, BF16><<<grid, block, 0, s>>>(a);
}

}  // namespace

extern "C" int sspt_temporal(
    const void* current, const void* emission, const void* depth, const void* normal,
    const void* smooth, const void* h_count, const void* h_depth, const void* h_color,
    const void* h_emis, const void* t_type, const void* t_normal, const void* t_smooth,
    const void* motion, const void* cams, void* out_color, void* out_count, int h, int w,
    int refr, int bf16, float max_n, float intensity, float spread, float proj_eps,
    float max_dist, float max_tol, float clamp_hi, float rough_thr, float curve,
    float base_power, void* stream) {
  const Args a = {static_cast<const float*>(current), static_cast<const float*>(emission),
                  static_cast<const float*>(depth), static_cast<const float*>(normal),
                  static_cast<const float*>(smooth), static_cast<const float*>(h_count),
                  static_cast<const float*>(h_depth), h_color, h_emis,
                  static_cast<const int64_t*>(t_type), static_cast<const float*>(t_normal),
                  static_cast<const float*>(t_smooth), static_cast<const float*>(motion),
                  static_cast<const float*>(cams), static_cast<float*>(out_color),
                  static_cast<float*>(out_count), h, w, max_n, intensity, spread, proj_eps,
                  max_dist, max_tol, clamp_hi, rough_thr, curve, base_power};
  if (h > 0 && w > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (refr && bf16) {
      launch<true, true>(a, s);
    } else if (refr) {
      launch<true, false>(a, s);
    } else if (bf16) {
      launch<false, true>(a, s);
    } else {
      launch<false, false>(a, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
