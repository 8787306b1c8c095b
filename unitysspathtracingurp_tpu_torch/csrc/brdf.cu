// B1: one bounce's BRDF evaluation after its draws (EvaluateBRDF,
// PathTracing.hlsl:256-383).
//
// Replaces no TPU kernel: the JAX package writes evaluate_brdf
// (unitysspathtracingurp_tpu/ops/pathtrace.py) in XLA, which fuses it. In
// plain PyTorch every line is a launch over every lane: ~186 a call
// without refraction, ~305 with it, ~2,200 of the classroom real-time
// frame's ~4,500 device ops and ~6,100 of the glass frame's ~13,000, each
// a few microseconds of device time and ~15 us of host time to launch. The
// plain PyTorch version is ops/pathtrace.py brdf_lanes_ref.
//
// Per lane, on a hit: the lobe probabilities (specular from the clamped
// specular color's largest channel; under REFR a refraction lobe from the
// albedo's where the surface has an ior), the roulette chain that picks
// at most one lobe (roulette < p per lobe: a path can end), and that
// lobe's direction and energy scale: GGX (the sampled half vector, the
// reflected direction, Smith visibility over the pdf, Schlick Fresnel of
// the specular color), Lambert (the cosine-weighted direction; with
// DISNEY the Burley diffuse term) or, under REFR, refraction (eta by the
// inside state, Schlick Fresnel of the GGX half vector choosing the
// refracted or the mirrored direction, refract's total internal
// reflection falling back to the mirror, and the energy scale by inside
// state: 1, albedo / p, or exp(albedo * max(dist, 2.5)) / p on exit).
// Written: direction, position (the hit's) and energy (times the scale),
// and the radiance (the hit's emission). On a miss: the ray's direction
// and position, zero energy and the environment's radiance.
//
// What bounds it. Bytes: a hit lane reads the ray direction, energy, the
// hit flag, the surface (normal, albedo, specular, emission, smoothness;
// ior, inside state and hit distance under REFR), the hit position and
// three draws: 149 B (161 B with REFR); a miss lane the flag, ray
// direction and position and the environment: 37 B; every lane writes
// 48 B. At 1080p (2,073,600 lanes, all hits) 409 MB, 0.122 ms at
// 3.35 TB/s (0.130 ms with REFR). The arithmetic is ~250 f32 operations
// a lane with a sine, a cosine and five square roots (an exp under
// REFR), ~8 us at the f32 rate: the bytes bound it.
//
// The design: one thread a lane, 256 a block, the lanes flattened from
// any two-axis shape (the pixel grid or the compacted (cap_n / 128, 128)
// lanes). Each input field is read through its own strides (lane row,
// lane column, component): the decode hands views (a component plane of
// a stacked tensor) and lane-constant inputs come with zero strides
// (bounce 0's hit flag and ray origin, a constant probe's radiance), so
// the wrapper copies nothing. The roulette picks the lobe before any
// lobe is computed, so a lane computes only its own lobe. The outputs are
// one (4, lanes, 3) f32 buffer.
//
// Numerics: --fmad=false, IEEE divides and square roots, cosf / sinf /
// expf (no fast math), and every expression in the order of the plain
// version: three-term sums left to right, x^5 as x * (x^2 * x^2),
// to_world as ((x * fx + y * fy) + z * fz), a division by a tensor from a
// Python number as torch computes it (the reciprocal times the number),
// Python constants rounded to f32 as torch rounds a scalar operand.
// Clamps and the largest channel propagate NaN as torch does. Each output
// bit equals brdf_lanes_ref's on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// Input fields, in the order of the wrapper's descriptor array.
enum Field {
  RAY_DIR, RAY_POS, ENERGY, HIT, NORMAL, ALBEDO, SPECULAR, SMOOTH, IOR, INSIDE, EMISSION,
  HIT_POS, HIT_DIST, ENV, RANDOM, ROULETTE, N_FIELDS
};

// A field: its data and its strides in elements along the lane row, the
// lane column and the component.
struct Desc {
  const void* p;
  long long s0, s1, sc;
};

struct Fields {
  Desc f[N_FIELDS];
};

// A Python float as torch rounds a scalar operand of an f32 op.
#define F(x) static_cast<float>(x)

// torch's NaN propagation.
__device__ __forceinline__ float clamp_min(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }
__device__ __forceinline__ float saturate(float x) {
  return isnan(x) ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}
// torch.amax over three channels.
__device__ __forceinline__ float amax3(const float v[3]) {
  float m = v[0];
#pragma unroll
  for (int k = 1; k < 3; ++k) m = (isnan(m) || m > v[k]) ? m : v[k];
  return m;
}
// 1.0 / x from Python: torch takes the reciprocal, then multiplies by 1.0.
__device__ __forceinline__ float rdiv1(float x) { return 1.0f / x; }

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}
__device__ __forceinline__ float pow5(float x) {
  const float x2 = x * x;
  return x * (x2 * x2);
}
// ((l0 * fx + l1 * fy) + l2 * fz), per component.
__device__ __forceinline__ void to_world(const float l[3], const float fx[3], const float fy[3],
                                         const float fz[3], float out[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = l[0] * fx[k] + l[1] * fy[k] + l[2] * fz[k];
}

template <bool REFR, bool DISNEY>
__global__ void __launch_bounds__(THREADS)
    brdf_kernel(const Fields in, float* __restrict__ out, int n, int cols) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const long long r = i / cols, c = i - (i / cols) * cols;
  auto ld = [&](int f, int k) -> float {
    const Desc& d = in.f[f];
    return __ldg(static_cast<const float*>(d.p) + (r * d.s0 + c * d.s1 + k * d.sc));
  };
  auto ld3 = [&](int f, float v[3]) {
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] = ld(f, k);
  };
  float* o_dir = out + 3LL * i;
  float* o_pos = o_dir + 3LL * n;
  float* o_energy = o_pos + 3LL * n;
  float* o_rad = o_energy + 3LL * n;
  auto st3 = [](float* o, const float v[3]) {
#pragma unroll
    for (int k = 0; k < 3; ++k) o[k] = v[k];
  };

  float rd[3];
  ld3(RAY_DIR, rd);
  const Desc& hd = in.f[HIT];
  const bool hit = __ldg(static_cast<const unsigned char*>(hd.p) + (r * hd.s0 + c * hd.s1)) != 0;
  if (!hit) {
    float v[3];
    st3(o_dir, rd);
    ld3(RAY_POS, v);
    st3(o_pos, v);
    v[0] = v[1] = v[2] = 0.0f;
    st3(o_energy, v);
    ld3(ENV, v);
    st3(o_rad, v);
    return;
  }

  float nrm[3], alb[3], spc[3];
  ld3(NORMAL, nrm);
  ld3(ALBEDO, alb);
  ld3(SPECULAR, spc);
  const float smooth = ld(SMOOTH, 0);
  const float view[3] = {-rd[0], -rd[1], -rd[2]};
  const float ndotv = clamp_min(dot3(nrm, view), F(1.0e-4));
  float spec_c[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) spec_c[k] = clamp_min(spc[k], F(0.04));
  float spec_p = amax3(spec_c);
  float refract_p = 0.0f, diff_p, ior = 0.0f, inside = 0.0f;
  if (REFR) {
    ior = ld(IOR, 0);
    inside = ld(INSIDE, 0);
    if (ior != -1.0f) {
      refract_p = amax3(alb);
      spec_p = 1.0f - refract_p;
    }
    diff_p = (1.0f - spec_p) - refract_p;
  } else {
    diff_p = 1.0f - spec_p;
  }
  const float perceptual = 1.0f - smooth;
  const float roughness = perceptual * perceptual;
  const float u0 = ld(RANDOM, 0), u1 = ld(RANDOM, 1);
  const float roulette = ld(ROULETTE, 0);

  // The lobe roulette (ref :282, :311, :333).
  bool sel_spec = (spec_p > 0.0f) && (roulette < spec_p);
  bool sel_refract = false;
  if (REFR) {
    sel_refract = (refract_p > 0.0f) && (roulette < refract_p);
    sel_spec = !sel_refract && sel_spec;
  }
  const bool sel_diff = !sel_spec && (diff_p > 0.0f) && (roulette < diff_p);

  // The local frame (Duff et al. 2017).
  const float x = nrm[0], y = nrm[1], z = nrm[2];
  const float sz = z >= 0.0f ? 1.0f : -1.0f;
  const float a = rdiv1(sz + z);
  const float ya = y * a;
  const float b = x * ya;
  const float cx = x * sz;
  const float fx[3] = {cx * x * a - 1.0f, sz * b, cx};
  const float fy[3] = {b, y * ya - sz, y};
  const float phi = F(6.283185307179586) * u1;

  float new_dir[3], scale[3];
  if (sel_spec || sel_refract) {
    // The GGX half vector and the view in the local frame.
    const float ga = roughness * roughness;
    const float denom = (ga * ga - 1.0f) * u0 + 1.0f;
    const float cos_theta = sqrtf(saturate((1.0f - u0) / clamp_min(denom, F(1e-12))));
    const float sin_theta = sqrtf(saturate(1.0f - cos_theta * cos_theta));
    const float lh[3] = {sin_theta * cosf(phi), sin_theta * sinf(phi), cos_theta};
    const float lv[3] = {dot3(view, fx), dot3(view, fy), dot3(view, nrm)};
    const float vdoth = saturate(dot3(lv, lh));
    const float x5 = pow5(1.0f - vdoth);
    if (sel_spec) {
      const float v2 = vdoth * 2.0f;
      const float ll[3] = {-lv[0] + v2 * lh[0], -lv[1] + v2 * lh[1], -lv[2] + v2 * lh[2]};
      to_world(ll, fx, fy, nrm, new_dir);
      const float ndotl = saturate(ll[2]);
      const float a2 = roughness * roughness;
      const float lambda_v = ndotl * sqrtf((-ndotv * a2 + ndotv) * ndotv + a2);
      const float lambda_l = ndotv * sqrtf((-ndotl * a2 + ndotl) * ndotl + a2);
      const float vis = rdiv1(clamp_min(lambda_v + lambda_l, F(1e-5))) * 0.5f;
      const float w = 4.0f * vis * ndotl * vdoth / clamp_min(cos_theta, F(1e-12));
      const float wop = (roughness > F(0.001) && cos_theta > 0.0f) ? w : 1.0f;
      const float p = clamp_min(spec_p, F(1e-12));
#pragma unroll
      for (int k = 0; k < 3; ++k) scale[k] = (spc[k] + (1.0f - spc[k]) * x5) * wop / p;
    } else {
      // Refraction (ref :282-310): Fresnel of the half vector picks the
      // refracted or the mirrored direction; TIR mirrors.
      const float eta = inside == 1.0f ? rdiv1(clamp_min(ior, F(1e-6))) : ior;
      const float fresnel = (clamp_min(smooth, F(0.04)) - F(0.04)) * x5 + F(0.04);
      const float cos_i = -dot3(rd, nrm);
      const float k_ = 1.0f - eta * eta * (1.0f - cos_i * cos_i);
      const bool valid = k_ >= 0.0f;
      if (valid && roulette > fresnel) {
        const float t = eta * cos_i - sqrtf(clamp_min(k_, 0.0f));
#pragma unroll
        for (int k = 0; k < 3; ++k) new_dir[k] = eta * rd[k] + t * nrm[k];
      } else {
        const float d2 = dot3(rd, nrm) * 2.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) new_dir[k] = rd[k] - d2 * nrm[k];
      }
      const float inv_p = rdiv1(clamp_min(refract_p, F(0.001)));
      if (inside == 2.0f) {
        const float dist = clamp_min(ld(HIT_DIST, 0), F(2.5));
#pragma unroll
        for (int k = 0; k < 3; ++k) scale[k] = inv_p * expf(alb[k] * dist);
      } else if (inside == 1.0f) {
#pragma unroll
        for (int k = 0; k < 3; ++k) scale[k] = inv_p * alb[k];
      } else {
        scale[0] = scale[1] = scale[2] = 1.0f;
      }
    }
  } else {
    // Lambert, the direction the lane takes unless a lobe above won.
    const float rl = sqrtf(u0);
    const float ll[3] = {rl * cosf(phi), rl * sinf(phi), sqrtf(saturate(1.0f - u0))};
    to_world(ll, fx, fy, nrm, new_dir);
    if (sel_diff) {
      float db[3];
      if (DISNEY) {
        const float ldotv = saturate(dot3(new_dir, view));
        const float fd90 = (perceptual + perceptual * ldotv) + 0.5f;
        const float light_scatter = (fd90 - 1.0f) * pow5(1.0f - ll[2]) + 1.0f;
        const float view_scatter = (fd90 - 1.0f) * pow5(1.0f - ndotv) + 1.0f;
        const float dd = F(1.0 / 1.03571) * light_scatter * view_scatter;
#pragma unroll
        for (int k = 0; k < 3; ++k) db[k] = alb[k] * dd;
      } else {
#pragma unroll
        for (int k = 0; k < 3; ++k) db[k] = alb[k];
      }
      const float p = clamp_min(diff_p, F(1e-12));
#pragma unroll
      for (int k = 0; k < 3; ++k) scale[k] = db[k] * 1.0f / p;
    } else {
      scale[0] = scale[1] = scale[2] = 0.0f;
    }
  }

  float v[3];
  st3(o_dir, new_dir);
  ld3(HIT_POS, v);
  st3(o_pos, v);
  ld3(ENERGY, v);
#pragma unroll
  for (int k = 0; k < 3; ++k) v[k] = v[k] * scale[k];
  st3(o_energy, v);
  ld3(EMISSION, v);
  st3(o_rad, v);
}

template <bool REFR, bool DISNEY>
void launch(const Fields& f, float* out, int n, int cols, cudaStream_t s) {
  brdf_kernel<REFR, DISNEY><<<(n + THREADS - 1) / THREADS, THREADS, 0, s>>>(f, out, n, cols);
}

}  // namespace

// ``desc``: N_FIELDS x (data pointer, row, column and component strides in
// elements) in Field order; the hit flag is bool bytes, every other field
// f32 (IOR, INSIDE and HIT_DIST are read only with ``refr``). ``out`` is
// (4, rows * cols, 3) f32: direction, position, energy, radiance.
extern "C" int sspt_brdf(const long long* desc, void* out, int rows, int cols, int refr,
                         int disney, void* stream) {
  Fields f;
  for (int k = 0; k < N_FIELDS; ++k) {
    f.f[k].p = reinterpret_cast<const void*>(desc[4 * k]);
    f.f[k].s0 = desc[4 * k + 1];
    f.f[k].s1 = desc[4 * k + 2];
    f.f[k].sc = desc[4 * k + 3];
  }
  const int n = rows * cols;
  const auto o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    if (refr) {
      (disney ? launch<true, true> : launch<true, false>)(f, o, n, cols, s);
    } else {
      (disney ? launch<false, true> : launch<false, false>)(f, o, n, cols, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
