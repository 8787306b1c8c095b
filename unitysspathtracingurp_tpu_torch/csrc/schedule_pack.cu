// K1 and K4: march schedule + minitile interval filter + candidate pack.
//
// K1 (DUAL = false) replaces unitysspathtracingurp_tpu/ops/fused_schedule.py
// _fused_schedule_pack, plain layout (the pallas_call at :639), itself
// the fused form of ops/pathtrace_hiz.py phases 1-3 (:293-464). The
// plain PyTorch version is ops/fused_schedule.py schedule_pack_ref.
//
// K4 (DUAL = true) replaces the same Pallas kernel with dual=True
// (fused_schedule.py:213-251, 348-377; pallas_call :639), the
// refraction / backface variants on DualDepthTiles. Per lane it adds to
// K1: the combo-offset minitile lookup (mini + combo * combo_words), the
// bmax table read, the conservative candidate rule
//   proc & hitd >= mmin & (hitd - max(th, step) <= umax | search | hitd <= bmax)
// (pathtrace_hiz.py:398-404), and a 4th packed field pk_step = q40(step).
// Its plain PyTorch version is schedule_pack_dual_ref. Its bound: each
// lane reads 38 B (K1's minus is_back, plus combo and search) and
// writes K*16 + 4 = 260 B, ~0.62 GB at 1080p, ~0.18 ms. The dual tables
// are 3 combos x 32 chunks x 128 words x 4 B = 48 KB each at 1080p, 96 KB
// for the pair: as dynamic shared memory that would leave room for only
// two 128-thread blocks per SM, so K4 reads them from global memory
// through the read-only cache (__ldg) and keeps K1's occupancy. The f16
// halves widen exactly (__half2float keeps +-inf and subnormals), the
// same values the plain version's f16 -> f32 casts give.
//
// Per lane: rebuild the s_max-step march schedule (6 small steps, 12
// medium, then the per-lane large step; x1.1 step and +25% thickness
// growth on processed steps; sub-texel skip; screen exit), positions
// accumulated iteratively; test each processed step's [hitd - th, hitd]
// window against its 32x16-px minitile's f16 [min, max] linear depth;
// write the first K survivors to row `slot` of the (K, N) outputs.
//
// What bounds it on an H100: device-memory writes, on paper. Each lane
// reads 34 B of ray state and writes K*12 + 4 = 196 B of slots, ~0.4 GB
// at 1080p (~0.12 ms at 3.35 TB/s), while its s_max steps of ~40 f32
// ops (one projection, three IEEE divides) are ~2 GFLOP (~0.03 ms at
// 67 TFLOP/s). The unfused path also wrote and re-read eight (S, N)
// step arrays; none exist here. Design: one thread per lane,
// the whole step loop in registers; the minitile table (16 KB at 1080p)
// staged once per block into shared memory, so the per-step lookup
// never touches device memory; slot j is written to row j, so a warp's
// stores to one slot row are contiguous; every one of the K rows is
// written (zeros past the count) because the wrapper allocates with
// torch.empty. No tensor cores: there is no matrix product here.
//
// Numerics: built with --fmad=false, so every a*b+c rounds twice, as
// torch's elementwise ops do; divisions are IEEE (no fast math); q40
// rounds half to even (rintf), like torch.round / jnp.round.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float half_bits_to_float(uint32_t bits) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(bits & 0xFFFFu)));
}

__device__ __forceinline__ void project(const float* m, float x, float y, float z,
                                        float& u, float& v, float& raw) {
  float cx = x * m[0] + y * m[1] + z * m[2] + m[3];
  float cy = x * m[4] + y * m[5] + z * m[6] + m[7];
  float cz = x * m[8] + y * m[9] + z * m[10] + m[11];
  float w = x * m[12] + y * m[13] + z * m[14] + m[15];
  if (fabsf(w) < 1e-12f) w = 1e-12f;
  u = cx / w * 0.5f + 0.5f;
  v = cy / w * 0.5f + 0.5f;
  raw = cz / w;
}

__device__ __forceinline__ int pixel_index(float t, int size) {
  // floor(t * size) clamped to [0, size - 1]; __float2int_rd saturates.
  int i = __float2int_rd(t * static_cast<float>(size));
  return min(max(i, 0), size - 1);
}

__device__ __forceinline__ float q40(float x, float mx) {
  return fminf(fmaxf(rintf(x * 40.0f), 0.0f), mx);
}

// Per-lane inputs and outputs of the dual mode (unused by K1).
struct DualArgs {
  const int32_t* combo;
  const uint8_t* search;
  const uint32_t* bmax_table;
  float* pk_step;
  int combo_words;
};

template <bool DUAL>
__global__ void schedule_pack_kernel(
    const float* __restrict__ ray_pos, const float* __restrict__ ray_dir,
    const float* __restrict__ dither, const float* __restrict__ large_step,
    const uint8_t* __restrict__ alive, const uint8_t* __restrict__ is_back,
    const uint32_t* __restrict__ mini_table, const float* __restrict__ scalars,
    float* __restrict__ pk_cum, float* __restrict__ pk_scode,
    float* __restrict__ pk_hist, int32_t* __restrict__ n_cand, DualArgs dual,
    int n, int gh, int gw, int minis_x, int n_mini_words, int s_max, int k,
    int max_small, int max_medium, float small_step, float medium_step,
    float thickness, float th_inc, float step_growth, float th_cap,
    float texel_x, float texel_y) {
  extern __shared__ uint32_t s_mini[];
  __shared__ float s_m[18];
  if (!DUAL) {
    for (int i = threadIdx.x; i < n_mini_words; i += blockDim.x) s_mini[i] = mini_table[i];
  }
  if (threadIdx.x < 18) s_m[threadIdx.x] = scalars[threadIdx.x];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  float m[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) m[i] = s_m[i];
  const float zz = s_m[16], zw = s_m[17];

  float px = ray_pos[3 * lane], py = ray_pos[3 * lane + 1], pz = ray_pos[3 * lane + 2];
  const float dx = ray_dir[3 * lane], dy = ray_dir[3 * lane + 1], dz = ray_dir[3 * lane + 2];
  const float dth = dither[lane];
  const float lstep = large_step[lane];
  bool marching = alive[lane] != 0;
  const bool backray = DUAL ? false : is_back[lane] != 0;
  const bool searchlane = DUAL ? dual.search[lane] != 0 : false;
  const int combo_off = DUAL ? dual.combo[lane] * dual.combo_words : 0;

  float last_u, last_v, raw0;
  project(m, px, py, pz, last_u, last_v, raw0);
  float step = small_step, th = thickness;
  float cum = 0.0f, lcum = 0.0f, lhd = 0.0f, pidx = -1.0f;
  int run = 0;

  for (int i = 1; i <= s_max; ++i) {
    if (i == max_small + 1) { step = medium_step; th = thickness; }
    if (i == max_medium + 1) { step = lstep; th = thickness; }
    const float adv = step + step * dth;
    cum = cum + adv;
    px = px + adv * dx;
    py = py + adv * dy;
    pz = pz + adv * dz;
    float u, v, raw;
    project(m, px, py, pz, u, v, raw);

    const bool skip = (i <= max_medium) && (fabsf(u - last_u) < texel_x) &&
                      (fabsf(v - last_v) < texel_y);
    const bool in_screen = (u > 0.0f) && (u < 1.0f) && (v > 0.0f) && (v < 1.0f);
    const bool exit_now = marching && !skip && !in_screen;
    const bool proc = marching && !skip && in_screen;

    const int ix = pixel_index(u, gw);
    const int iy = pixel_index(v, gh);
    const float hitd = 1.0f / (raw * zz + zw);
    const int mini = min((iy / 16) * minis_x + ix / 32 + combo_off, n_mini_words - 1);
    bool cand;
    if (DUAL) {
      const uint32_t word = __ldg(mini_table + mini);
      const float mmin = half_bits_to_float(word);
      const float umax = half_bits_to_float(word >> 16);
      const float bmax = half_bits_to_float(__ldg(dual.bmax_table + mini));
      const float margin = fmaxf(th, step);
      cand = proc && (hitd >= mmin) &&
             ((hitd - margin <= umax) || searchlane || (hitd <= bmax));
    } else {
      const uint32_t word = s_mini[mini];
      const float mmin = half_bits_to_float(word);
      const float mmax = half_bits_to_float(word >> 16);
      cand = proc && (hitd >= mmin) && ((hitd - th <= mmax) || backray);
    }

    if (cand) {
      if (run < k) {
        const float scode = static_cast<float>(i - 1) + 65.0f * (pidx + 1.0f) +
                            q40(th, th_cap) * 8192.0f;
        const float hist = q40(lcum, 4095.0f) * 4096.0f + q40(lhd, 4095.0f);
        const size_t o = static_cast<size_t>(run) * n + lane;
        pk_cum[o] = cum;
        pk_scode[o] = scode;
        pk_hist[o] = hist;
        if (DUAL) dual.pk_step[o] = q40(step, 4095.0f);
      }
      ++run;
    }
    if (proc) {
      step = step + step * step_growth;
      th = th + th_inc;
      last_u = u;
      last_v = v;
      lcum = cum;
      lhd = hitd;
      pidx = static_cast<float>(i - 1);
    }
    marching = marching && !exit_now;
  }
  const int cnt = min(run, k);
  for (int j = cnt; j < k; ++j) {
    const size_t o = static_cast<size_t>(j) * n + lane;
    pk_cum[o] = 0.0f;
    pk_scode[o] = 0.0f;
    pk_hist[o] = 0.0f;
    if (DUAL) dual.pk_step[o] = 0.0f;
  }
  n_cand[lane] = cnt;
}

}  // namespace

extern "C" int sspt_schedule_pack(
    const void* ray_pos, const void* ray_dir, const void* dither,
    const void* large_step, const void* alive, const void* is_back,
    const void* mini_table, const void* scalars, void* pk_cum, void* pk_scode,
    void* pk_hist, void* n_cand, int n, int gh, int gw, int minis_x,
    int n_mini_words, int s_max, int k, int max_small, int max_medium,
    float small_step, float medium_step, float thickness, float th_inc,
    float step_growth, float th_cap, float texel_x, float texel_y,
    void* stream) {
  const size_t smem = static_cast<size_t>(n_mini_words) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        schedule_pack_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (n > 0) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    const DualArgs none = {nullptr, nullptr, nullptr, nullptr, 0};
    schedule_pack_kernel<false><<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(ray_pos), static_cast<const float*>(ray_dir),
        static_cast<const float*>(dither), static_cast<const float*>(large_step),
        static_cast<const uint8_t*>(alive), static_cast<const uint8_t*>(is_back),
        static_cast<const uint32_t*>(mini_table), static_cast<const float*>(scalars),
        static_cast<float*>(pk_cum), static_cast<float*>(pk_scode),
        static_cast<float*>(pk_hist), static_cast<int32_t*>(n_cand), none, n, gh, gw,
        minis_x, n_mini_words, s_max, k, max_small, max_medium, small_step,
        medium_step, thickness, th_inc, step_growth, th_cap, texel_x, texel_y);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sspt_schedule_pack_dual(
    const void* ray_pos, const void* ray_dir, const void* dither,
    const void* large_step, const void* alive, const void* combo,
    const void* search, const void* mini_table, const void* bmax_table,
    const void* scalars, void* pk_cum, void* pk_scode, void* pk_hist,
    void* pk_step, void* n_cand, int n, int gh, int gw, int minis_x,
    int n_mini_words, int combo_words, int s_max, int k, int max_small,
    int max_medium, float small_step, float medium_step, float thickness,
    float th_inc, float step_growth, float th_cap, float texel_x,
    float texel_y, void* stream) {
  if (n > 0) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    const DualArgs dual = {
        static_cast<const int32_t*>(combo), static_cast<const uint8_t*>(search),
        static_cast<const uint32_t*>(bmax_table), static_cast<float*>(pk_step),
        combo_words};
    schedule_pack_kernel<true><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(ray_pos), static_cast<const float*>(ray_dir),
        static_cast<const float*>(dither), static_cast<const float*>(large_step),
        static_cast<const uint8_t*>(alive), nullptr,
        static_cast<const uint32_t*>(mini_table), static_cast<const float*>(scalars),
        static_cast<float*>(pk_cum), static_cast<float*>(pk_scode),
        static_cast<float*>(pk_hist), static_cast<int32_t*>(n_cand), dual, n, gh, gw,
        minis_x, n_mini_words, s_max, k, max_small, max_medium, small_step,
        medium_step, thickness, th_inc, step_growth, th_cap, texel_x, texel_y);
  }
  return static_cast<int>(cudaGetLastError());
}
