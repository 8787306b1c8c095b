// K1, K4 and K6: march schedule + minitile interval filter + candidate pack.
//
// K1 (schedule_pack_kernel<false>) replaces
// unitysspathtracingurp_tpu/ops/fused_schedule.py _fused_schedule_pack,
// plain layout (the pallas_call at :639), itself the fused form of
// ops/pathtrace_hiz.py phases 1-3 (:293-464). The plain PyTorch version is
// ops/fused_schedule.py schedule_pack_ref.
//
// K4 (schedule_pack_kernel<true>) replaces the same Pallas kernel with
// dual=True (fused_schedule.py:213-251, 348-377; pallas_call :639), the
// refraction / backface variants on DualDepthTiles. Per lane it adds to
// K1: the combo-offset minitile lookup (mini + combo * combo_words), the
// bmax table read, the conservative candidate rule
//   proc & hitd >= mmin & (hitd - max(th, step) <= umax | search | hitd <= bmax)
// (pathtrace_hiz.py:398-404), and a 4th packed field pk_step = q40(step).
// Its plain PyTorch version is schedule_pack_dual_ref. The dual tables
// are 3 combos x 32 chunks x 128 words x 4 B = 48 KB each at 1080p, 96 KB
// for the pair. The f16 halves widen exactly (__half2float keeps +-inf
// and subnormals), the same values the plain version's f16 -> f32 casts
// give.
//
// K6 (schedule_pack_home_kernel) replaces the home mode of the same
// Pallas kernel (pallas_call :579, fused_schedule.py:283-550), the
// home-prefix resolve on bounce 0 of a screen-ordered (h, w) frame. Its
// plain PyTorch version is schedule_pack_home_ref. K1's step loop runs
// unchanged, and routes each lane's leading run of candidates that lie
// in its lane block's home strip (the iterative pixel inside the strip
// shrunk by one pixel: iy in [y0-7, y0+14], ix in [x0-31, x0+158]) to
// at most 4 home slots instead of the pack; the first candidate not
// routed ends the prefix. After the loop the home slots are exact-tested
// in slot order with R1's hit rule: position re-derived as origin +
// cum * dir, the f16 raw depth from the strip widened exactly, th, lcum
// and lhd from their q40 codes. A prefix hit sets n_cand to 0 (the packed
// suffix stays in the slot rows); failed tests carry prev_diff and
// prev_sidx into the (11, N) resolve-state init that R1 starts from.
// Design: K1's, one thread a lane with its slots staged on chip and
// written as whole rows (below); a block takes HOME_BLOCK_ROWS screen
// rows of one 8x128-px lane block, so its (by, bx) is the strip index
// and each warp's 32 lanes are contiguous on screen and in memory. The
// routed candidates' codes stay in registers (unrolled selects, no local
// arrays); the minitile table and the few strip words the tests read
// come from device memory through the read-only cache, so shared memory
// holds only the staging. The tests compute R1's search budget only
// where it decides (a back ray behind the depth by more than th).
// Bound: K1's bytes plus the strips once (18 x 128 x 4 B per lane
// block, 18.7 MB at 1080p) plus the (11, N) f32 init, ~0.59 GB at
// 1080p, 0.175 ms.
//
// Per lane: rebuild the s_max-step march schedule (6 small steps, 12
// medium, then the per-lane large step; x1.1 step and +25% thickness
// growth on processed steps; sub-texel skip; screen exit), positions
// accumulated iteratively; test each processed step's [hitd - th, hitd]
// window against its 32x16-px minitile's f16 [min, max] linear depth;
// keep the first K survivors as slots 0..K-1 of the (K, N) outputs.
//
// What bounds K1 and K4 on an H100. On paper, bytes: each lane reads 34 B
// of ray state (K4: 38) and writes K*12 + 4 = 196 B of slots (K4: K*16 +
// 4 = 260 B), ~0.48 / ~0.62 GB at 1080p, 0.142 / 0.184 ms at 3.35 TB/s.
// Measured (scripts/pack_ablation.py, H100 80GB HBM3 at 700 W, 1080p,
// 24 steps): the earlier design took 0.36 ms on coherent test rays
// and 0.92-0.94 ms on the headline frame's own bounce-0 rays. Its split
// on those rays: (a) its slot stores, 0.61 ms: a lane stored its j-th
// candidate to row j at the step that found it, so on incoherent rays
// one warp store touched up to 32 rows (up to 32 sectors for 128 B);
// (b) every lane running all s_max steps, ~0: the warps' slowest lanes
// run 23.5-23.8 of 24 steps, so warps hardly ever retire early; (c) the
// step loop itself, 0.31-0.33 ms with no slot stored: ~150 SASS
// instructions a step (the three IEEE divides of the projection, the
// reciprocal of the linear depth, --fmad=false mul + add pairs),
// issue-bound (1,536 threads an SM gain K1 5-6%). So (c) bounds both
// kernels now, at ~0.45 of the bytes bound for K1, and the design
// removes (a):
//  - Slots staged on chip and written as whole rows. In the step loop a
//    thread puts its lane's slot fields into shared memory laid out
//    [field][K][blockDim] (field f, slot j of thread t at
//    stage[(f * K + j) * blockDim + t]): the thread index is the fastest
//    dimension, so any mix of slots across a warp hits 32 distinct
//    banks, and a thread writes only its own column (no __syncthreads).
//    After the loop it zeroes its slots from n_cand on, and the warp
//    copies its 32 lanes' rows (write_rows): 16-byte shared loads and
//    16-byte stores, 8 lanes to one row's 128 contiguous bytes; a lane
//    writing its own column row by row issued 4x the instructions. Every
//    row is written because the wrapper allocates with torch.empty.
//  - Early exit. A lane's loop ends once it has stopped marching or, its
//    pack full, run == K. Past either point no step changes an output:
//    with `marching` false, `proc`, `cand` and `exit_now` stay false, so
//    nothing is packed, routed or updated that the outputs read; with
//    run == K no slot is stored any more and n_cand = min(run, K) = K
//    either way; in home mode a packed candidate has already ended the
//    prefix (only a candidate that is not routed is packed, and it
//    clears `prefix`), so no later candidate is routed. A warp retires
//    once all its lanes have.
//  - The view-projection scalars in constant memory (c_scal), the
//    minitile table (16 KB at 1080p) in shared memory, the whole step
//    loop in registers, one thread per lane. No tensor cores: there is
//    no matrix product here.
// Shared memory a block: the table, then the staging, NF x K x blockDim
// f32 (3 x 16 x 4 = 192 B a thread for K1, 256 B for K4). The wrapper's
// budget (ops/fused_schedule.py pack_budget) picks the block size that
// keeps the most threads resident; the kernels are built for at most 512
// threads a block and two blocks an SM (__launch_bounds__(512, 2): at
// most 64 registers a thread). ptxas: K1 48 registers, K4 55, no
// spills. At 1080p K1 runs 512-thread blocks with 112 KB each, two an SM
// (1,024 threads, half the SM's warps; its registers would hold 1,365);
// K4 128-thread blocks with 32 KB, six an SM (768 threads; registers:
// ~1,150): shared memory, not registers, limits both.
// K4 reads its 96 KB of dual tables through __ldg: staging one combo's
// 32 KB in shared memory was slower at every block size (occupancy).
// K6 stages as K1 does, in blocks of HOME_BLOCK_ROWS x 128 threads that
// hold the staging only. Storing each slot at once cost K6 0.36 ms on
// the headline's own bounce-0 rays (H100 80GB HBM3, 700 W), as it did
// K1. 256-thread blocks of 2 rows (four an SM, 1,024 threads) were
// 0-15% faster than 128, 512 or 1,024 threads; the table in shared
// memory beside the staging 13-14% slower (fewer blocks an SM); the
// search budget on every test 1.5% slower. The post-loop tests are
// 0.08-0.10 ms of K6's time (64 registers with them, 55 without).
// scripts/pack_ablation.py builds patched copies of this file (the
// earlier stores, no exit, no slots, local arrays, staged tables, K6's
// block shapes) to measure the split and these choices.
//
// Numerics: built with --fmad=false, so every a*b+c rounds twice, as
// torch's elementwise ops do; divisions are IEEE (no fast math), cx / w
// stays a divide; q40 rounds half to even (rintf), like torch.round /
// jnp.round. The kernels are bit-identical to their plain versions.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "write_rows.cuh"

namespace {

constexpr int HOME_SLOTS = 4;
constexpr int HOME_PAIRS = 6;
constexpr int HOME_ROWS = 18;  // 3 bands x HOME_PAIRS pair windows

// view_proj row-major, then the linear-eye-depth coefficients zz, zw:
// copied from the wrapper's (18,) tensor on the launch's stream
// (cudaMemcpyToSymbolAsync, device to device, no host sync), so the
// step loop's multiplies read them as constant-bank operands instead of
// holding 18 registers. One copy per library, written by every K1, K4
// and K6 launch: launches with different cameras on several streams at
// once would race, so the entry points serve one stream at a time (the
// port launches on the current stream only).
__constant__ float c_scal[18];

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

__device__ __forceinline__ int pixel_index(float t, float fsize, int size) {
  // floor(t * size) clamped to [0, size - 1]; __float2int_rd saturates.
  int i = __float2int_rd(t * fsize);
  return min(max(i, 0), size - 1);
}

__device__ __forceinline__ float q40(float x, float mx) {
  return fminf(fmaxf(rintf(x * 40.0f), 0.0f), mx);
}

// Per-lane inputs every mode reads.
struct LaneArgs {
  const float* ray_pos;
  const float* ray_dir;
  const float* dither;
  const float* large_step;
  const uint8_t* alive;
  const uint8_t* is_back;
  float* pk_cum;
  float* pk_scode;
  float* pk_hist;
  int32_t* n_cand;
};

// The scalar march parameters (f32-rounded by the wrapper); fgh, fgw are
// gh, gw as f32.
struct MarchParams {
  int n, gh, gw, minis_x, n_mini_words, s_max, k, max_small, max_medium;
  float small_step, medium_step, thickness, th_inc, step_growth, th_cap, texel_x, texel_y;
  float fgh, fgw;
};

// Per-lane inputs and outputs of the dual mode (unused by K1 and K6).
struct DualArgs {
  const int32_t* combo;
  const uint8_t* search;
  const uint32_t* bmax_table;
  float* pk_step;
  int combo_words;
};

// The home mode's lane block and outputs (unused by K1 and K4).
struct HomeArgs {
  const uint32_t* strip;  // the lane block's HOME_ROWS x 128 words
  int by, bx;
  float* home_out;  // (11, N) resolve-state init
};

// One lane: the step loop, the pack, and (HOME) the prefix routing and
// the exact tests of the routed candidates. The slots go to the thread's
// column `stage_col` of the block's staging, [field][K][blockDim]; the
// kernel writes the rows after the loop (write_rows).
template <bool DUAL, bool HOME>
__device__ __forceinline__ void pack_lane(int lane, const LaneArgs& a,
                                          const uint32_t* mini_table, const MarchParams& p,
                                          const DualArgs& dual, const HomeArgs& home,
                                          float* stage_col) {
  constexpr int NF = DUAL ? 4 : 3;
  const float* m = c_scal;
  const float zz = c_scal[16], zw = c_scal[17];
  const int n = p.n, k = p.k;
  const float ox = a.ray_pos[3 * lane], oy = a.ray_pos[3 * lane + 1], oz = a.ray_pos[3 * lane + 2];
  float px = ox, py = oy, pz = oz;
  const float dx = a.ray_dir[3 * lane], dy = a.ray_dir[3 * lane + 1], dz = a.ray_dir[3 * lane + 2];
  const float dth = a.dither[lane];
  const float lstep = a.large_step[lane];
  bool marching = a.alive[lane] != 0;
  const bool backray = DUAL ? false : a.is_back[lane] != 0;
  const bool searchlane = DUAL ? dual.search[lane] != 0 : false;
  const int combo_off = DUAL ? dual.combo[lane] * dual.combo_words : 0;
  // Field f of slot j, staged on chip.
  auto slot = [&](int f, int j) -> float& {
    return stage_col[(f * k + j) * static_cast<int>(blockDim.x)];
  };

  // Home prefix state, per routed candidate as captured before the
  // step's post-test update: cum, the q40 code of th, the hist word (the
  // q40 codes of lcum and lhd, exact in f32, as a packed slot holds them)
  // and the step index i - 1 | (pidx + 1) << 16. The tests read only
  // these codes, so four words hold what six floats did.
  const int hp = min(HOME_SLOTS, k);
  const int y0 = home.by * 8, x0 = home.bx * 128;
  bool prefix = true;
  int run_home = 0;
  float hs_cum[HOME_SLOTS], hs_thq[HOME_SLOTS], hs_hist[HOME_SLOTS];
  int hs_steps[HOME_SLOTS];
#pragma unroll
  for (int j = 0; j < HOME_SLOTS; ++j) {
    hs_cum[j] = hs_thq[j] = hs_hist[j] = 0.0f;
    hs_steps[j] = 0;
  }

  float last_u, last_v, raw0;
  project(m, px, py, pz, last_u, last_v, raw0);
  float step = p.small_step, th = p.thickness;
  float cum = 0.0f, lcum = 0.0f, lhd = 0.0f, pidx = -1.0f;
  int run = 0;

  // The early exit (see the note at the top): the loop ends once the lane
  // has stopped marching or holds k packed candidates.
  for (int i = 1; i <= p.s_max && marching && run < k; ++i) {
    if (i == p.max_small + 1) { step = p.medium_step; th = p.thickness; }
    if (i == p.max_medium + 1) { step = lstep; th = p.thickness; }
    const float adv = step + step * dth;
    cum = cum + adv;
    px = px + adv * dx;
    py = py + adv * dy;
    pz = pz + adv * dz;
    float u, v, raw;
    project(m, px, py, pz, u, v, raw);

    const bool skip = (i <= p.max_medium) && (fabsf(u - last_u) < p.texel_x) &&
                      (fabsf(v - last_v) < p.texel_y);
    const bool in_screen = (u > 0.0f) && (u < 1.0f) && (v > 0.0f) && (v < 1.0f);
    const bool exit_now = marching && !skip && !in_screen;
    const bool proc = marching && !skip && in_screen;

    const int ix = pixel_index(u, p.fgw, p.gw);
    const int iy = pixel_index(v, p.fgh, p.gh);
    const float hitd = 1.0f / (raw * zz + zw);
    // ix, iy >= 0: the shifts are the reference's floor divisions.
    const int mini = min((iy >> 4) * p.minis_x + (ix >> 5) + combo_off, p.n_mini_words - 1);
    bool cand;
    if constexpr (DUAL) {
      const uint32_t word = __ldg(mini_table + mini);
      const uint32_t bword = __ldg(dual.bmax_table + mini);
      const float mmin = half_bits_to_float(word);
      const float umax = half_bits_to_float(word >> 16);
      const float bmax = half_bits_to_float(bword);
      const float margin = fmaxf(th, step);
      cand = proc && (hitd >= mmin) &&
             ((hitd - margin <= umax) || searchlane || (hitd <= bmax));
    } else {
      // K1's table sits in shared memory, K6's in device memory.
      uint32_t word;
      if constexpr (HOME) {
        word = __ldg(mini_table + mini);
      } else {
        word = mini_table[mini];
      }
      const float mmin = half_bits_to_float(word);
      const float mmax = half_bits_to_float(word >> 16);
      cand = proc && (hitd >= mmin) && ((hitd - th <= mmax) || backray);
    }

    bool pack = cand;
    if (HOME && cand) {
      const bool route = prefix && run_home < hp && iy >= y0 - 7 && iy <= y0 + 14 &&
                         ix >= x0 - 31 && ix <= x0 + 158;
      if (route) {
        const float thq = q40(th, p.th_cap);
        const float hist = q40(lcum, 4095.0f) * 4096.0f + q40(lhd, 4095.0f);
        const int steps = (i - 1) | (static_cast<int>(pidx + 1.0f) << 16);
#pragma unroll
        for (int j = 0; j < HOME_SLOTS; ++j) {
          if (j == run_home) {
            hs_cum[j] = cum;
            hs_thq[j] = thq;
            hs_hist[j] = hist;
            hs_steps[j] = steps;
          }
        }
        ++run_home;
        pack = false;
      } else {
        prefix = false;  // every routed candidate precedes every packed one
      }
    }
    if (pack) {
      if (run < k) {
        const float scode = static_cast<float>(i - 1) + 65.0f * (pidx + 1.0f) +
                            q40(th, p.th_cap) * 8192.0f;
        const float hist = q40(lcum, 4095.0f) * 4096.0f + q40(lhd, 4095.0f);
        const float qstep = DUAL ? q40(step, 4095.0f) : 0.0f;
        slot(0, run) = cum;
        slot(1, run) = scode;
        slot(2, run) = hist;
        if (DUAL) slot(3, run) = qstep;
      }
      ++run;
    }
    if (proc) {
      step = step + step * p.step_growth;
      th = th + p.th_inc;
      last_u = u;
      last_v = v;
      lcum = cum;
      lhd = hitd;
      pidx = static_cast<float>(i - 1);
    }
    marching = marching && !exit_now;
  }
  const int cnt = min(run, k);
  // Zeros past the count; the kernel then copies the rows (write_rows).
  for (int j = cnt; j < k; ++j) {
#pragma unroll
    for (int f = 0; f < NF; ++f) slot(f, j) = 0.0f;
  }
  if (!HOME) {
    a.n_cand[lane] = cnt;
    return;
  }

  // The prefix's exact tests, in slot (= step) order: R1's plain hit rule
  // on the re-derived position and the quantized metadata.
  bool hitf = false;
  float h_cum = 0.0f, h_diff = 0.0f, h_th = 0.0f, h_hitd = 0.0f, h_lcum = 0.0f;
  float h_lhd = 0.0f, h_pidx = 0.0f, h_ixy = 0.0f, pdiff = 0.0f, psidx = -1.0f;
#pragma unroll
  for (int j = 0; j < HOME_SLOTS; ++j) {
    if (j >= run_home || hitf) continue;
    const float cum_j = hs_cum[j];
    const float th_q = hs_thq[j] * 0.025f;
    const float sidx = static_cast<float>(hs_steps[j] & 0xFFFF);
    float u2, v2, raw2;
    project(m, ox + cum_j * dx, oy + cum_j * dy, oz + cum_j * dz, u2, v2, raw2);
    const float hitd2 = 1.0f / (raw2 * zz + zw);
    const int ix2 = pixel_index(u2, p.fgw, p.gw);
    const int iy2 = pixel_index(v2, p.fgh, p.gh);
    // Routed slots lie inside the strip by the routing shrink; the clamp
    // only mirrors the reference's.
    const int srow = min(max(((iy2 >> 3) - (home.by - 1)) * HOME_PAIRS +
                             ((ix2 >> 5) - (home.bx * 4 - 1)), 0), HOME_ROWS - 1);
    const uint32_t word = __ldg(home.strip + srow * 128 + (((iy2 & 7) << 4) | (ix2 & 15)));
    const uint32_t bits16 = ((ix2 >> 4) & 1) ? (word >> 16) : (word & 0xFFFFu);
    const float d_raw = half_bits_to_float(bits16);  // exact, subnormals too
    const bool is_sky = bits16 == 0u;
    const float dd = 1.0f / (d_raw * zz + zw) - hitd2;
    // R1's rule, (dd <= 0) & !sky & ((dd >= -th_q) | (back & budget_ok)),
    // with the search budget computed only where it decides.
    bool hit = (dd <= 0.0f) && !is_sky;
    if (hit && !(dd >= -th_q)) {
      hit = false;
      if (backray) {
        const float halv = ceilf(log2f(fmaxf(-dd / fmaxf(th_q, 1e-6f), 1.0f)));
        hit = sidx + 1.0f + halv <= static_cast<float>(p.s_max);
      }
    }
    if (hit) {
      hitf = true;
      h_cum = cum_j;
      h_diff = dd;
      h_th = th_q;
      h_hitd = hitd2;
      const int hist_j = static_cast<int>(hs_hist[j]);
      h_lcum = static_cast<float>(hist_j >> 12) * 0.025f;
      h_lhd = static_cast<float>(hist_j & 4095) * 0.025f;
      h_pidx = static_cast<float>(hs_steps[j] >> 16) - 1.0f;
      h_ixy = static_cast<float>(iy2 * p.gw + ix2);
    } else {
      pdiff = dd;
      psidx = sidx;
    }
  }
  a.n_cand[lane] = hitf ? 0 : cnt;
  const size_t nn = static_cast<size_t>(n);
  float* ho = home.home_out + lane;
  ho[0 * nn] = hitf ? 1.0f : 0.0f;
  ho[1 * nn] = h_cum;
  ho[2 * nn] = h_diff;
  ho[3 * nn] = h_th;
  ho[4 * nn] = h_hitd;
  ho[5 * nn] = h_lcum;
  ho[6 * nn] = h_lhd;
  ho[7 * nn] = h_pidx;
  ho[8 * nn] = h_ixy;
  ho[9 * nn] = pdiff;
  ho[10 * nn] = psidx;
}

// Dynamic shared memory: K1 the minitile table (n_mini_words; K4 reads
// its tables through __ldg), then the slot staging (NF x k x blockDim.x
// f32).
template <bool DUAL>
__global__ void __launch_bounds__(512, 2)
schedule_pack_kernel(LaneArgs a, const uint32_t* __restrict__ mini_table, DualArgs dual,
                     MarchParams p) {
  extern __shared__ uint32_t s_dyn[];
  const int table_words = DUAL ? 0 : p.n_mini_words;
  for (int i = threadIdx.x; i < table_words; i += blockDim.x) s_dyn[i] = mini_table[i];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const HomeArgs none = {nullptr, 0, 0, nullptr};
  float* stage = reinterpret_cast<float*>(s_dyn + table_words);
  if (lane < p.n) {
    pack_lane<DUAL, false>(lane, a, DUAL ? mini_table : s_dyn, p, dual, none,
                           stage + threadIdx.x);
  }
  float* const outs[4] = {a.pk_cum, a.pk_scode, a.pk_hist, dual.pk_step};
  write_rows<DUAL ? 4 : 3>(stage, outs, p.n, p.k, blockIdx.x * blockDim.x);
}

// K6's block: HOME_BLOCK_ROWS screen rows of one 8 x 128-px lane block,
// one thread a lane, at most 64 registers a thread for HOME_MIN_BLOCKS
// blocks an SM (1,024 threads: the staging, 48 KB a block, allows 4).
constexpr int HOME_BLOCK_ROWS = 2;
constexpr int HOME_MIN_BLOCKS = 4;

// Block (bx, y) marches screen rows y * HOME_BLOCK_ROWS .. + HOME_BLOCK_ROWS
// - 1, columns bx * 128 .. + 127: thread t takes row t / 128, column
// t % 128, so each warp's 32 lanes are contiguous. Dynamic shared memory:
// the slot staging (3 x K x blockDim f32). The minitile table (16 KB at
// 1080p) and the home strip of the block's lane block are read from
// device memory through the read-only cache.
__global__ void __launch_bounds__(HOME_BLOCK_ROWS * 128, HOME_MIN_BLOCKS)
schedule_pack_home_kernel(LaneArgs a, const uint32_t* __restrict__ mini_table,
                          const uint32_t* __restrict__ strips, float* __restrict__ home_out,
                          MarchParams p, int lane_w) {
  extern __shared__ float stage[];
  const int row = blockIdx.y * HOME_BLOCK_ROWS + (threadIdx.x >> 7);
  const int by = row >> 3, bx = blockIdx.x;
  const int lane = row * lane_w + bx * 128 + (threadIdx.x & 127);
  const DualArgs none = {nullptr, nullptr, nullptr, nullptr, 0};
  const HomeArgs home = {strips + (static_cast<size_t>(by) * gridDim.x + bx) * HOME_ROWS * 128,
                         by, bx, home_out};
  pack_lane<false, true>(lane, a, mini_table, p, none, home, stage + threadIdx.x);
  float* const outs[3] = {a.pk_cum, a.pk_scode, a.pk_hist};
  write_rows<3>(stage, outs, p.n, p.k, lane - threadIdx.x);
}

// The kernel's dynamic shared memory above 48 KB, and the scalars into
// constant memory on the launch's stream.
int prepare(const void* kernel, int smem, const void* scalars, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaMemcpyToSymbolAsync(c_scal, scalars, sizeof(c_scal), 0,
                                                  cudaMemcpyDeviceToDevice,
                                                  static_cast<cudaStream_t>(stream)));
}

template <bool DUAL>
int launch_pack(const LaneArgs& a, const void* mini_table, const void* scalars,
                const DualArgs& dual, const MarchParams& p, int threads, int smem,
                void* stream) {
  const int e = prepare(reinterpret_cast<const void*>(schedule_pack_kernel<DUAL>), smem,
                        scalars, stream);
  if (e != 0) return e;
  if (p.n > 0) {
    const int blocks = (p.n + threads - 1) / threads;
    schedule_pack_kernel<DUAL><<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        a, static_cast<const uint32_t*>(mini_table), dual, p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `threads` (a block) and `smem` (dynamic shared bytes a block) come from
// the wrapper's budget, ops/fused_schedule.py pack_budget.
// The scalars go to the library's one constant copy (c_scal) on `stream`
// before the launch: call the entry points from one stream at a time.
extern "C" int sspt_schedule_pack(
    const void* ray_pos, const void* ray_dir, const void* dither,
    const void* large_step, const void* alive, const void* is_back,
    const void* mini_table, const void* scalars, void* pk_cum, void* pk_scode,
    void* pk_hist, void* n_cand, int n, int gh, int gw, int minis_x,
    int n_mini_words, int s_max, int k, int max_small, int max_medium,
    float small_step, float medium_step, float thickness, float th_inc,
    float step_growth, float th_cap, float texel_x, float texel_y,
    int threads, int smem, void* stream) {
  const LaneArgs a = {
      static_cast<const float*>(ray_pos), static_cast<const float*>(ray_dir),
      static_cast<const float*>(dither), static_cast<const float*>(large_step),
      static_cast<const uint8_t*>(alive), static_cast<const uint8_t*>(is_back),
      static_cast<float*>(pk_cum), static_cast<float*>(pk_scode),
      static_cast<float*>(pk_hist), static_cast<int32_t*>(n_cand)};
  const MarchParams p = {n, gh, gw, minis_x, n_mini_words, s_max, k, max_small, max_medium,
                         small_step, medium_step, thickness, th_inc, step_growth, th_cap,
                         texel_x, texel_y, static_cast<float>(gh), static_cast<float>(gw)};
  const DualArgs none = {nullptr, nullptr, nullptr, nullptr, 0};
  return launch_pack<false>(a, mini_table, scalars, none, p, threads, smem, stream);
}

// As sspt_schedule_pack, with the dual inputs and pk_step.
// The scalars go to the library's one constant copy (c_scal) on `stream`
// before the launch: call the entry points from one stream at a time.
extern "C" int sspt_schedule_pack_dual(
    const void* ray_pos, const void* ray_dir, const void* dither,
    const void* large_step, const void* alive, const void* combo,
    const void* search, const void* mini_table, const void* bmax_table,
    const void* scalars, void* pk_cum, void* pk_scode, void* pk_hist,
    void* pk_step, void* n_cand, int n, int gh, int gw, int minis_x,
    int n_mini_words, int combo_words, int s_max, int k, int max_small,
    int max_medium, float small_step, float medium_step, float thickness,
    float th_inc, float step_growth, float th_cap, float texel_x,
    float texel_y, int threads, int smem, void* stream) {
  const LaneArgs a = {
      static_cast<const float*>(ray_pos), static_cast<const float*>(ray_dir),
      static_cast<const float*>(dither), static_cast<const float*>(large_step),
      static_cast<const uint8_t*>(alive), nullptr,
      static_cast<float*>(pk_cum), static_cast<float*>(pk_scode),
      static_cast<float*>(pk_hist), static_cast<int32_t*>(n_cand)};
  const MarchParams p = {n, gh, gw, minis_x, n_mini_words, s_max, k, max_small, max_medium,
                         small_step, medium_step, thickness, th_inc, step_growth, th_cap,
                         texel_x, texel_y, static_cast<float>(gh), static_cast<float>(gw)};
  const DualArgs dual = {
      static_cast<const int32_t*>(combo), static_cast<const uint8_t*>(search),
      static_cast<const uint32_t*>(bmax_table), static_cast<float*>(pk_step),
      combo_words};
  return launch_pack<true>(a, mini_table, scalars, dual, p, threads, smem, stream);
}

// Lanes are the screen-ordered (h, w) pixel grid, h % 8 == 0 and
// w % 128 == 0 (the wrapper checks); strips is (h/8, w/128, 18, 128).
// `smem` (dynamic shared bytes a block) comes from the wrapper's budget
// for HOME_BLOCK_ROWS x 128 threads: less than the staging is refused.
// The scalars go to the library's one constant copy (c_scal) on `stream`
// before the launch: call the entry points from one stream at a time.
extern "C" int sspt_schedule_pack_home(
    const void* ray_pos, const void* ray_dir, const void* dither,
    const void* large_step, const void* alive, const void* is_back,
    const void* mini_table, const void* strips, const void* scalars, void* pk_cum,
    void* pk_scode, void* pk_hist, void* n_cand, void* home_out, int h, int w, int gh,
    int gw, int minis_x, int n_mini_words, int s_max, int k, int max_small, int max_medium,
    float small_step, float medium_step, float thickness, float th_inc,
    float step_growth, float th_cap, float texel_x, float texel_y, int smem, void* stream) {
  constexpr int threads = HOME_BLOCK_ROWS * 128;
  if (smem < 3 * k * threads * 4) return static_cast<int>(cudaErrorInvalidValue);
  const int e = prepare(reinterpret_cast<const void*>(schedule_pack_home_kernel), smem, scalars,
                        stream);
  if (e != 0) return e;
  if (h > 0 && w > 0) {
    const LaneArgs a = {
        static_cast<const float*>(ray_pos), static_cast<const float*>(ray_dir),
        static_cast<const float*>(dither), static_cast<const float*>(large_step),
        static_cast<const uint8_t*>(alive), static_cast<const uint8_t*>(is_back),
        static_cast<float*>(pk_cum), static_cast<float*>(pk_scode),
        static_cast<float*>(pk_hist), static_cast<int32_t*>(n_cand)};
    const MarchParams p = {h * w, gh, gw, minis_x, n_mini_words, s_max, k, max_small, max_medium,
                           small_step, medium_step, thickness, th_inc, step_growth, th_cap,
                           texel_x, texel_y, static_cast<float>(gh), static_cast<float>(gw)};
    const dim3 grid(w / 128, h / HOME_BLOCK_ROWS);
    schedule_pack_home_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        a, static_cast<const uint32_t*>(mini_table), static_cast<const uint32_t*>(strips),
        static_cast<float*>(home_out), p, w);
  }
  return static_cast<int>(cudaGetLastError());
}
