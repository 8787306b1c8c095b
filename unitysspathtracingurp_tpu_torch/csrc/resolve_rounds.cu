// R1: hiz resolve rounds, plain layout and dual mode.
//
// Replaces unitysspathtracingurp_tpu/ops/pathtrace_hiz.py run_rounds
// (:601-843, dense rounds, plain layout), which the JAX package writes
// in XLA: per round a 128-word row gather of the pointed candidate's
// 32x8-px depth pair (row_gather, pallas_gather.py:260) plus one-hot
// selects, priced for TPU gathers. The plain PyTorch version is
// ops/pathtrace_hiz.py resolve_rounds_ref.
//
// Per lane, per round: link 0 is the candidate at `ptr`, link j the one
// at ptr + j. Each link's position is re-derived as origin + cum * dir,
// projected, and its texel's f16 raw depth is read as ONE u32 word
// pair_table[pair * 128 + texel]. Hit rule: d <= 0, not sky, and
// d >= -th or (back ray and the emulated binary search fits the step
// budget). Link 0 is tested whenever valid; link j > 0 only if link
// j-1 failed and it lies in link 0's 32x8-px window (pair == pair0);
// ptr advances past every failed link. These rules decide which
// candidates a round budget reaches, so they are kept exactly.
//
// What bounds it on an H100: scattered 4-byte reads. Each tested link
// reads 12 B of slot fields (coalesced: slot rows are lane-major) and
// one pair-table word at a data-dependent address; the pair table is
// 4.2 MB at 1080p and fits in the 50 MB L2, so the scattered reads can
// be served from L2 rather than device memory. Design: one thread per
// lane, rounds and links as loops in registers, early exit when the
// lane hits or runs out of candidates; the 11 per-lane resolve fields
// are written once at the end as rows of an (11, N) f32 table.
//
// Dual mode (DUAL = true; the refraction / backface variants on
// DualDepthTiles, pathtrace_hiz.py:682-694, 736-793, 836, also XLA in
// the JAX package; plain version resolve_rounds_dual_ref). Per link it
// reads ONE tile_table word at (combo * tiles_per_combo + tile) * 128 +
// texel: low f16 the test layer, high f16 the back layer. Later links
// stay inside link 0's 16x8-px tile. The hit rule adds back_ok, the
// signed diff sd, the backed window (d <= 0, hitd <= max(back, test +
// step)) beside the plain thickness window, the search rule (search
// lanes, and with back data front rays below a valid back surface, hit
// any crossing within the halving budget) and back_hit_now; the kernel
// returns R1's 11 rows plus hit_sd, prev_sd, hit_back, hit_via_search.
// The tile table is 3 x 16,200 x 128 words = 24.9 MB at 1080p, inside
// the 50 MB L2. Bound: per lane the K*16 B of slots (read at most once
// each) plus 36 B of ray state in, 15 * 4 B out; the data-dependent
// table words are counted by chip_smoke.py from the links tested.
//
// State-in form (both modes): `state` is a (1 + rows, N) f32 table, ptr
// then the 11 (dual: 15) resolve rows, that the rounds start from instead
// of ptr = 0 and the zero state; `out` then has the same layout and
// receives the state after the rounds. A null `state` keeps the zero
// start and the (rows, N) output. It serves K6's resolve-state init (the
// home prefix's hits and its failed tests' prev_diff / prev_sidx), the
// rounds run on compacted lanes after dense ones, and the diagnostic
// march's one-round-at-a-time counts.
//
// Numerics: --fmad=false and IEEE divides, as in schedule_pack.cu.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float half_bits_to_float(uint32_t bits) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(bits & 0xFFFFu)));
}

__device__ __forceinline__ int pixel_index(float t, int size) {
  int i = __float2int_rd(t * static_cast<float>(size));
  return min(max(i, 0), size - 1);
}

// Per-lane inputs of the dual mode (unused by the plain layout).
struct DualArgs {
  const float* pk_step;
  const int32_t* combo;
  const uint8_t* search;
  int tiles_per_combo;
  bool has_back;
};

template <bool DUAL>
__global__ void resolve_rounds_kernel(
    const float* __restrict__ pk_cum, const float* __restrict__ pk_scode,
    const float* __restrict__ pk_hist, const int32_t* __restrict__ n_cand,
    const float* __restrict__ ray_pos, const float* __restrict__ ray_dir,
    const uint8_t* __restrict__ is_back, const uint32_t* __restrict__ table,
    const float* __restrict__ scalars, const float* __restrict__ state,
    float* __restrict__ out, DualArgs dual, int n, int k, int gh, int gw, int pairs_x,
    int n_rounds, int chain, int s_max) {
  __shared__ float s_m[18];
  if (threadIdx.x < 18) s_m[threadIdx.x] = scalars[threadIdx.x];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  float m[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) m[i] = s_m[i];
  const float zz = s_m[16], zw = s_m[17];

  const float ox = ray_pos[3 * lane], oy = ray_pos[3 * lane + 1], oz = ray_pos[3 * lane + 2];
  const float dx = ray_dir[3 * lane], dy = ray_dir[3 * lane + 1], dz = ray_dir[3 * lane + 2];
  const bool backray = is_back[lane] != 0;
  const int nc = n_cand[lane];
  // Dual mode: the lane's combo rows and search capability. pairs_x is
  // tiles_x in this mode (single-tile rows).
  const size_t row_off = DUAL ? static_cast<size_t>(dual.combo[lane]) * dual.tiles_per_combo : 0;
  const bool searchlane = DUAL ? dual.search[lane] != 0 : false;

  bool hit = false;
  float h_cum = 0.0f, h_diff = 0.0f, h_th = 0.0f, h_hitd = 0.0f;
  float h_lcum = 0.0f, h_lhd = 0.0f;
  int h_prev = 0, h_ixy = 0, prev_sidx = -1;
  float prev_diff = 0.0f;
  float h_sd = 0.0f, prev_sd = 0.0f;
  bool h_back = false, h_search = false;
  int ptr = 0;
  const size_t nn = static_cast<size_t>(n);
  if (state != nullptr) {
    const float* st = state + lane;
    ptr = static_cast<int>(st[0]);
    hit = st[1 * nn] > 0.5f;
    h_cum = st[2 * nn];
    h_diff = st[3 * nn];
    h_th = st[4 * nn];
    h_hitd = st[5 * nn];
    h_lcum = st[6 * nn];
    h_lhd = st[7 * nn];
    h_prev = static_cast<int>(st[8 * nn]);
    h_ixy = static_cast<int>(st[9 * nn]);
    prev_diff = st[10 * nn];
    prev_sidx = static_cast<int>(st[11 * nn]);
    if (DUAL) {
      h_sd = st[12 * nn];
      prev_sd = st[13 * nn];
      h_back = st[14 * nn] > 0.5f;
      h_search = st[15 * nn] > 0.5f;
    }
  }

  for (int r = 0; r < n_rounds; ++r) {
    if (hit || ptr >= nc) break;  // inactive lanes stay inactive
    int pair0 = 0;
    int adv = 0;
    for (int j = 0; j < chain; ++j) {
      const int s = ptr + j;
      if (s >= nc) break;
      const size_t o = static_cast<size_t>(s) * n + lane;
      const float cd = pk_cum[o];
      const float scode = pk_scode[o];
      const float hist = pk_hist[o];
      const float th = floorf(scode / 8192.0f) * 0.025f;
      const float sbase = fmodf(scode, 8192.0f);
      const int s_idx = static_cast<int>(fmodf(sbase, 65.0f));
      const int p_idx = static_cast<int>(floorf(sbase / 65.0f)) - 1;
      const float lcum = floorf(hist / 4096.0f) * 0.025f;
      const float lhd = fmodf(hist, 4096.0f) * 0.025f;

      const float px = ox + cd * dx, py = oy + cd * dy, pz = oz + cd * dz;
      float cx = px * m[0] + py * m[1] + pz * m[2] + m[3];
      float cy = px * m[4] + py * m[5] + pz * m[6] + m[7];
      float cz = px * m[8] + py * m[9] + pz * m[10] + m[11];
      float w = px * m[12] + py * m[13] + pz * m[14] + m[15];
      if (fabsf(w) < 1e-12f) w = 1e-12f;
      const float u = cx / w * 0.5f + 0.5f;
      const float v = cy / w * 0.5f + 0.5f;
      const float hitd = 1.0f / (cz / w * zz + zw);
      const int ix = pixel_index(u, gw);
      const int iy = pixel_index(v, gh);
      const int txi = ix / 16;
      const int pair = DUAL ? (iy / 8) * pairs_x + txi : (iy / 8) * pairs_x + txi / 2;
      const int texel = (iy % 8) * 16 + ix % 16;
      if (j == 0) {
        pair0 = pair;
      } else if (pair != pair0) {
        break;  // later links resolve only inside link 0's window
      }
      float d, sd = 0.0f;
      bool hit_now, base_hit = false, back_hit_now = false;
      if (DUAL) {
        const float step = dual.pk_step[o] * 0.025f;
        const uint32_t word = table[(row_off + pair) * 128 + texel];
        const float t_raw = half_bits_to_float(word);
        const float b_raw = half_bits_to_float(word >> 16);
        const float scene = 1.0f / (t_raw * zz + zw);
        const bool is_sky = t_raw == 0.0f;
        const float scene_back = 1.0f / (b_raw * zz + zw);
        const bool back_ok = (b_raw != 0.0f) && (scene_back >= scene);
        d = scene - hitd;
        const bool is_bs = backray && (hitd > scene_back) && back_ok;
        sd = is_bs ? (back_ok ? hitd - scene_back : d - th) : d;
        const bool hit_backed = (d <= 0.0f) && (hitd <= fmaxf(scene_back, scene + step));
        const bool hit_plain = (d <= 0.0f) && (d >= -th);
        base_hit = back_ok ? hit_backed : hit_plain;
        const float halvings = ceilf(log2f(fmaxf(-d / fmaxf(th, 1e-6f), 1.0f)));
        const bool budget_ok =
            static_cast<float>(s_idx + 1) + halvings <= static_cast<float>(s_max);
        const bool search_ok =
            searchlane || (dual.has_back && !backray && back_ok && (hitd <= scene_back));
        hit_now = !is_sky && (base_hit || (search_ok && (d <= 0.0f) && budget_ok));
        back_hit_now = hit_now && back_ok && (hitd > scene_back) && (sd >= 0.0f);
      } else {
        const uint32_t word = table[static_cast<size_t>(pair) * 128 + texel];
        const float d_raw = half_bits_to_float((txi & 1) ? (word >> 16) : word);
        const float scene = 1.0f / (d_raw * zz + zw);
        const bool is_sky = d_raw == 0.0f;
        d = scene - hitd;
        const float halvings = ceilf(log2f(fmaxf(-d / fmaxf(th, 1e-6f), 1.0f)));
        const bool budget_ok =
            static_cast<float>(s_idx + 1) + halvings <= static_cast<float>(s_max);
        const bool in_window = (d >= -th) || (backray && budget_ok);
        hit_now = (d <= 0.0f) && in_window && !is_sky;
      }
      if (hit_now) {
        hit = true;
        h_cum = cd;
        h_diff = d;
        h_th = th;
        h_hitd = hitd;
        h_lcum = lcum;
        h_lhd = lhd;
        h_prev = p_idx;
        h_ixy = iy * gw + ix;
        h_sd = sd;
        h_back = back_hit_now;
        h_search = !base_hit;
        break;
      }
      prev_diff = d;
      prev_sidx = s_idx;
      prev_sd = sd;
      ++adv;
    }
    ptr += adv;
  }
  if (state != nullptr) {
    out[lane] = static_cast<float>(ptr);
    out += nn;
  }
  out[0 * nn + lane] = hit ? 1.0f : 0.0f;
  out[1 * nn + lane] = h_cum;
  out[2 * nn + lane] = h_diff;
  out[3 * nn + lane] = h_th;
  out[4 * nn + lane] = h_hitd;
  out[5 * nn + lane] = h_lcum;
  out[6 * nn + lane] = h_lhd;
  out[7 * nn + lane] = static_cast<float>(h_prev);
  out[8 * nn + lane] = static_cast<float>(h_ixy);
  out[9 * nn + lane] = prev_diff;
  out[10 * nn + lane] = static_cast<float>(prev_sidx);
  if (DUAL) {
    out[11 * nn + lane] = h_sd;
    out[12 * nn + lane] = prev_sd;
    out[13 * nn + lane] = h_back ? 1.0f : 0.0f;
    out[14 * nn + lane] = h_search ? 1.0f : 0.0f;
  }
}

}  // namespace

extern "C" int sspt_resolve_rounds(
    const void* pk_cum, const void* pk_scode, const void* pk_hist,
    const void* n_cand, const void* ray_pos, const void* ray_dir,
    const void* is_back, const void* pair_table, const void* scalars,
    const void* state, void* out, int n, int k, int gh, int gw, int pairs_x,
    int n_rounds, int chain, int s_max, void* stream) {
  if (n > 0) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    const DualArgs none = {nullptr, nullptr, nullptr, 0, false};
    resolve_rounds_kernel<false><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pk_cum), static_cast<const float*>(pk_scode),
        static_cast<const float*>(pk_hist), static_cast<const int32_t*>(n_cand),
        static_cast<const float*>(ray_pos), static_cast<const float*>(ray_dir),
        static_cast<const uint8_t*>(is_back), static_cast<const uint32_t*>(pair_table),
        static_cast<const float*>(scalars), static_cast<const float*>(state),
        static_cast<float*>(out), none, n, k, gh, gw, pairs_x, n_rounds, chain, s_max);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sspt_resolve_rounds_dual(
    const void* pk_cum, const void* pk_scode, const void* pk_hist,
    const void* pk_step, const void* n_cand, const void* ray_pos,
    const void* ray_dir, const void* is_back, const void* combo,
    const void* search, const void* tile_table, const void* scalars,
    const void* state, void* out, int n, int k, int gh, int gw, int tiles_x,
    int tiles_per_combo, int n_rounds, int chain, int s_max, int has_back, void* stream) {
  if (n > 0) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    const DualArgs dual = {
        static_cast<const float*>(pk_step), static_cast<const int32_t*>(combo),
        static_cast<const uint8_t*>(search), tiles_per_combo, has_back != 0};
    resolve_rounds_kernel<true><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pk_cum), static_cast<const float*>(pk_scode),
        static_cast<const float*>(pk_hist), static_cast<const int32_t*>(n_cand),
        static_cast<const float*>(ray_pos), static_cast<const float*>(ray_dir),
        static_cast<const uint8_t*>(is_back), static_cast<const uint32_t*>(tile_table),
        static_cast<const float*>(scalars), static_cast<const float*>(state),
        static_cast<float*>(out), dual, n, k, gh, gw, tiles_x, n_rounds, chain, s_max);
  }
  return static_cast<int>(cudaGetLastError());
}
