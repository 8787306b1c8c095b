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
//
// What bounds it on an H100. Not bytes and not arithmetic: memory
// latency, how many warps an SM holds to cover it, and SIMT divergence.
// A link is a serial chain: its slot fields (cum, scode; dual: step)
// from device memory (the (K, N) packs, 398 MB at 1080p, do not fit the
// 50 MB L2), the projection, one 4-byte table word at a data-dependent
// address (the 4.2 MB pair table and the 24.9 MB tile table stay in
// L2), the hit rule. A warp runs as long as its lane with the most
// links. The earlier design ran rounds x chain as two nested loops, so a
// warp ran, round by round, the most links any of its lanes tested in
// that round (the sum over rounds of the maxima, not the maximum of the
// sums), decoded every link with f32 floorf / fmodf (fmodf is a loop in
// SASS) and computed the search budget's divide, log2f and ceilf on
// every link: ~420 SASS instructions a link at 70-79 registers.
//
// The design (scripts/resolve_ablation.py measured each choice; PERF.md
// has the numbers):
// - each lane walks its links in ONE flat loop, one link an iteration,
//   with its round r and chain position j as state: a failed link moves
//   to j + 1, or to the next round after `chain` links; a link outside
//   link 0's window starts the next round as its link 0. A warp now runs
//   the most links of any of its lanes, once;
// - the loop only updates registers; every lane writes its rows after
//   it, together (rows written at a lane's own exit inside the loop cost
//   the warp that write on every iteration some lane left);
// - the codes decode with shifts, masks and a division by the constant
//   65 (scode and hist hold integers below 2^24: pathtrace_hiz.py:441 of
//   the JAX package), the search budget is computed only where it can
//   decide the result, pk_hist is read once, for the hit, and a lane
//   with nothing to test reads no ray: ~270 SASS instructions a link;
// - slot and table reads go through the read-only data cache (__ldg);
// - the block count an SM is set from ptxas's registers: 12 in the
//   plain layout (40 registers, 48 warps an SM), 8 in dual mode (56).
// Issuing a round's loads before its tests (2 or 4 links at once, or the
// next link's slot during the current test) and compacting warps (a
// block queue of the lanes with links, refilled per warp) were slower.
// Every output bit equals the plain version's.
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

constexpr int THREADS = 128;

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

struct Args {
  const float* pk_cum;
  const float* pk_scode;
  const float* pk_hist;
  const int32_t* n_cand;
  const float* ray_pos;
  const float* ray_dir;
  const uint8_t* is_back;
  const uint32_t* table;
  const float* scalars;
  const float* state;  // null: the zero start
  float* out;
  int n, gh, gw, pairs_x, n_rounds, chain, s_max;
};

// A state row read as the plain version reads it: flags as > 0.5,
// integer rows truncated.
__device__ __forceinline__ float flag_row(float v) { return v > 0.5f ? 1.0f : 0.0f; }
__device__ __forceinline__ float int_row(float v) {
  return static_cast<float>(static_cast<int>(v));
}

// Blocks an SM, from ptxas's registers and the ablation: 12 in the
// plain layout (40 registers, 48 warps an SM), 8 in dual mode (56
// registers, 9 blocks fit).
template <bool DUAL>
__global__ void __launch_bounds__(THREADS, DUAL ? 8 : 12)
    resolve_rounds_kernel(Args a, DualArgs dual) {
  __shared__ float s_m[18];
  if (threadIdx.x < 18) s_m[threadIdx.x] = a.scalars[threadIdx.x];
  __syncthreads();
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= a.n) return;
  const size_t nn = static_cast<size_t>(a.n);
  const float* m = s_m;
  const float zz = s_m[16], zw = s_m[17];

  int ptr = 0, prev_sidx = -1;
  float prev_diff = 0.0f, prev_sd = 0.0f;
  bool hit = false;
  if (a.state != nullptr) {
    const float* st = a.state + lane;
    ptr = static_cast<int>(st[0]);
    hit = st[1 * nn] > 0.5f;
    prev_diff = st[10 * nn];
    prev_sidx = static_cast<int>(st[11 * nn]);
    if (DUAL) prev_sd = st[13 * nn];
  }
  const int nc = a.n_cand[lane];
  bool more = !hit && ptr < nc && a.n_rounds > 0 && a.chain > 0;
  // The ray, and in dual mode the lane's combo rows and search
  // capability, only for a lane with links to test.
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  bool backray = false, searchlane = false;
  size_t row_off = 0;
  if (more) {
    ox = a.ray_pos[3 * lane];
    oy = a.ray_pos[3 * lane + 1];
    oz = a.ray_pos[3 * lane + 2];
    dx = a.ray_dir[3 * lane];
    dy = a.ray_dir[3 * lane + 1];
    dz = a.ray_dir[3 * lane + 2];
    backray = a.is_back[lane] != 0;
    if (DUAL) {
      row_off = static_cast<size_t>(dual.combo[lane]) * dual.tiles_per_combo;
      searchlane = dual.search[lane] != 0;
    }
  }

  // The hit of this call, if any: its link's fields.
  bool found = false, h_back = false, h_search = false;
  float h_cum = 0.0f, h_diff = 0.0f, h_hitd = 0.0f, h_sd = 0.0f;
  int h_sc = 0, h_ixy = 0;
  // One link an iteration: the one at ptr, link j of round r; pair0 is
  // link 0's window.
  int r = 0, j = 0, pair0 = 0;
  while (more) {
    const size_t o = static_cast<size_t>(ptr) * nn + lane;
    const float cd = __ldg(a.pk_cum + o);
    const int sc = static_cast<int>(__ldg(a.pk_scode + o));
    const float px = ox + cd * dx, py = oy + cd * dy, pz = oz + cd * dz;
    const float cx = px * m[0] + py * m[1] + pz * m[2] + m[3];
    const float cy = px * m[4] + py * m[5] + pz * m[6] + m[7];
    const float cz = px * m[8] + py * m[9] + pz * m[10] + m[11];
    float w = px * m[12] + py * m[13] + pz * m[14] + m[15];
    if (fabsf(w) < 1e-12f) w = 1e-12f;
    const float u = cx / w * 0.5f + 0.5f;
    const float v = cy / w * 0.5f + 0.5f;
    const float hitd = 1.0f / (cz / w * zz + zw);
    const int ix = pixel_index(u, a.gw);
    const int iy = pixel_index(v, a.gh);
    // pairs_x is tiles_x in dual mode (single-tile rows).
    const int txi = ix >> 4;
    const int pair = (iy >> 3) * a.pairs_x + (DUAL ? txi : txi >> 1);
    if (j > 0 && pair != pair0) {
      // Outside link 0's window: link 0 of the next round.
      if (++r == a.n_rounds) break;
      j = 0;
    }
    if (j == 0) pair0 = pair;
    const int texel = (iy & 7) * 16 + (ix & 15);
    const float th = static_cast<float>(sc >> 13) * 0.025f;
    const int s_idx = (sc & 8191) % 65;
    float d, sd = 0.0f;
    bool hit_now, base_hit = false, back_hit_now = false;
    if (DUAL) {
      const uint32_t word = __ldg(a.table + (row_off + pair) * 128 + texel);
      const float step = __ldg(dual.pk_step + o) * 0.025f;
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
      const bool search_ok =
          searchlane || (dual.has_back && !backray && back_ok && (hitd <= scene_back));
      hit_now = !is_sky && base_hit;
      // The search budget only where it decides the result.
      if (!is_sky && !base_hit && search_ok && d <= 0.0f) {
        const float halvings = ceilf(log2f(fmaxf(-d / fmaxf(th, 1e-6f), 1.0f)));
        hit_now = static_cast<float>(s_idx + 1) + halvings <= static_cast<float>(a.s_max);
      }
      back_hit_now = hit_now && back_ok && (hitd > scene_back) && (sd >= 0.0f);
    } else {
      const uint32_t word = __ldg(a.table + static_cast<size_t>(pair) * 128 + texel);
      const float d_raw = half_bits_to_float((txi & 1) ? (word >> 16) : word);
      const float scene = 1.0f / (d_raw * zz + zw);
      const bool is_sky = d_raw == 0.0f;
      d = scene - hitd;
      hit_now = (d <= 0.0f) && (d >= -th) && !is_sky;
      if (!hit_now && backray && d <= 0.0f && !is_sky) {
        const float halvings = ceilf(log2f(fmaxf(-d / fmaxf(th, 1e-6f), 1.0f)));
        hit_now = static_cast<float>(s_idx + 1) + halvings <= static_cast<float>(a.s_max);
      }
    }
    if (hit_now) {
      found = true;
      h_cum = cd;
      h_diff = d;
      h_hitd = hitd;
      h_sc = sc;
      h_ixy = iy * a.gw + ix;
      h_sd = sd;
      h_back = back_hit_now;
      h_search = !base_hit;
      break;
    }
    prev_diff = d;
    prev_sidx = s_idx;
    prev_sd = sd;
    more = ++ptr < nc;
    if (more && ++j == a.chain) {
      j = 0;
      more = ++r < a.n_rounds;
    }
  }

  // Every lane's rows, written together: the hit's (pk_hist read for
  // it alone), or the rows as they came in.
  float* out = a.out + lane;
  if (a.state != nullptr) {
    out[0] = static_cast<float>(ptr);
    out += nn;
  }
  if (found) {
    const int hc = static_cast<int>(a.pk_hist[static_cast<size_t>(ptr) * nn + lane]);
    out[0] = 1.0f;
    out[1 * nn] = h_cum;
    out[2 * nn] = h_diff;
    out[3 * nn] = static_cast<float>(h_sc >> 13) * 0.025f;
    out[4 * nn] = h_hitd;
    out[5 * nn] = static_cast<float>(hc >> 12) * 0.025f;
    out[6 * nn] = static_cast<float>(hc & 4095) * 0.025f;
    out[7 * nn] = static_cast<float>((h_sc & 8191) / 65 - 1);
    out[8 * nn] = static_cast<float>(h_ixy);
    if (DUAL) {
      out[11 * nn] = h_sd;
      out[13 * nn] = h_back ? 1.0f : 0.0f;
      out[14 * nn] = h_search ? 1.0f : 0.0f;
    }
  } else if (a.state != nullptr) {
    const float* st = a.state + nn + lane;
    out[0] = flag_row(st[0]);
#pragma unroll
    for (int f = 1; f < 7; ++f) out[f * nn] = st[f * nn];
    out[7 * nn] = int_row(st[7 * nn]);
    out[8 * nn] = int_row(st[8 * nn]);
    if (DUAL) {
      out[11 * nn] = st[11 * nn];
      out[13 * nn] = flag_row(st[13 * nn]);
      out[14 * nn] = flag_row(st[14 * nn]);
    }
  } else {
#pragma unroll
    for (int f = 0; f < 9; ++f) out[f * nn] = 0.0f;
    if (DUAL) {
      out[11 * nn] = 0.0f;
      out[13 * nn] = 0.0f;
      out[14 * nn] = 0.0f;
    }
  }
  out[9 * nn] = prev_diff;
  out[10 * nn] = static_cast<float>(prev_sidx);
  if (DUAL) out[12 * nn] = prev_sd;
}

template <bool DUAL>
int launch(const Args& a, const DualArgs& dual, void* stream) {
  if (a.n > 0) {
    const int blocks = (a.n + THREADS - 1) / THREADS;
    resolve_rounds_kernel<DUAL><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        a, dual);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sspt_resolve_rounds(
    const void* pk_cum, const void* pk_scode, const void* pk_hist,
    const void* n_cand, const void* ray_pos, const void* ray_dir,
    const void* is_back, const void* pair_table, const void* scalars,
    const void* state, void* out, int n, int k, int gh, int gw, int pairs_x,
    int n_rounds, int chain, int s_max, void* stream) {
  (void)k;
  const Args a = {
      static_cast<const float*>(pk_cum), static_cast<const float*>(pk_scode),
      static_cast<const float*>(pk_hist), static_cast<const int32_t*>(n_cand),
      static_cast<const float*>(ray_pos), static_cast<const float*>(ray_dir),
      static_cast<const uint8_t*>(is_back), static_cast<const uint32_t*>(pair_table),
      static_cast<const float*>(scalars), static_cast<const float*>(state),
      static_cast<float*>(out), n, gh, gw, pairs_x, n_rounds, chain, s_max};
  const DualArgs none = {nullptr, nullptr, nullptr, 0, false};
  return launch<false>(a, none, stream);
}

extern "C" int sspt_resolve_rounds_dual(
    const void* pk_cum, const void* pk_scode, const void* pk_hist,
    const void* pk_step, const void* n_cand, const void* ray_pos,
    const void* ray_dir, const void* is_back, const void* combo,
    const void* search, const void* tile_table, const void* scalars,
    const void* state, void* out, int n, int k, int gh, int gw, int tiles_x,
    int tiles_per_combo, int n_rounds, int chain, int s_max, int has_back, void* stream) {
  (void)k;
  const Args a = {
      static_cast<const float*>(pk_cum), static_cast<const float*>(pk_scode),
      static_cast<const float*>(pk_hist), static_cast<const int32_t*>(n_cand),
      static_cast<const float*>(ray_pos), static_cast<const float*>(ray_dir),
      static_cast<const uint8_t*>(is_back), static_cast<const uint32_t*>(tile_table),
      static_cast<const float*>(scalars), static_cast<const float*>(state),
      static_cast<float*>(out), n, gh, gw, tiles_x, n_rounds, chain, s_max};
  const DualArgs dual = {
      static_cast<const float*>(pk_step), static_cast<const int32_t*>(combo),
      static_cast<const uint8_t*>(search), tiles_per_combo, has_back != 0};
  return launch<true>(a, dual, stream);
}
