// P1: the parity ray march, RayMarching (PathTracing.hlsl:7-254).
//
// Replaces unitysspathtracingurp_tpu/ops/pathtrace.py ray_march
// (:79-333), which the JAX package writes in XLA as a masked fixed-trip
// loop: every lane of the (H, W) grid runs maximum_steps steps, and a
// lane that has hit or left the screen keeps its state under masks. The
// plain PyTorch version is ops/pathtrace.py ray_march_ref, that same
// masked loop in torch ops.
//
// Per lane and step i = 1..s_max: the tier transitions (small steps to
// i = max_small, medium to max_medium, then the far-tier large_step; a
// lane in its binary search keeps its step), the advance by
// step * (1 + dither) along the ray, the projection, the sub-texel skip
// (up to max_medium), the screen exit, the 1-3-layer depth fetch by
// layout and insideObject, the backface thickness rules, the binary
// search control, the hit rules, the lerp between the last and current
// position where the signed depth difference changed sign, and the
// growth of step and thickness while the lane does not search.
//
// The design. One thread a lane over flat N: the pixel grid or the
// compacted (cap_n / 128, 128) domain. The step loop leaves a lane as
// soon as it hits or leaves the screen (the HLSL's own break): an
// inactive lane's state never changes in the masked loop, so the exit
// gives the same bits. Each lane's layout choice is fixed by its
// insideObject for the whole march, so the loop reads the one or two
// depth images it needs through pointers chosen before it (__ldg: the
// images are read-only and stay in L2 at 1080p, 8.3 MB each). Settings
// go in a struct passed by value; the 18 camera scalars (view_proj and
// the linear-eye-depth coefficients) are read from the device array
// that K1 and R1 read (schedule_scalars) into shared memory once a
// block, as R1 does: passing them by value would need a device-to-host
// copy of the camera every march, and a __constant__ copy would share
// K1's one-stream hazard. Outputs are structure-of-arrays: (6, N) f32
// rows position x, y, z, distance, u, v and (2, N) bytes hit, back hit,
// written once per lane after the loop.
//
// Numerics: --fmad=false and IEEE divides and square roots, and every
// expression in the order of the plain version, so each output bit
// equals ray_march_ref's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr float REAL_EPS = 1.1920929e-07f;

struct Args {
  const float* ray_pos;     // (N, 3)
  const float* ray_dir;     // (N, 3)
  const float* view_dir;    // (N, 3)
  const float* inside;      // (N,) insideObject 0 / 1 / 2
  const float* dither;      // (N,)
  const float* large_step;  // (N,) the far-tier step
  const uint8_t* alive;     // (N,)
  const float* scalars;     // (18,) view_proj row-major, zz, zw
  const float* layer1;      // (gh, gw) raw depth images
  const float* opaque;      // null without refraction
  const float* back;        // null without back depth
  float* out;               // (6, N)
  uint8_t* flags;           // (2, N)
  int n, gh, gw, s_max, max_small, max_medium;
  float small_step, medium_step, thickness, th_inc, step_growth, texel_x, texel_y;
};

__device__ __forceinline__ int pixel_index(float t, int size) {
  const int i = static_cast<int>(floorf(t * static_cast<float>(size)));
  return min(max(i, 0), size - 1);
}

// camera.world_to_ndc: the planar expansion, left to right.
__device__ __forceinline__ void project(const float* m, float x, float y, float z, float& u,
                                        float& v, float& raw) {
  const float cx = x * m[0] + y * m[1] + z * m[2] + m[3];
  const float cy = x * m[4] + y * m[5] + z * m[6] + m[7];
  const float cz = x * m[8] + y * m[9] + z * m[10] + m[11];
  float w = x * m[12] + y * m[13] + z * m[14] + m[15];
  if (fabsf(w) < 1e-12f) w = 1e-12f;
  u = cx / w * 0.5f + 0.5f;
  v = cy / w * 0.5f + 0.5f;
  raw = cz / w;
}

// _fast_sign: -0.0 counts as positive.
__device__ __forceinline__ float fast_sign(float x) { return x >= 0.0f ? 1.0f : -1.0f; }

template <bool REFR, bool BACK>
__global__ void __launch_bounds__(THREADS) ray_march_kernel(Args a) {
  __shared__ float s_m[18];
  if (threadIdx.x < 18) s_m[threadIdx.x] = a.scalars[threadIdx.x];
  __syncthreads();
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= a.n) return;
  const float* m = s_m;
  const float zz = m[16], zw = m[17];

  bool hit = false, back_hit = false;
  float hx = 0.0f, hy = 0.0f, hz = 0.0f, hdist = REAL_EPS, hu = 0.0f, hv = 0.0f;
  if (a.alive[lane]) {
    const float px = a.ray_pos[3 * lane], py = a.ray_pos[3 * lane + 1],
                pz = a.ray_pos[3 * lane + 2];
    const float dx = a.ray_dir[3 * lane], dy = a.ray_dir[3 * lane + 1],
                dz = a.ray_dir[3 * lane + 2];
    const bool front = dx * a.view_dir[3 * lane] + dy * a.view_dir[3 * lane + 1]
                       + dz * a.view_dir[3 * lane + 2] <= 0.0f;
    const float inside = a.inside[lane];
    const float dither = a.dither[lane];
    const float large_step = a.large_step[lane];
    // The layer each step tests and its back layer (hlsl:79-98).
    const float* test_img = a.layer1;
    const float* back_img = a.back;
    if (REFR && BACK) {
      test_img = inside == 1.0f ? a.back : (inside == 2.0f ? a.opaque : a.layer1);
      back_img = inside == 1.0f ? a.opaque : a.back;
    } else if (REFR) {
      test_img = inside != 0.0f ? a.opaque : a.layer1;
    }

    float step = a.small_step, th = a.thickness;
    bool start_bin = false;
    float rx = px, ry = py, rz = pz;  // the march position
    float lx = px, ly = py, lz = pz;  // the last tested position
    float lu, lv, lraw;
    project(m, px, py, pz, lu, lv, lraw);
    float last_diff = 0.0f;
    for (int i = 1; i <= a.s_max; ++i) {
      if (i == a.max_small + 1) {
        if (!start_bin) step = a.medium_step;
        th = a.thickness;
      }
      if (i == a.max_medium + 1) {
        if (!start_bin) step = large_step;
        th = a.thickness;
      }
      const float adv = step + step * dither;
      rx = rx + adv * dx;
      ry = ry + adv * dy;
      rz = rz + adv * dz;
      float u, v, raw;
      project(m, rx, ry, rz, u, v, raw);
      if (i <= a.max_medium && fabsf(u - lu) < a.texel_x && fabsf(v - lv) < a.texel_y) {
        continue;  // sub-texel move: the step is consumed untested
      }
      if (!(u > 0.0f && u < 1.0f && v > 0.0f && v < 1.0f)) break;  // left the screen

      const size_t texel = static_cast<size_t>(pixel_index(v, a.gh)) * a.gw
                           + pixel_index(u, a.gw);
      const float device_depth = __ldg(test_img + texel);
      const float scene_depth = 1.0f / (device_depth * zz + zw);
      const float hit_depth = 1.0f / (raw * zz + zw);
      const float depth_diff = scene_depth - hit_depth;
      float scene_back = 0.0f, back_diff = 0.0f;
      bool back_valid = false;
      if (BACK) {
        const float device_back = __ldg(back_img + texel);
        scene_back = 1.0f / (device_back * zz + zw);
        back_valid = device_back != 0.0f && scene_back >= scene_depth;
        back_diff = back_valid ? hit_depth - scene_back : depth_diff - th;
      }
      const bool back_search = !front && hit_depth > scene_back && back_valid;
      const float sd = back_search ? back_diff : depth_diff;
      const float sgn = fast_sign(sd);
      const bool cannot_bin = inside != 2.0f && !start_bin
                              && (front ? hit_depth > scene_back : hit_depth < scene_depth);
      start_bin = !cannot_bin && (start_bin || sgn == -1.0f);
      if (start_bin) {
        const float halved = step * 0.5f;
        step = fast_sign(halved) == sgn ? halved : -halved;
      }
      const bool is_sky = device_depth == 0.0f;
      const bool hit_plain = depth_diff <= 0.0f && depth_diff >= -th && !is_sky;
      bool hit_ok = hit_plain;
      if (BACK && back_valid) {
        hit_ok = depth_diff <= 0.0f && hit_depth <= fmaxf(scene_back, scene_depth + step)
                 && !is_sky;
      }
      if (hit_ok) {
        float denom = last_diff - sd;
        if (fabsf(denom) < 1e-20f) denom = 1e-20f;
        const float t = last_diff / denom;
        if (sgn != fast_sign(last_diff)) {
          hx = lx + (rx - lx) * t;
          hy = ly + (ry - ly) * t;
          hz = lz + (rz - lz) * t;
        } else {
          hx = rx;
          hy = ry;
          hz = rz;
        }
        const float ex = rx - px, ey = ry - py, ez = rz - pz;
        hdist = sqrtf(ex * ex + ey * ey + ez * ez);
        hu = u;
        hv = v;
        back_hit = BACK && back_valid && hit_depth > scene_back && sgn > 0.0f;
        hit = true;
        break;
      }
      if (!start_bin) {
        step = step + step * a.step_growth;
        th = th + a.th_inc;
      }
      last_diff = sd;
      lx = rx;
      ly = ry;
      lz = rz;
      lu = u;
      lv = v;
    }
  }
  const size_t nn = static_cast<size_t>(a.n);
  a.out[lane] = hx;
  a.out[nn + lane] = hy;
  a.out[2 * nn + lane] = hz;
  a.out[3 * nn + lane] = hdist;
  a.out[4 * nn + lane] = hu;
  a.out[5 * nn + lane] = hv;
  a.flags[lane] = hit;
  a.flags[nn + lane] = back_hit;
}

template <bool REFR, bool BACK>
void launch(const Args& a, cudaStream_t stream) {
  const int blocks = (a.n + THREADS - 1) / THREADS;
  ray_march_kernel<REFR, BACK><<<blocks, THREADS, 0, stream>>>(a);
}

}  // namespace

extern "C" int sspt_ray_march(
    const void* ray_pos, const void* ray_dir, const void* view_dir, const void* inside,
    const void* dither, const void* large_step, const void* alive, const void* scalars,
    const void* layer1, const void* opaque, const void* back, void* out, void* flags,
    int n, int gh, int gw, int s_max, int max_small, int max_medium, float small_step,
    float medium_step, float thickness, float th_inc, float step_growth, float texel_x,
    float texel_y, void* stream) {
  const Args a = {
      static_cast<const float*>(ray_pos), static_cast<const float*>(ray_dir),
      static_cast<const float*>(view_dir), static_cast<const float*>(inside),
      static_cast<const float*>(dither), static_cast<const float*>(large_step),
      static_cast<const uint8_t*>(alive), static_cast<const float*>(scalars),
      static_cast<const float*>(layer1), static_cast<const float*>(opaque),
      static_cast<const float*>(back), static_cast<float*>(out),
      static_cast<uint8_t*>(flags), n, gh, gw, s_max, max_small, max_medium,
      small_step, medium_step, thickness, th_inc, step_growth, texel_x, texel_y};
  if (n > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool refr = opaque != nullptr, bk = back != nullptr;
    if (refr && bk) {
      launch<true, true>(a, s);
    } else if (refr) {
      launch<true, false>(a, s);
    } else if (bk) {
      launch<false, true>(a, s);
    } else {
      launch<false, false>(a, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
