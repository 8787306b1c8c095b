// S1: the draws of the per-pixel counter RNG, in each of its three modes.
//
// Replaces unitysspathtracingurp_tpu/ops/rng.py _blue_noise_sample
// (:118-154), _sobol_owen_sample (:238-252) and the hashed draw (draw
// :255-270 through hashed_random_float :55), which the JAX package
// writes in XLA as elementwise uint32 math over the pixel lanes. They are
// no Pallas kernel. In plain PyTorch they run in int64 with 32-bit masks
// (torch's uint32 lacks add and shifts on the CPU): a Sobol-Owen draw is
// ~250-350 small launches over every lane (two Jenkins keys, two Owen
// scrambles of five-round bit reversals and four multiply-xors each, 32
// conditional xors for the second Sobol component), a hashed draw ~34
// (three one-at-a-time hashes, the masks and the float construction),
// each moving ~16 B a lane. The plain version is ops/rng.py sampler_draws_ref.
//
// Per lane, for draws first .. first + COUNT - 1 of the counter (the
// counter, the frame index and every term of them alone are uniform over
// lanes: host scalars):
//   HASHED: jenkins3(pixel, frame_index + draw) with uint32 wrap-around,
//     its low 23 bits the mantissa of a float in [1, 2), minus 1 (exact).
//   SOBOL_OWEN: d = draw - 1, pair d >> 1, component d & 1; the frame
//     number k = (frame_index * 9697) mod 64000 index-shuffled by the
//     Owen scramble keyed by jenkins3(pixel, pair); component 0 the bit
//     reversal of that index, component 1 the XOR of the 32 direction
//     numbers of Sobol dimension 2 its set bits pick; the point
//     Owen-scrambled by jenkins3(pixel, d); its top 24 bits in [0, 1).
//     A draw2 is one pair (the wrapper rounds the counter up to even),
//     so its two draws share the index shuffle.
//   BLUE_NOISE: the pixel's cell (x & 127, y & 127, dim & 7) of the
//     ranking and scrambling tiles, the sequence value at (sample index
//     ^ ranking, dim), XOR the scrambling value, jittered by it, then the
//     epoch's Cranley-Patterson rotation modulo 1.
//
// What bounds it. Bytes: the two int64 pixel coordinates (16 B) read and
// 4 B a draw written a lane, plus the tables (1.25 MB, read once from
// device memory, then L2-resident), 18.4 MB for one draw at 1080p, 5.5 us
// at 3.35 TB/s. Instructions: a shift-add compiles to one LEA or IMAD, and
// IMADs issue on the FMA pipe beside the ALU pipe, so the bound counts the
// SASS by pipe (kernels/build.py sass_must_run): a Sobol-Owen draw2 is 251
// instructions a lane, 134 of them on the ALU pipe (64 lanes an SM a
// clock), 16.6 us at 1080p; a blue-noise draw2 is 104, below its bytes,
// and a hashed draw a few dozen. The Sobol-Owen draws are bound by the
// ALU pipe, the blue-noise and hashed ones by their bytes.
//
// The design: one thread a lane, 256 a block, COUNT draws a thread
// written as one float or one float2; 32-bit unsigned arithmetic with
// __brev for the bit reversals and the 32 direction numbers in
// __constant__ memory (every thread of a warp reads the same word). A
// Sobol-Owen instance is chosen by the parity of the first draw, which
// fixes each draw's component and a draw2's pairing: its code has no
// branch, and its SASS is what every lane runs. The tables are int32 read
// through __ldg; the hashed mode reads none. Each output bit equals
// sampler_draws_ref's (integer math is exact; the floats are exact
// conversions of values below 2^24, products and quotients by powers of
// two, one rounded add and x - floor(x), in the plain version's order;
// --fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLUE_NOISE = 0, SOBOL_OWEN = 1, HASHED = 2;

// Sobol dimension 2 (primitive polynomial x + 1: m_k = (m_{k-1} << 1) ^
// m_{k-1}, the Pascal matrix), m_j << (31 - j).
__constant__ uint32_t c_sobol2[32] = {
    0x80000000u, 0xC0000000u, 0xA0000000u, 0xF0000000u,
    0x88000000u, 0xCC000000u, 0xAA000000u, 0xFF000000u,
    0x80800000u, 0xC0C00000u, 0xA0A00000u, 0xF0F00000u,
    0x88880000u, 0xCCCC0000u, 0xAAAA0000u, 0xFFFF0000u,
    0x80008000u, 0xC000C000u, 0xA000A000u, 0xF000F000u,
    0x88008800u, 0xCC00CC00u, 0xAA00AA00u, 0xFF00FF00u,
    0x80808080u, 0xC0C0C0C0u, 0xA0A0A0A0u, 0xF0F0F0F0u,
    0x88888888u, 0xCCCCCCCCu, 0xAAAAAAAAu, 0xFFFFFFFFu,
};

// Bob Jenkins' one-at-a-time hash of a uint32.
__device__ __forceinline__ uint32_t jenkins(uint32_t x) {
  x += x << 10;
  x ^= x >> 6;
  x += x << 3;
  x ^= x >> 11;
  x += x << 15;
  return x;
}

__device__ __forceinline__ uint32_t jenkins3(uint32_t x, uint32_t y, uint32_t z) {
  return jenkins(x ^ jenkins(y ^ jenkins(z)));
}

// GenerateHashedRandomFloat(uint3(px, py, z)): 23 bits of the hash as the
// mantissa of a float in [1, 2), minus 1.
__device__ __forceinline__ float hashed(uint32_t px, uint32_t py, uint32_t z) {
  return __uint_as_float((jenkins3(px, py, z) & 0x007FFFFFu) | 0x3F800000u) - 1.0f;
}

// Laine-Karras hash (Burley 2020's constants).
__device__ __forceinline__ uint32_t laine_karras(uint32_t x, uint32_t seed) {
  x += seed;
  x ^= x * 0x6C50B47Cu;
  x ^= x * 0xB82F1E52u;
  x ^= x * 0xC7AFE638u;
  x ^= x * 0x8D22F6E6u;
  return x;
}

__device__ __forceinline__ uint32_t nested_uniform_scramble(uint32_t x, uint32_t seed) {
  return __brev(laine_karras(__brev(x), seed));
}

__device__ __forceinline__ uint32_t sobol_dim2(uint32_t n) {
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if ((n >> j) & 1u) v ^= c_sobol2[j];
  }
  return v;
}

__device__ __forceinline__ uint32_t frame_number(uint32_t frame_index) {
  return (frame_index * 9697u) % 64000u;
}

// Draw d's value from its pair's shuffled index n; COMP is d & 1.
template <int COMP>
__device__ __forceinline__ float sobol_owen(uint32_t px, uint32_t py, uint32_t n, uint32_t d) {
  const uint32_t vkey = jenkins3(px, py, d * 0x68BC21EBu + 0x02E5BE93u);
  const uint32_t point = COMP ? sobol_dim2(n) : __brev(n);
  const uint32_t v = nested_uniform_scramble(point, vkey);
  return static_cast<float>(v >> 8) * (1.0f / 16777216.0f);
}

// The epoch's rotation of draw ``seed``: 0 in the first 256 frames.
__device__ __forceinline__ float rotation(uint32_t frame_index, uint32_t seed) {
  const uint32_t epoch = frame_number(frame_index) >> 8;
  if (epoch == 0) return 0.0f;
  const uint32_t bits = (jenkins(epoch * 9173u + seed) & 0x007FFFFFu) | 0x3F800000u;
  return __uint_as_float(bits) - 1.0f;
}

__device__ __forceinline__ float blue_noise(uint32_t px, uint32_t py, uint32_t frame_index,
                                            uint32_t seed, const int* __restrict__ sobol,
                                            const int* __restrict__ ranking,
                                            const int* __restrict__ scrambling) {
  const uint32_t dim = seed & 255u;
  const uint32_t cell = ((px & 127u) + (py & 127u) * 128u) * 8u + (dim & 7u);
  const uint32_t ranked =
      (static_cast<uint32_t>(__ldg(ranking + cell)) ^ (frame_index & 255u)) & 255u;
  const uint32_t scr = static_cast<uint32_t>(__ldg(scrambling + cell));
  const uint32_t value = static_cast<uint32_t>(__ldg(sobol + ranked * 256u + dim)) ^ scr;
  const float scramble_f = fminf(static_cast<float>(scr) / 256.0f, 0.999f);
  const float u = (scramble_f + static_cast<float>(value & 255u)) / 256.0f;
  const float x = u + rotation(frame_index, seed);
  return x - floorf(x);
}

// FIRST_ODD is first & 1 (Sobol-Owen only; 0 in the other modes): it
// fixes each draw's component and whether a draw2's two draws share a
// pair at compile time, so the instance's code runs straight through.
template <int MODE, int COUNT, int FIRST_ODD>
__global__ void __launch_bounds__(THREADS)
    sampler_kernel(const int64_t* __restrict__ pix_x, const int64_t* __restrict__ pix_y,
                   const int* __restrict__ sobol, const int* __restrict__ ranking,
                   const int* __restrict__ scrambling, float* __restrict__ out, long long n,
                   uint32_t frame_index, uint32_t first) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n) return;
  const uint32_t px = static_cast<uint32_t>(__ldg(pix_x + i));
  const uint32_t py = static_cast<uint32_t>(__ldg(pix_y + i));
  float v[COUNT];
  if (MODE == SOBOL_OWEN) {
    const uint32_t k = frame_number(frame_index);
    uint32_t shuffled = 0;
#pragma unroll
    for (int c = 0; c < COUNT; ++c) {
      const uint32_t d = first + c - 1u;
      constexpr int comp0 = FIRST_ODD ? 0 : 1;  // (first - 1) & 1
      if (c == 0 || ((comp0 + c) & 1) == 0) {  // the first draw, or one that opens a pair
        shuffled = nested_uniform_scramble(k, jenkins3(px, py, (d >> 1) * 0x51633E2Du + 0xA511E9B3u));
      }
      v[c] = ((comp0 + c) & 1) ? sobol_owen<1>(px, py, shuffled, d)
                               : sobol_owen<0>(px, py, shuffled, d);
    }
  } else if (MODE == HASHED) {
#pragma unroll
    for (int c = 0; c < COUNT; ++c) {
      v[c] = hashed(px, py, frame_index + first + c);
    }
  } else {
#pragma unroll
    for (int c = 0; c < COUNT; ++c) {
      v[c] = blue_noise(px, py, frame_index, first + c, sobol, ranking, scrambling);
    }
  }
  if (COUNT == 1) {
    out[i] = v[0];
  } else {
    reinterpret_cast<float2*>(out)[i] = make_float2(v[0], v[COUNT - 1]);
  }
}

template <int MODE, int COUNT, int FIRST_ODD = 0>
void launch(const int64_t* px, const int64_t* py, const int* sobol, const int* ranking,
            const int* scrambling, float* out, long long n, uint32_t frame_index,
            uint32_t first, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  sampler_kernel<MODE, COUNT, FIRST_ODD><<<blocks, THREADS, 0, s>>>(
      px, py, sobol, ranking, scrambling, out, n, frame_index, first);
}

}  // namespace

// ``count`` (1 or 2) draws starting at counter value ``first`` for ``n``
// lanes in ``mode`` (0 blue noise, reading the three int32 tables; 1
// Sobol-Owen and 2 hashed, the tables may be null); ``out`` is (n,) or
// (n, 2) f32.
extern "C" int sspt_sampler(const void* pix_x, const void* pix_y, const void* sobol,
                            const void* ranking, const void* scrambling, void* out,
                            long long n, int mode, unsigned int frame_index,
                            unsigned int first, int count, void* stream) {
  const auto px = static_cast<const int64_t*>(pix_x), py = static_cast<const int64_t*>(pix_y);
  const auto sb = static_cast<const int*>(sobol), rk = static_cast<const int*>(ranking),
             sc = static_cast<const int*>(scrambling);
  const auto o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    const bool odd = first & 1u;
    if (mode == SOBOL_OWEN && count == 2) {
      (odd ? launch<SOBOL_OWEN, 2, 1> : launch<SOBOL_OWEN, 2, 0>)(px, py, sb, rk, sc, o, n,
                                                                  frame_index, first, s);
    } else if (mode == SOBOL_OWEN) {
      (odd ? launch<SOBOL_OWEN, 1, 1> : launch<SOBOL_OWEN, 1, 0>)(px, py, sb, rk, sc, o, n,
                                                                  frame_index, first, s);
    } else if (mode == HASHED) {
      (count == 2 ? launch<HASHED, 2> : launch<HASHED, 1>)(px, py, sb, rk, sc, o, n, frame_index,
                                                            first, s);
    } else if (count == 2) {
      launch<BLUE_NOISE, 2>(px, py, sb, rk, sc, o, n, frame_index, first, s);
    } else {
      launch<BLUE_NOISE, 1>(px, py, sb, rk, sc, o, n, frame_index, first, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
