#!/usr/bin/env python3
"""Ablation of kernel A1 (``csrc/atrous.cu``, one À-Trous iteration) on one
NVIDIA GPU: where its time goes, and whether a shared-memory design that
reads each texel once beats it.

    python3 scripts/atrous_ablation.py [--parent DIR] [--out FILE]   # repository root, a GPU

Writes patched copies of ``atrous.cu`` (``COPIES``: each a list of exact
text replacements, each of which must match once; a compiled pattern
matches a whole section) into ``build/atrous_ablation/``, builds them, one
``nvcc`` per copy, all started together, and prints each copy's
registers, spills and SASS instructions (``-Xptxas -v``, ``cuobjdump
-sass``) and the dynamic shared memory of its block shape. With
``--parent DIR`` (an unpacked earlier tree, e.g. ``git archive`` of the
parent commit) that tree's own ``atrous.cu`` is built too, as "parent".
Then, through the port's own wrapper ``ops.atrous.atrous_filter``, it
times each copy with ``chip_smoke.cuda_ms`` (20 launches, twice, in
forward and reverse order) and holds the exact copies' output against
``atrous_filter_ref`` bit for bit, on:

- the phase-3 inputs of ``chip_smoke.py`` at 1920x1080
  (``chip_smoke.rt_inputs``: the classroom with a noisy color, counts
  0 / 1 / 5 / 8 / 9 and 1/16 of the rows sky, with row_offset 0 and 17;
  the glass box with refraction);
- cell (h)'s own inputs: the three ``atrous_filter`` calls of a 1080p
  SPATIAL_TEMPORAL frame (``chip_smoke.realtime_renderer``), caught by
  wrapping ``models.renderer.atrous_filter``, in the frame after one
  warm-up frame, in the seventh (the last frame phase 5 times) and in
  the twelfth, each frame's three times summed as "A1 a frame".

It also times the shipped T1 (``ops.temporal.temporal_reproject``; time
only) on the own inputs of those (h) frames and of a (g) frame.

The split of the shipped design (one thread a pixel, a global read a
tap; timing only, outputs not held): ``tap-center`` (each tap reads the
texel k - 4 columns from its pixel in the pixel's own row: coalesced,
and distinct per tap so that the compiler cannot merge the loads; the
scattered-read term), ``sqrt-center`` (the taps' square roots replaced
by the center's sqrt-albedo plus 0 x the tap's albedo, so the loads
stay; the sqrt term) and ``fast-exp`` (``__expf`` for ``expf``; the exp
term). ``min6`` asks ptxas for 6 blocks an SM (exact).

The shared-memory designs, each spliced in place of the shipped kernel
(exact unless named otherwise):

- ``tile-*``: a block of BX x BY pixels first fills a shared tile of its
  pixels and a 9-px halo, each texel's color, emission, normal and
  sqrt-albedo as channel planes (``cp.async`` copies of 4 bytes, then
  the square root and the refraction select in place), then reads its
  taps from the tile: ``tile-32x8``, ``tile-32x16``, ``tile-64x16`` (1
  pixel a thread), ``tile-32x16-2px`` (2), ``tile-32x16-no-filter``
  (timing only: every pixel copies its color from the tile, the fill
  alone);
- ``ring*``: a block walks down a strip of 32 columns in steps of 8
  rows over 64 rows, through a ring of rows in shared memory (a step's
  window and the next step's rows, fetched by ``cp.async`` while the
  step filters), so each texel crosses from L2 ~2.0 times a pixel
  instead of the tile's 3.3: ``ring``, ``ring-no-ahead`` (the ring holds
  the step's window alone and the next rows are fetched between two
  barriers; 3 blocks an SM instead of 2), ``ring-step14-seg56``, and
  timing only ``ring-tap-center`` (each tap reads the ring word k - 4
  from its pixel's: no scattered shared reads), ``ring-no-load`` (the
  fill stores values made from the texel index: no device reads) and
  ``ring-no-filter`` (the fill alone).

Each input set prints its filtered share and, for each block shape, the
share of blocks whose pixels all pass through, the bound of
``chip_smoke.a1_bound`` and each copy's time and share of it. Writes
every number to ``--out`` (default
``build/atrous_ablation/atrous_ablation.json``). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from unitysspathtracingurp_tpu_torch.config import PTConfig  # noqa: E402
from unitysspathtracingurp_tpu_torch.kernels import build  # noqa: E402
from unitysspathtracingurp_tpu_torch.models import renderer  # noqa: E402
from unitysspathtracingurp_tpu_torch.ops import atrous, temporal  # noqa: E402

OUT_DIR = ROOT / "build" / "atrous_ablation"
ENTRY = "sspt_atrous"

# The shipped file (one thread a pixel, a global read a tap): the split.
TAP_CENTER = [("    const int q = qy * a.w + qx;\n",
               "    const int q = y * a.w + min(max(x + k - 4, 0), a.w - 1) + 0 * (qy + qx);\n")]
SQRT_CENTER = [(f"sqrtf(clamp_min(ta[{c}], 0.0f))", f"(sa[{c}] + 0.0f * ta[{c}])")
               for c in range(3)]
FAST_EXP = [("#include <stdint.h>\n", "#include <stdint.h>\n#define expf(x) __expf(x)\n")]
BOUNDS = "__global__ void __launch_bounds__(BX * BY) atrous_kernel(Args a) {\n"
MIN6 = [(BOUNDS, BOUNDS.replace("(BX * BY)", "(BX * BY, 6)"))]

# The shared-memory designs replace the shipped file's block constants,
# its kernel and the launch in its entry point (the header, Args, the
# clamps, the hash and the entry's arguments stay).
CONSTS = "constexpr int BX = 32, BY = 8;\nconstexpr int SURFACE_TYPE_REFRACTION = 2;\n"
KERNEL = re.compile(r"template <bool REFR>\n__global__ void __launch_bounds__\(BX \* BY\) "
                    r"atrous_kernel\(Args a\) \{\n.*?\n\}\n\n\}  // namespace\n", re.S)
LAUNCH = re.compile(r"  if \(h > 0 && w > 0\) \{\n.*?\n  \}\n"
                    r"  return static_cast<int>\(cudaGetLastError\(\)\);\n", re.S)
SPLICED_LAUNCH = ("  if (h <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());\n"
                  "  const cudaStream_t s = static_cast<cudaStream_t>(stream);\n"
                  "  return refr ? launch<true>(a, s) : launch<false>(a, s);\n")
TILE_CONSTS = r'''constexpr int BX = 32, BY = 16, PY = 1;
constexpr int HALO = 9;
constexpr int TW = BX + 2 * HALO, TH = BY + 2 * HALO;
// Words a plane takes: the tile, padded to 11 (mod 32).
constexpr int PLANE = TW * TH + (11 - TW * TH % 32 + 32) % 32;
constexpr int THREADS = BX * BY / PY;
// Planes: color, emission, normal, sqrt-albedo, 3 channels each.
constexpr int COLOR = 0, EMISSION = 3, NORMAL = 6, SQRT_ALBEDO = 9;
constexpr size_t SMEM_BYTES = 12 * PLANE * sizeof(float);
constexpr int SURFACE_TYPE_REFRACTION = 2;
static_assert(BX % 32 == 0 && BY % PY == 0, "a warp is 32 pixels of one row");
'''
TILE_KERNEL = r'''// Channel c of texel q of the transparent layer t where that texel is
// refractive and the layer there is non-zero, else v.
__device__ __forceinline__ float transparent_or(const float* t, int q, int c, float v) {
  const float t0 = __ldg(t + 3 * q), t1 = __ldg(t + 3 * q + 1), t2 = __ldg(t + 3 * q + 2);
  return t0 != 0.0f || t1 != 0.0f || t2 != 0.0f ? (c == 0 ? t0 : c == 1 ? t1 : t2) : v;
}

// A 4-byte copy from device to shared memory that does not wait (cp.async).
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(d), "l"(src));
}

// The block's tile: every float of the (TH, TW) texels' color, emission,
// normal and albedo copied, one float a thread in turn, consecutive
// threads on consecutive floats of a tile row; then each thread takes the
// refraction select and the albedo's square root of the floats it copied.
template <bool REFR>
__device__ __forceinline__ void fill_tile(const Args& a, float* tile, int x0, int y0) {
  for (int e = threadIdx.x; e < TH * TW * 3; e += THREADS) {
    const int i = e / (3 * TW);
    const int f = e - i * (3 * TW);
    const int j = f / 3, c = f - 3 * j;
    const int gx = min(max(x0 - HALO + j, 0), a.w - 1);
    const int gy = min(max(y0 - HALO + i, 0), a.h - 1);
    const int q = gy * a.w + gx;
    const int s = i * TW + j;
    copy4(tile + (COLOR + c) * PLANE + s, a.color + 3 * q + c);
    copy4(tile + (EMISSION + c) * PLANE + s, a.emission + 3 * q + c);
    copy4(tile + (NORMAL + c) * PLANE + s, a.normal + 3 * q + c);
    copy4(tile + (SQRT_ALBEDO + c) * PLANE + s, a.albedo + 3 * q + c);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  for (int e = threadIdx.x; e < TH * TW * 3; e += THREADS) {
    const int i = e / (3 * TW);
    const int f = e - i * (3 * TW);
    const int j = f / 3, c = f - 3 * j;
    const int gx = min(max(x0 - HALO + j, 0), a.w - 1);
    const int gy = min(max(y0 - HALO + i, 0), a.h - 1);
    const int q = gy * a.w + gx;
    const int s = i * TW + j;
    float n = tile[(NORMAL + c) * PLANE + s], al = tile[(SQRT_ALBEDO + c) * PLANE + s];
    if (REFR && __ldg(a.t_type + q) == SURFACE_TYPE_REFRACTION) {
      n = transparent_or(a.t_normal, q, c, n);
      al = transparent_or(a.t_albedo, q, c, al);
    }
    tile[(NORMAL + c) * PLANE + s] = n;
    tile[(SQRT_ALBEDO + c) * PLANE + s] = sqrtf(clamp_min(al, 0.0f));
  }
}

// Plane k's value at tile texel s.
__device__ __forceinline__ float at(const float* tile, int k, int s) { return tile[k * PLANE + s]; }

// Pixel (x, y) at tile texel s0, filtered from the tile with the remapped
// blur gate.
template <bool REFR>
__device__ __forceinline__ void filter_pixel(const Args& a, const float* tile, int x, int y,
                                             int x0, int y0, int s0, float remapped) {
  const int p = y * a.w + x;
  const float c[3] = {at(tile, COLOR, s0), at(tile, COLOR + 1, s0), at(tile, COLOR + 2, s0)};
  const float cn[3] = {at(tile, NORMAL, s0), at(tile, NORMAL + 1, s0), at(tile, NORMAL + 2, s0)};
  const float sa[3] = {at(tile, SQRT_ALBEDO, s0), at(tile, SQRT_ALBEDO + 1, s0),
                       at(tile, SQRT_ALBEDO + 2, s0)};
  float ce[3] = {at(tile, EMISSION, s0), at(tile, EMISSION + 1, s0), at(tile, EMISSION + 2, s0)};
  const bool use_ew = !REFR || __ldg(a.t_type + p) != SURFACE_TYPE_REFRACTION;
  if (!use_ew) ce[0] = ce[1] = ce[2] = 0.0f;
  const uint32_t hy = static_cast<uint32_t>(y) + static_cast<uint32_t>(a.row_offset);
  const int r = static_cast<int>(floorf(3.0f + 6.0f * hashed_random_float(x, hy, 1u)));

  float sum0 = 0.0f, sum1 = 0.0f, sum2 = 0.0f, sw = 0.0f;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int dx = k % 3 - 1, dy = k / 3 - 1;
    const int qx = min(max(x + dx * r, 0), a.w - 1);
    const int qy = min(max(y + dy * r, 0), a.h - 1);
    const int s = (qy - y0 + HALO) * TW + (qx - x0 + HALO);
    const float tc[3] = {at(tile, COLOR, s), at(tile, COLOR + 1, s), at(tile, COLOR + 2, s)};
    const float te[3] = {at(tile, EMISSION, s), at(tile, EMISSION + 1, s),
                         at(tile, EMISSION + 2, s)};
    const float tn[3] = {at(tile, NORMAL, s), at(tile, NORMAL + 1, s), at(tile, NORMAL + 2, s)};
    const float ta[3] = {at(tile, SQRT_ALBEDO, s), at(tile, SQRT_ALBEDO + 1, s),
                         at(tile, SQRT_ALBEDO + 2, s)};
    const float cw = clamp_max(expf(-sum_sq(c[0] - tc[0], c[1] - tc[1], c[2] - tc[2]) * 1.1f), 1.0f);
    float ew = clamp_max(
        expf(-sum_sq(ce[0] - te[0], ce[1] - te[1], ce[2] - te[2]) * 2000.0f), 1.0f);
    if (!use_ew) ew = 1.0f;
    const float nw = clamp_max(
        expf(-clamp_min(sum_sq(cn[0] - tn[0], cn[1] - tn[1], cn[2] - tn[2]), 0.0f) * 20.0f),
        1.0f);
    const float aw = clamp_max(
        expf(-sum_sq(sa[0] - ta[0], sa[1] - ta[1], sa[2] - ta[2]) * 400.0f), 1.0f);
    const float wt = cw * ew * nw * aw * tap_weight(k);
    sum0 = sum0 + tc[0] * wt;
    sum1 = sum1 + tc[1] * wt;
    sum2 = sum2 + tc[2] * wt;
    sw = sw + wt;
  }
  const float den = clamp_min(sw, 1e-12f);
  float* o = a.out + 3 * static_cast<size_t>(p);
  o[0] = c[0] + (sum0 / den - c[0]) * remapped;
  o[1] = c[1] + (sum1 / den - c[1]) * remapped;
  o[2] = c[2] + (sum2 / den - c[2]) * remapped;
}

template <bool REFR>
__global__ void __launch_bounds__(THREADS) atrous_kernel(Args a) {
  extern __shared__ float tile[];
  const int x0 = blockIdx.x * BX, y0 = blockIdx.y * BY;
  const int lx = threadIdx.x % BX, ly = threadIdx.x / BX;
  const int x = x0 + lx;
  // Per pixel of the thread: 0 out of the image, 1 passes through, 2 filters.
  int state[PY];
  float remapped[PY];
  bool any = false;
#pragma unroll
  for (int k = 0; k < PY; ++k) {
    const int y = y0 + ly + k * (BY / PY);
    state[k] = 0;
    remapped[k] = 0.0f;
    if (x < a.w && y < a.h) {
      const int p = y * a.w + x;
      const float ratio = __ldg(a.count + p) / a.max_n;
      const float blur = 1.0f - saturate(clamp_max(ratio, a.max_n) - a.inv_n);
      state[k] = __ldg(a.depth + p) == 0.0f || blur == 0.0f ? 1 : 2;
      float inv = 1.0f - blur;
      inv = inv * inv;
      inv = inv * inv;
      remapped[k] = 1.0f - inv;
      any = any || state[k] == 2;
    }
  }
  const bool fill = __syncthreads_or(any);
  if (fill) {
    fill_tile<REFR>(a, tile, x0, y0);
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < PY; ++k) {
    const int y = y0 + ly + k * (BY / PY);
    const int s0 = (ly + k * (BY / PY) + HALO) * TW + lx + HALO;
    if (state[k] == 2) {
      filter_pixel<REFR>(a, tile, x, y, x0, y0, s0, remapped[k]);
    } else if (state[k] == 1) {
      const size_t p = static_cast<size_t>(y) * a.w + x;
      float* o = a.out + 3 * p;
      if (fill) {
        o[0] = at(tile, COLOR, s0);
        o[1] = at(tile, COLOR + 1, s0);
        o[2] = at(tile, COLOR + 2, s0);
      } else {
        o[0] = __ldg(a.color + 3 * p);
        o[1] = __ldg(a.color + 3 * p + 1);
        o[2] = __ldg(a.color + 3 * p + 2);
      }
    }
  }
}

template <bool REFR>
int launch(const Args& a, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      atrous_kernel<REFR>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.w + BX - 1) / BX, (a.h + BY - 1) / BY);
  atrous_kernel<REFR><<<grid, THREADS, SMEM_BYTES, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
'''
RING_CONSTS = r'''constexpr int BX = 32, STEP = 8, SEG = 64;
constexpr int HALO = 9;
constexpr int TW = BX + 2 * HALO;
// Ring rows: a step's window (its STEP rows and the halo above and
// below) and the next step's AHEAD = STEP new rows.
constexpr int AHEAD = STEP;
constexpr int RING = STEP + 2 * HALO + AHEAD;
constexpr int PLANE = RING * TW;  // words a plane takes
constexpr int THREADS = BX * STEP;
// Planes: color, emission, normal, sqrt-albedo, 3 channels each.
constexpr int COLOR = 0, EMISSION = 3, NORMAL = 6, SQRT_ALBEDO = 9;
constexpr size_t SMEM_BYTES = 12 * PLANE * sizeof(float);
constexpr int SURFACE_TYPE_REFRACTION = 2;
static_assert(BX % 32 == 0 && SEG % STEP == 0, "a warp is 32 pixels of one row");
'''
RING_KERNEL = r'''// A 4-byte copy from device to shared memory that does not wait (cp.async).
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// The ring slot of virtual row v (image row clamp(v, 0, h - 1)) of the
// block whose first row is ys; v >= ys - HALO.
__device__ __forceinline__ int slot(int v, int ys) { return (v - ys + HALO) % RING; }

// The fill of `rows` virtual rows from v0 into the ring: warp i takes
// rows i, i + STEP, ..., each lane the texels lane and lane + 32 of a row
// (its 12 floats, one cp.async each, 32 consecutive words of a plane a
// warp). FINISH waits for the copies the thread issued and takes the
// square root (and the REFR select) of the texels it copied.
template <bool REFR, bool FINISH>
__device__ __forceinline__ void fill_rows(const Args& a, float* ring, int x0, int ys, int v0,
                                          int rows) {
  if (FINISH) asm volatile("cp.async.wait_all;\n" ::: "memory");
  for (int i = threadIdx.x / 32; i < rows; i += STEP) {
    const int gy = min(max(v0 + i, 0), a.h - 1);
    float* row = ring + slot(v0 + i, ys) * TW;
    for (int j = threadIdx.x % 32; j < TW; j += 32) {
      const int q = gy * a.w + min(max(x0 - HALO + j, 0), a.w - 1);
      float* t = row + j;
      if (!FINISH) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          copy4(t + (COLOR + c) * PLANE, a.color + 3 * q + c);
          copy4(t + (EMISSION + c) * PLANE, a.emission + 3 * q + c);
          copy4(t + (NORMAL + c) * PLANE, a.normal + 3 * q + c);
          copy4(t + (SQRT_ALBEDO + c) * PLANE, a.albedo + 3 * q + c);
        }
      } else {
        float al[3] = {t[SQRT_ALBEDO * PLANE], t[(SQRT_ALBEDO + 1) * PLANE],
                       t[(SQRT_ALBEDO + 2) * PLANE]};
        if (REFR && __ldg(a.t_type + q) == SURFACE_TYPE_REFRACTION) {
          const float* tn = a.t_normal + 3 * q;
          const float* ta = a.t_albedo + 3 * q;
          if (__ldg(tn) != 0.0f || __ldg(tn + 1) != 0.0f || __ldg(tn + 2) != 0.0f) {
            for (int c = 0; c < 3; ++c) t[(NORMAL + c) * PLANE] = __ldg(tn + c);
          }
          if (__ldg(ta) != 0.0f || __ldg(ta + 1) != 0.0f || __ldg(ta + 2) != 0.0f) {
            for (int c = 0; c < 3; ++c) al[c] = __ldg(ta + c);
          }
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) t[(SQRT_ALBEDO + c) * PLANE] = sqrtf(clamp_min(al[c], 0.0f));
      }
    }
  }
}

// Plane k's value at ring word s.
__device__ __forceinline__ float at(const float* ring, int k, int s) { return ring[k * PLANE + s]; }

// Pixel (x, y), whose ring word is s0, filtered from the ring of the
// block at (x0, ys) with the remapped blur gate.
template <bool REFR>
__device__ __forceinline__ void filter_pixel(const Args& a, const float* ring, int x, int y,
                                             int x0, int ys, int s0, float remapped) {
  const int p = y * a.w + x;
  const float c[3] = {at(ring, COLOR, s0), at(ring, COLOR + 1, s0), at(ring, COLOR + 2, s0)};
  const float cn[3] = {at(ring, NORMAL, s0), at(ring, NORMAL + 1, s0), at(ring, NORMAL + 2, s0)};
  const float sa[3] = {at(ring, SQRT_ALBEDO, s0), at(ring, SQRT_ALBEDO + 1, s0),
                       at(ring, SQRT_ALBEDO + 2, s0)};
  float ce[3] = {at(ring, EMISSION, s0), at(ring, EMISSION + 1, s0), at(ring, EMISSION + 2, s0)};
  const bool use_ew = !REFR || __ldg(a.t_type + p) != SURFACE_TYPE_REFRACTION;
  if (!use_ew) ce[0] = ce[1] = ce[2] = 0.0f;
  const uint32_t hy = static_cast<uint32_t>(y) + static_cast<uint32_t>(a.row_offset);
  const int r = static_cast<int>(floorf(3.0f + 6.0f * hashed_random_float(x, hy, 1u)));

  float sum0 = 0.0f, sum1 = 0.0f, sum2 = 0.0f, sw = 0.0f;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int dx = k % 3 - 1, dy = k / 3 - 1;
    const int qx = min(max(x + dx * r, 0), a.w - 1);
    const int qy = min(max(y + dy * r, 0), a.h - 1);
    const int s = slot(qy, ys) * TW + (qx - x0 + HALO);
    const float tc[3] = {at(ring, COLOR, s), at(ring, COLOR + 1, s), at(ring, COLOR + 2, s)};
    const float te[3] = {at(ring, EMISSION, s), at(ring, EMISSION + 1, s),
                         at(ring, EMISSION + 2, s)};
    const float tn[3] = {at(ring, NORMAL, s), at(ring, NORMAL + 1, s), at(ring, NORMAL + 2, s)};
    const float ta[3] = {at(ring, SQRT_ALBEDO, s), at(ring, SQRT_ALBEDO + 1, s),
                         at(ring, SQRT_ALBEDO + 2, s)};
    const float cw = clamp_max(expf(-sum_sq(c[0] - tc[0], c[1] - tc[1], c[2] - tc[2]) * 1.1f), 1.0f);
    float ew = clamp_max(
        expf(-sum_sq(ce[0] - te[0], ce[1] - te[1], ce[2] - te[2]) * 2000.0f), 1.0f);
    if (!use_ew) ew = 1.0f;
    const float nw = clamp_max(
        expf(-clamp_min(sum_sq(cn[0] - tn[0], cn[1] - tn[1], cn[2] - tn[2]), 0.0f) * 20.0f),
        1.0f);
    const float aw = clamp_max(
        expf(-sum_sq(sa[0] - ta[0], sa[1] - ta[1], sa[2] - ta[2]) * 400.0f), 1.0f);
    const float wt = cw * ew * nw * aw * tap_weight(k);
    sum0 = sum0 + tc[0] * wt;
    sum1 = sum1 + tc[1] * wt;
    sum2 = sum2 + tc[2] * wt;
    sw = sw + wt;
  }
  const float den = clamp_min(sw, 1e-12f);
  float* o = a.out + 3 * static_cast<size_t>(p);
  o[0] = c[0] + (sum0 / den - c[0]) * remapped;
  o[1] = c[1] + (sum1 / den - c[1]) * remapped;
  o[2] = c[2] + (sum2 / den - c[2]) * remapped;
}

// Pixel p's blur gate: 1 passes through (sky or blur 0), 2 filters; its
// remapped gate in *remapped.
__device__ __forceinline__ int pixel_state(const Args& a, int p, float* remapped) {
  const float ratio = __ldg(a.count + p) / a.max_n;
  const float blur = 1.0f - saturate(clamp_max(ratio, a.max_n) - a.inv_n);
  float inv = 1.0f - blur;
  inv = inv * inv;
  inv = inv * inv;
  *remapped = 1.0f - inv;
  return __ldg(a.depth + p) == 0.0f || blur == 0.0f ? 1 : 2;
}

template <bool REFR>
__global__ void __launch_bounds__(THREADS) atrous_kernel(Args a) {
  extern __shared__ float ring[];
  const int x0 = blockIdx.x * BX, ys = blockIdx.y * SEG;
  const int lx = threadIdx.x % BX, ly = threadIdx.x / BX;
  const int x = x0 + lx;
  const int steps = min(SEG, a.h - ys + STEP - 1) / STEP;
  bool any = false;
  for (int k = 0; k < steps; ++k) {
    const int y = ys + k * STEP + ly;
    float remapped;
    any = any || (x < a.w && y < a.h && pixel_state(a, y * a.w + x, &remapped) == 2);
  }
  if (!__syncthreads_or(any)) {
    for (int k = 0; k < steps; ++k) {
      const size_t p = static_cast<size_t>(ys + k * STEP + ly) * a.w + x;
      if (x < a.w && ys + k * STEP + ly < a.h) {
        a.out[3 * p] = __ldg(a.color + 3 * p);
        a.out[3 * p + 1] = __ldg(a.color + 3 * p + 1);
        a.out[3 * p + 2] = __ldg(a.color + 3 * p + 2);
      }
    }
    return;
  }
  // Step 0's window: virtual rows ys - HALO .. ys + STEP + HALO - 1.
  fill_rows<REFR, false>(a, ring, x0, ys, ys - HALO, STEP + 2 * HALO);
  fill_rows<REFR, true>(a, ring, x0, ys, ys - HALO, STEP + 2 * HALO);
  __syncthreads();
  for (int k = 0; k < steps; ++k) {
    // The next step's new rows go to the slots of the rows this step no
    // longer reads, while this step filters.
    const int next = ys + (k + 1) * STEP + HALO;
    if (k + 1 < steps) fill_rows<REFR, false>(a, ring, x0, ys, next, STEP);
    const int y = ys + k * STEP + ly;
    if (x < a.w && y < a.h) {
      const int p = y * a.w + x;
      const int s0 = slot(y, ys) * TW + lx + HALO;
      float remapped;
      if (pixel_state(a, p, &remapped) == 2) {
        filter_pixel<REFR>(a, ring, x, y, x0, ys, s0, remapped);
      } else {
        float* o = a.out + 3 * static_cast<size_t>(p);
        o[0] = at(ring, COLOR, s0);
        o[1] = at(ring, COLOR + 1, s0);
        o[2] = at(ring, COLOR + 2, s0);
      }
    }
    if (k + 1 < steps) fill_rows<REFR, true>(a, ring, x0, ys, next, STEP);
    __syncthreads();
  }
}

template <bool REFR>
int launch(const Args& a, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      atrous_kernel<REFR>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.w + BX - 1) / BX, (a.h + SEG - 1) / SEG);
  atrous_kernel<REFR><<<grid, THREADS, SMEM_BYTES, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
'''


def design(consts: str, kernel: str) -> list:
    """The patches that splice a design into the shipped file."""
    return [(CONSTS, consts), (KERNEL, kernel + "}  // namespace\n"),
            (LAUNCH, SPLICED_LAUNCH)]


TILE_SHAPE = re.compile(r"constexpr int BX = (\d+), BY = (\d+), PY = (\d+);\n")
RING_SHAPE = re.compile(r"constexpr int BX = (\d+), STEP = (\d+), SEG = (\d+);\n")
RING_AHEAD = re.compile(r"constexpr int AHEAD = (\w+);\n")


def tile(bx: int, by: int, py: int = 1) -> list:
    return design(TILE_CONSTS, TILE_KERNEL) + [
        (TILE_SHAPE, f"constexpr int BX = {bx}, BY = {by}, PY = {py};\n")]


TILE_NO_FILTER = [("    if (state[k] == 2) {\n", "    if (state[k] == 2 && false) {\n"),
                  ("    } else if (state[k] == 1) {\n", "    } else if (state[k] != 0) {\n")]
RING = design(RING_CONSTS, RING_KERNEL)
FETCH_NEXT = "    if (k + 1 < steps) fill_rows<REFR, false>(a, ring, x0, ys, next, STEP);\n"
WAIT_NEXT = "    if (k + 1 < steps) fill_rows<REFR, true>(a, ring, x0, ys, next, STEP);\n"
RING_NO_AHEAD = [("constexpr int AHEAD = STEP;\n", "constexpr int AHEAD = 0;\n"),
                 (FETCH_NEXT, ""),
                 (WAIT_NEXT + "    __syncthreads();\n",
                  "    __syncthreads();\n    if (k + 1 < steps) {\n  " + FETCH_NEXT + "  "
                  + WAIT_NEXT + "      __syncthreads();\n    }\n")]
RING_TAP = [("    const int s = slot(qy, ys) * TW + (qx - x0 + HALO);\n",
             "    const int s = s0 + k - 4 + 0 * (qy + qx);\n")]
RING_COPIES = ("          copy4(t + (COLOR + c) * PLANE, a.color + 3 * q + c);\n"
               "          copy4(t + (EMISSION + c) * PLANE, a.emission + 3 * q + c);\n"
               "          copy4(t + (NORMAL + c) * PLANE, a.normal + 3 * q + c);\n"
               "          copy4(t + (SQRT_ALBEDO + c) * PLANE, a.albedo + 3 * q + c);\n")
RING_NO_LOAD = [(RING_COPIES,
                 "          t[(COLOR + c) * PLANE] = 0.125f * c + 1e-9f * q;\n"
                 "          t[(EMISSION + c) * PLANE] = 1e-9f * q;\n"
                 "          t[(NORMAL + c) * PLANE] = 0.5f + 1e-8f * q;\n"
                 "          t[(SQRT_ALBEDO + c) * PLANE] = 0.25f + 1e-8f * c;\n")]
RING_NO_FILTER = [("      if (pixel_state(a, p, &remapped) == 2) {\n",
                   "      if (pixel_state(a, p, &remapped) == 2 && false) {\n")]


class Copy(NamedTuple):
    """A copy of atrous.cu: its replacements, the file they patch
    ("library": the shipped one; "parent": ``--parent``'s), and whether
    its output is held bit for bit ("exact") or not ("timing")."""

    patches: list
    base: str = "library"
    outputs: str = "exact"


COPIES = {
    "library": Copy([]),
    "parent": Copy([], base="parent"),
    "tap-center": Copy(TAP_CENTER, outputs="timing"),
    "sqrt-center": Copy(SQRT_CENTER, outputs="timing"),
    "fast-exp": Copy(FAST_EXP, outputs="timing"),
    "min6": Copy(MIN6),
    "tile-32x8": Copy(tile(32, 8)),
    "tile-32x16": Copy(tile(32, 16)),
    "tile-64x16": Copy(tile(64, 16)),
    "tile-32x16-2px": Copy(tile(32, 16, 2)),
    "tile-32x16-no-filter": Copy(tile(32, 16) + TILE_NO_FILTER, outputs="timing"),
    "ring": Copy(RING),
    "ring-no-ahead": Copy(RING + RING_NO_AHEAD),
    "ring-step14-seg56": Copy(RING + [(RING_SHAPE, "constexpr int BX = 32, STEP = 14, SEG = 56;\n")]),
    "ring-tap-center": Copy(RING + RING_TAP, outputs="timing"),
    "ring-no-load": Copy(RING + RING_NO_LOAD, outputs="timing"),
    "ring-no-filter": Copy(RING + RING_NO_FILTER, outputs="timing"),
}
BLOCKS = ((32, 8), (32, 16), (64, 16), (32, 64))


def patched(src: str, patches: list) -> str:
    """``src`` with each (old, new) replacement applied in turn; each old
    text (a string or a compiled pattern) must occur exactly once."""
    for old, new in patches:
        pattern = old if isinstance(old, re.Pattern) else re.compile(re.escape(old))
        found = len(pattern.findall(src))
        if found != 1:
            raise RuntimeError(f"anchor found {found} times: {pattern.pattern[:80]!r}")
        src = pattern.sub(lambda _: new, src)
    return src


def shared_of(src: str) -> dict:
    """The block, threads and dynamic shared bytes of a tile or ring copy
    (as its source computes them), and the blocks an SM holds by shared
    memory (228 KB, 1 KB reserved a block); {} for one with no tile."""
    if m := TILE_SHAPE.search(src):
        bx, by, py = map(int, m.groups())
        words = (bx + 18) * (by + 18)
        smem = 12 * 4 * (words + (11 - words % 32 + 32) % 32)
        out = dict(block=f"{bx}x{by}", threads=bx * by // py)
    elif m := RING_SHAPE.search(src):
        bx, step, seg = map(int, m.groups())
        ahead = RING_AHEAD.search(src).group(1)
        smem = 12 * 4 * (bx + 18) * (step + 18 + (step if ahead == "STEP" else int(ahead)))
        out = dict(block=f"{bx}x{seg} in steps of {step}", threads=bx * step)
    else:
        return {}
    return dict(out, smem=smem, blocks_by_smem=233472 // (smem + 1024))


def file_name(copy: str) -> str:
    return re.sub(r"[^\w-]", "_", copy)


def build_copies(parent: Path | None) -> dict:
    """{copy: (library, ptxas rows with each kernel's SASS instructions,
    ``shared_of`` its source)}, all nvcc processes at once. A copy that
    does not apply or fails to build is reported and left out."""
    nvcc = build.nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    bases = {"library": build.SRC_DIR / "atrous.cu"}
    if parent is not None:
        bases["parent"] = parent / "unitysspathtracingurp_tpu_torch" / "csrc" / "atrous.cu"
    procs = {}
    for name, copy in COPIES.items():
        if copy.base not in bases:
            continue
        path = OUT_DIR / f"{file_name(name)}.cu"
        try:
            src = patched(bases[copy.base].read_text(), copy.patches)
        except RuntimeError as e:
            print(f"copy {name} left out: {e}")
            continue
        path.write_text(src)
        so = OUT_DIR / f"{file_name(name)}.so"
        procs[name] = (so, shared_of(src), subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(so), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, shared, p) in procs.items():
        out = p.communicate()[0]
        if p.returncode != 0:
            print(f"nvcc failed for copy {name}, left out:\n{out}")
            continue
        lib = ctypes.CDLL(str(so))
        getattr(lib, ENTRY).argtypes = build._SIGNATURES[ENTRY]
        getattr(lib, ENTRY).restype = ctypes.c_int
        rows = build.parse_ptxas(out)
        sass = build.sass_loops(so)
        for r in rows:
            r["sass"] = sass.get(r["kernel"], {}).get("instructions")
        libs[name] = (lib, rows, shared)
    return libs


@contextlib.contextmanager
def use(lib):
    """The wrapper launches ``lib``'s kernel."""
    real = build.load_library
    build.load_library = lambda: lib
    try:
        yield
    finally:
        build.load_library = real


def filtered_mask(args):
    """(H, W) bool: the pixels A1 filters (not sky, blur not 0)."""
    color, gb, _, counts, cfg = args[:5]
    return (gb.layer1_depth() != 0.0) & (atrous.blur_amount(counts, cfg) != 0.0)


def pass_through_blocks(mask, bx: int, by: int) -> float:
    """The share of bx x by blocks in which no pixel filters."""
    h, w = mask.shape
    hb, wb = -(-h // by), -(-w // bx)
    padded = torch.zeros(hb * by, wb * bx, dtype=torch.bool, device=mask.device)
    padded[:h, :w] = mask
    return 1.0 - padded.reshape(hb, by, wb, bx).any(dim=3).any(dim=1).float().mean().item()


def run_set(label, args, kw, libs, results):
    """Time and check every copy on one input set: ``atrous_filter(*args,
    **kw)``."""
    refr = kw.get("support_refraction", False) and args[1].t_surface_type is not None
    ref = atrous.atrous_filter_ref(*args, **kw)
    mask = filtered_mask(args)
    b = cs.a1_bound(args[1], args[3], args[4], refr)
    row = dict(label=label, filtered=mask.float().mean().item(), refr=refr,
               pass_through_blocks={f"{bx}x{by}": pass_through_blocks(mask, bx, by)
                                    for bx, by in BLOCKS}, runs={}, **b)
    fns = {}
    for name, copy in COPIES.items():
        if name not in libs:
            continue

        def fn(lib=libs[name][0]):
            with use(lib):
                return atrous.atrous_filter(*args, **kw)

        got = fn()
        torch.cuda.synchronize()
        row["runs"][name] = dict(equal=cs.bits_equal(got, ref) if copy.outputs == "exact"
                                 else None)
        fns[name] = fn
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            row["runs"][name].setdefault("ms_each", []).append(cs.cuda_ms(fns[name], 20))
    print(f"ablation A1 {label}: filtered {row['filtered']:.4f}, blocks passing through "
          + ", ".join(f"{k} {v:.4f}" for k, v in row["pass_through_blocks"].items())
          + f"; bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    for name, r in row["runs"].items():
        r["ms"] = sum(r["ms_each"]) / 2
        print(f"  {name:20s} {r['ms']:.4f} ms ({r['ms_each'][0]:.4f} / {r['ms_each'][1]:.4f}), "
              f"{b['bound_ms'] / r['ms']:.3f} of bound, equal "
              f"{'n/a' if r['equal'] is None else r['equal']}")
    results.append(row)
    return row


@contextlib.contextmanager
def caught(name: str, calls: list):
    """Record each call of ``models.renderer.<name>`` (and make it)."""
    real = getattr(renderer, name)

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    setattr(renderer, name, spy)
    try:
        yield
    finally:
        setattr(renderer, name, real)


def frame_calls(path: str, dev, frames: tuple, h=cs.H_FULL, w=cs.W_FULL):
    """{frame: (A1 calls, T1 calls)} of the given frames (0 the warm-up)
    of a real-time path rendered from a fresh Renderer."""
    cycle = cs.realtime_frames(path, h, w, dev)
    r = cs.realtime_renderer(path, h, w, dev)
    out = {}
    for i in range(max(frames) + 1):
        gb, cam = cycle[i % len(cycle)]
        a_calls, t_calls = [], []
        with caught("atrous_filter", a_calls), caught("temporal_reproject", t_calls):
            r.render_frame(gb, cam)
        if i in frames:
            out[i] = (a_calls, t_calls)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="a checkout of an earlier tree: also time its atrous.cu")
    parser.add_argument("--out", type=Path, default=OUT_DIR / "atrous_ablation.json",
                        help="where the JSON of every number goes")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("atrous_ablation: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = build_copies(opts.parent)
    print(f"built {len(libs)} copies of atrous.cu in {time.perf_counter() - t0:.1f} s")
    for name, (_, rows, shared) in libs.items():
        print(f"ptxas {name}: " + "; ".join(
            f"{r['kernel']} {r['regs']} regs, {r['smem']} B static smem, spills "
            f"{r['spill_stores']}/{r['spill_loads']} B, {r['sass']} SASS instructions"
            for r in rows)
            + (f"; block {shared['block']}, "
               f"{shared['threads']} threads, {shared['smem']} B dynamic smem, "
               f"{shared['blocks_by_smem']} blocks an SM by shared memory" if shared else ""))

    results = []
    cfg = PTConfig()
    for label, glass, row_offset in (("classroom 1080p, row_offset 0", False, 0),
                                     ("classroom 1080p, row_offset 17", False, 17),
                                     ("glass box 1080p, refraction", True, 0)):
        gb, _, color, state = cs.rt_inputs(cs.H_FULL, cs.W_FULL, dev, torch.float32, glass)
        run_set(label, (color, gb, gb.emission, state.history_sample, cfg),
                dict(support_refraction=glass, row_offset=row_offset), libs, results)

    frames, t1 = {}, []
    for path, which in (("spatial_temporal", (1, 7, 12)), ("realtime", (1,))):
        for i, (a_calls, t_calls) in frame_calls(path, dev, which).items():
            name = f"({'h' if path == 'spatial_temporal' else 'g'}) frame {i}"
            sets = [run_set(f"{name} iteration {k}", a, kw, libs, results)
                    for k, (a, kw) in enumerate(a_calls)]
            if sets:
                frames[name] = {n: sum(r["runs"][n]["ms"] for r in sets) for n in sets[0]["runs"]}
                frames[name]["bound"] = sum(r["bound_ms"] for r in sets)
                print(f"A1 a frame, {name}: {len(sets)} iterations summed: " + ", ".join(
                    f"{n} {ms:.4f} ms" for n, ms in frames[name].items()))
            for a, kw in t_calls:
                ms = cs.cuda_ms(lambda: temporal.temporal_reproject(*a, **kw), 20)
                b = cs.t1_bound(a[1], a[3], kw.get("support_refraction", False))
                t1.append(dict(label=name, ms=ms, **b))
                print(f"T1 on {name}'s own inputs: {ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
                      f"(share {b['bound_ms'] / ms:.3f})")

    ok = all(r["equal"] is not False for row in results for r in row["runs"].values())
    out = opts.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(
        card=card, ptxas={k: v[1] for k, v in libs.items()},
        shared={k: v[2] for k, v in libs.items()}, sets=results, frames=frames, t1=t1),
        indent=1))
    print(f"every exact copy equal to the plain version: {ok}")
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
