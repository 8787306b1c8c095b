// The warp's copy of its 32 lanes' staged slot rows, shared by K1, K4,
// K6 (schedule_pack.cu) and K3 (pallas_gather.cu).
//
// A block stages its lanes' slots in shared memory laid out
// [field][K][blockDim] (field f, slot j of thread t at
// stage[(f * k + j) * blockDim + t]), each thread its own column, with
// its slots past its count zeroed. Thread t of the warp holds lane
// lane_base + t (K1, K3, K4: the block's first lane; K6, whose block
// spans screen rows, passes each warp's own base, lane - threadIdx.x).
// Lane L of the warp copies threads 4 (L % 8) .. 4 (L % 8) + 3 of rows
// j = L / 8, L / 8 + 4, ... of each field: one 16-byte shared load (8
// lanes read 128 contiguous bytes: no bank conflict) and one 16-byte
// store (8 lanes write 128 contiguous bytes of one row). Scalar stores
// where the row is not 16-byte aligned (n % 4 != 0) and past the last
// lane.

#pragma once

#include <cuda_runtime.h>

template <int NF>
__device__ __forceinline__ void write_rows(const float* stage, float* const* outs, int n,
                                           int k, int lane_base) {
  __syncwarp();  // the warp's lanes have staged every slot
  const int wl = threadIdx.x & 31;
  const int src = (threadIdx.x & ~31) + 4 * (wl & 7);
  const int t = blockDim.x;
  const int lane0 = lane_base + src;
  const bool vec = (n & 3) == 0 && lane0 + 3 < n;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    for (int j = wl >> 3; j < k; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(stage + (f * k + j) * t + src);
      float* dst = outs[f] + static_cast<size_t>(j) * n + lane0;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = v;
      } else {
        if (lane0 < n) dst[0] = v.x;
        if (lane0 + 1 < n) dst[1] = v.y;
        if (lane0 + 2 < n) dst[2] = v.z;
        if (lane0 + 3 < n) dst[3] = v.w;
      }
    }
  }
}
