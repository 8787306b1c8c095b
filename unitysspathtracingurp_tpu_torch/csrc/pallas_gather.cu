// K2 and K3: the unfused hiz front half's table select and candidate pack.
//
// K2 (broadcast_table_select_kernel) replaces
// unitysspathtracingurp_tpu/ops/pallas_gather.py broadcast_table_select
// (:65, pallas_call :90): values[i] = table_flat[idx[i]] from a small
// shared table of 32-bit words (the minitile min|max f16 pairs, or the
// dual bmax table), 0 for an index outside the table. Its plain PyTorch
// version is ops/pallas_gather.py broadcast_table_select_ref. On the TPU
// the select ran as chunked take_along_axis over sublane-broadcast rows.
// Here the table (16 KB plain, 48 KB dual at 1080p) is staged once per
// block into shared memory and each thread selects one index at a time,
// over a grid of a few blocks per SM that strides the indices, so the
// table is read from device memory a few hundred times, not once per
// 256 indices. Bound: bytes, each index read once (4 B) and each value
// written once (4 B): at the 1080p bounce-0 shape (24 x 2,073,600
// indices) 0.4 GB, ~0.12 ms.
//
// K3 (pack_by_slot_kernel) replaces pallas_gather.py pack_by_slot (:141,
// pallas_call :188): from (S, N) candidate flags and 3 or 4 (S, N) f32
// fields, per lane the field values of its first K candidate steps as
// rows of (K, N) tables, zeros past the lane's count, and the count
// clamped to K. Its plain version is pack_by_slot_ref. On the TPU it was
// a manual prefix sum over the step rows and K masked sums; here one
// thread per lane keeps the running count in a register over the S rows
// (each row read coalesced, lane-major) and stores slot j to row j. Each
// slot holds exactly one field value, so a store reproduces the masked
// sum, with + 0.0f turning -0.0 into the sum's +0.0. Bound: bytes, the
// (S, N) flags (1 B) and fields (4 B each) read once and the (K, N)
// tables plus the count written once: ~1.3 GB at 1080p with 3 fields,
// ~0.4 ms.
//
// No tensor cores: neither has a matrix product.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void broadcast_table_select_kernel(const uint32_t* __restrict__ table,
                                              const int32_t* __restrict__ idx,
                                              uint32_t* __restrict__ out, int n_words,
                                              long long n) {
  extern __shared__ uint32_t s_table[];
  for (int i = threadIdx.x; i < n_words; i += blockDim.x) s_table[i] = table[i];
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int e = idx[i];
    out[i] = (e >= 0 && e < n_words) ? s_table[e] : 0u;
  }
}

struct Fields {
  const float* in[4];
  float* out[4];
};

__global__ void pack_by_slot_kernel(const uint8_t* __restrict__ cand, Fields f,
                                    int32_t* __restrict__ count, int s, int n, int k, int nf) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  int run = 0;
  for (int r = 0; r < s; ++r) {
    const size_t o = static_cast<size_t>(r) * n + lane;
    if (cand[o] == 0) continue;
    if (run < k) {
      const size_t d = static_cast<size_t>(run) * n + lane;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q < nf) f.out[q][d] = f.in[q][o] + 0.0f;
      }
    }
    ++run;
  }
  for (int j = run; j < k; ++j) {
    const size_t d = static_cast<size_t>(j) * n + lane;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q < nf) f.out[q][d] = 0.0f;
    }
  }
  count[lane] = min(run, k);
}

}  // namespace

extern "C" int sspt_broadcast_table_select(const void* table, const void* idx, void* out,
                                           int n_words, long long n, void* stream) {
  const size_t smem = static_cast<size_t>(n_words) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(broadcast_table_select_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (n > 0) {
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const int threads = 512;
    const long long need = (n + threads - 1) / threads;
    const int blocks = static_cast<int>(need < 4LL * sms ? need : 4LL * sms);
    broadcast_table_select_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(table), static_cast<const int32_t*>(idx),
        static_cast<uint32_t*>(out), n_words, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// fields_in / fields_out: nf (3 or 4) pointers each, unused ones null.
extern "C" int sspt_pack_by_slot(const void* cand, const void* in0, const void* in1,
                                 const void* in2, const void* in3, void* out0, void* out1,
                                 void* out2, void* out3, void* count, int s, int n, int k,
                                 int nf, void* stream) {
  if (n > 0) {
    const Fields f = {
        {static_cast<const float*>(in0), static_cast<const float*>(in1),
         static_cast<const float*>(in2), static_cast<const float*>(in3)},
        {static_cast<float*>(out0), static_cast<float*>(out1), static_cast<float*>(out2),
         static_cast<float*>(out3)}};
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    pack_by_slot_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(cand), f, static_cast<int32_t*>(count), s, n, k, nf);
  }
  return static_cast<int>(cudaGetLastError());
}
