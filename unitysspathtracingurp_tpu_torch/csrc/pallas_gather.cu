// K2, K3, K5 and K7: the unfused hiz march's selects.
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
// K5 (extract_chain_kernel) replaces pallas_gather.py extract_chain
// (:205, pallas_call :241): one resolve round's chain links, out[f][j, n]
// = fields[f][ptr[n] + j, n] for j < chain from 3 or 4 (K, N) f32 slot
// tables, 0 where ptr + j lies outside [0, slot_hi). Its plain version is
// extract_chain_ref. On the TPU each program streamed all slot_hi rows of
// every table into VMEM and picked the links with a compare/select tree.
// Here one thread per lane reads its ptr once and loads only the chain
// slots it needs: row s of a (K, N) table is contiguous over lanes, so a
// warp's loads of one link are coalesced. + 0.0f turns -0.0 into the
// masked sum's +0.0. Bound: bytes, ptr (4 B) plus chain x nf selected
// slots (4 B) read and chain x nf outputs (4 B) written: at the 1080p
// bounce-0 shape (N = 2,073,600, chain 4, 3 fields) ~0.2 GB, ~0.06 ms.
//
// K7 (rowwise_select_kernel) replaces pallas_gather.py rowwise_select
// (:105, pallas_call :127): values[r, k] = blocks[r, idx[r, k] & 127]
// from (N, 128) rows of 32-bit words (the depth-table rows a resolve
// round gathered per lane), moved as raw bits (f16-pair words may hold
// NaN payloads). Its plain version is rowwise_select_ref. On the TPU it
// was a dynamic gather across the lanes of each VMEM row; here one thread
// per (row, k) loads its one word, so a word costs one 32-B sector, not
// the row's 512 B. Bound: bytes, idx and out (4 B each) plus one sector
// per selected word: ~0.33 GB at N = 2,073,600, K = 4, ~0.1 ms.
//
// No tensor cores: none has a matrix product.

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

__global__ void extract_chain_kernel(const int32_t* __restrict__ ptr, Fields f, int n, int chain,
                                     int slot_hi, int nf) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const long long p = ptr[lane];
  for (int j = 0; j < chain; ++j) {
    const long long s = p + j;
    const bool ok = s >= 0 && s < slot_hi;
    const size_t o = static_cast<size_t>(ok ? s : 0) * n + lane;
    const size_t d = static_cast<size_t>(j) * n + lane;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q < nf) f.out[q][d] = ok ? f.in[q][o] + 0.0f : 0.0f;
    }
  }
}

__global__ void rowwise_select_kernel(const uint32_t* __restrict__ blocks,
                                      const int32_t* __restrict__ idx,
                                      uint32_t* __restrict__ out, long long total, int k) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long row = i / k;
  out[i] = blocks[row * 128 + (idx[i] & 127)];
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

// fields_in / fields_out: nf (3 or 4) pointers each, unused ones null.
extern "C" int sspt_extract_chain(const void* ptr, const void* in0, const void* in1,
                                  const void* in2, const void* in3, void* out0, void* out1,
                                  void* out2, void* out3, int n, int k, int chain, int slot_hi,
                                  int nf, void* stream) {
  if (n > 0 && chain > 0) {
    const Fields f = {
        {static_cast<const float*>(in0), static_cast<const float*>(in1),
         static_cast<const float*>(in2), static_cast<const float*>(in3)},
        {static_cast<float*>(out0), static_cast<float*>(out1), static_cast<float*>(out2),
         static_cast<float*>(out3)}};
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    extract_chain_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(ptr), f, n, chain, slot_hi < k ? slot_hi : k, nf);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sspt_rowwise_select(const void* blocks, const void* idx, void* out, int n, int k,
                                   void* stream) {
  const long long total = static_cast<long long>(n) * k;
  if (total > 0) {
    const int threads = 256;
    const long long grid = (total + threads - 1) / threads;
    rowwise_select_kernel<<<static_cast<unsigned>(grid), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(blocks), static_cast<const int32_t*>(idx),
        static_cast<uint32_t*>(out), total, k);
  }
  return static_cast<int>(cudaGetLastError());
}
