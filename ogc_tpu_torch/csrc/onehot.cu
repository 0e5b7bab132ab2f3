// Small-source row gather and its deterministic scatter-add on Hopper: the
// grouping of clouds of at most 1024 points with at most 16 channels.
//
// Replaces the Pallas TPU kernels ogc_tpu/ops/pallas_onehot.py::
// _gather_kernel (#7, via gather_rows_onehot) and ::_scatter_kernel (#8, via
// scatter_add_rows_onehot).  On the TPU both are one-hot matrix products on
// the MXU (the one-hot built in VMEM by an iota compare); that was the TPU's
// way to avoid its slow random-row gather, not the contract.  The contract:
//
//   gather   out[b, e, :] = src[b, idx[b, e], :]                 (bit-equal)
//   scatter  out[b, r, :] = sum over e with idx[b, e] == r of cot[b, e, :],
//            in ascending e, f32, from 0.0f, each add __fadd_rn
//
// The scatter order is the port's scatter contract (ops/scatter.py, kernel
// #11), so this kernel is bit-equal to scatter_add_rows_plain and
// ops.group gives the same bits whichever route it takes.
//
// Gather design: a cloud's source is at most 64 KiB and the whole batch's
// at most a few MiB, so it stays in L2 (50 MB) and, for the rows a block
// reaches, in L1: nothing is staged.  One block of 8 warps per (cloud, run
// of 256 to 4096 edges, about 8 blocks per SM).  It reads the run's indices
// once, 16 bytes at a time, into shared memory (clamped), then copies rows
// with C fixed at compile time (a template over 1..16, so f / C is a
// multiply): ogc::copy_rows (gather_rows.cuh) loads consecutive channels on
// consecutive lanes and writes the contiguous output with 16-byte
// streaming stores, word by word only at a ragged head and tail.  Bound on
// the H100: bytes (src + idx read once, out written once, 4-50 MB at
// SAPIEN's shapes), and at the smallest calls the launch and the host's
// enqueue.  The launcher sets no attribute: 20 KiB of static shared memory.
//
// Scatter design: a stable partition of each cloud's edges by destination
// in shared memory, then a sum per (row, channel) in ascending e.  One block
// of 16 warps per (cloud, window of `rows` destinations), `rows` from
// ops/onehot.py::onehot_scatter_plan (128 at SAPIEN's B = 32, n = 512,
// C = 8: 4 windows a cloud, 128 blocks, one per SM).  The block takes the
// cloud's edges in tiles of kTile: it reads each index once (int32 or int64,
// as the caller holds it) into a 16-bit window offset (-1 outside the
// window), partitions the tile stably by it (ogc::stable_partition,
// csr.cuh: per-warp 16-bit histograms with one writer per counter, a scan,
// a rank among the earlier lanes of an equal-destination group; no atomics,
// no sort) into a list of 16-bit edge offsets, and then each thread adds the
// cotangent rows of its (row, channel) pairs' segments in list order, 8
// loads ahead (ogc::sum_segments), the sums carried in registers from tile
// to tile.  So each cotangent row is read once in all, from L2, by the
// threads of its own destination, and the result is bit-equal to the plain
// version whatever the window.  (Staging the listed rows in shared memory
// first, as #10 does, was slower at SAPIEN's in-degrees of 8 to 16.)
// Bound on the H100: bytes (idx, cot and out once each; the windows of a
// cloud read its indices again from L2), and at SAPIEN's calls the latency
// of the three passes over a tile.

#include <cuda_runtime.h>
#include <stdint.h>

#include "csr.cuh"
#include "gather_rows.cuh"

namespace {

constexpr int kMaxN = 1024;
constexpr int kMaxC = 16;
constexpr int kGatherThreads = 256;
constexpr int kGatherWarps = kGatherThreads / 32;
constexpr int kScatterThreads = 512;
constexpr int kScatterWarps = kScatterThreads / 32;
constexpr int kTile = 8192;    // edges a scatter block partitions at a time
constexpr int kMaxPairs = 4;   // (row, channel) sums a scatter thread keeps
constexpr int kSumAhead = 8;   // cotangent values loaded before adding
// Gather blocks: about 8 per SM of the card's 132, each 256 to 4096 edges.
constexpr int kTargetBlocks = 1056;
constexpr int kMinEdges = 256;
constexpr int kMaxEdges = 4096;

// Stage the clamped indices src[0, n) into dst (shared memory): 16-byte
// loads once src is 16-byte aligned, word loads for the ragged ends.
__device__ __forceinline__ void stage_rows(int32_t* __restrict__ dst,
                                           const int32_t* __restrict__ src,
                                           int n, int N) {
  int head = (int)((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) >> 2;
  head = head < n ? head : n;
  const int n4 = (n - head) >> 2;
  const int4* s4 = reinterpret_cast<const int4*>(src + head);
  for (int t = threadIdx.x; t < n4; t += blockDim.x) {
    const int4 v = __ldcs(s4 + t);
    int32_t* d = dst + head + 4 * t;
    d[0] = min(max(v.x, 0), N - 1);
    d[1] = min(max(v.y, 0), N - 1);
    d[2] = min(max(v.z, 0), N - 1);
    d[3] = min(max(v.w, 0), N - 1);
  }
  const int body_end = head + 4 * n4;
  for (int t = threadIdx.x; t < head + n - body_end; t += blockDim.x) {
    const int f = t < head ? t : body_end + t - head;
    dst[f] = min(max(__ldcs(src + f), 0), N - 1);
  }
}

template <int C>
__global__ void __launch_bounds__(kGatherThreads)
    gather_rows_kernel(const uint32_t* __restrict__ src,
                       const int32_t* __restrict__ idx, int N, int E,
                       int epb, uint32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t s_buf[kGatherWarps * ogc::kWarpWords];
  __shared__ int32_t s_rows[kMaxEdges];
  const int b = blockIdx.y;
  const int e0 = blockIdx.x * epb;
  const int n = min(E, e0 + epb) - e0;
  // Indices are in [0, N) by contract; the clamp keeps a bad one in bounds
  // (the JAX gather clips the same way).
  stage_rows(s_rows, idx + (int64_t)b * E + e0, n, N);
  __syncthreads();
  ogc::copy_rows<C>(out + ((int64_t)b * E + e0) * C, src + (int64_t)b * N * C,
                    s_rows, n, s_buf + (threadIdx.x >> 5) * ogc::kWarpWords);
}

// Dynamic shared memory of a scatter block for windows of `rows`.
__host__ __device__ constexpr int scatter_smem(int rows) {
  return kTile * 4 + kScatterWarps * ((rows + 1) & ~1) * 2 +
         (rows + 1 + kScatterWarps) * 4;
}

template <typename Idx>
__global__ void __launch_bounds__(kScatterThreads)
    scatter_rows_kernel(const Idx* __restrict__ idx,
                        const float* __restrict__ cot, int E, int C, int n,
                        int rows, float* __restrict__ out) {
  extern __shared__ uint4 smem_s[];
  const int ws = (rows + 1) & ~1;
  int16_t* s_d = reinterpret_cast<int16_t*>(smem_s);  // kTile offsets or -1
  uint16_t* s_order = reinterpret_cast<uint16_t*>(s_d + kTile);  // kTile
  uint16_t* hist = s_order + kTile;  // kScatterWarps x ws
  int32_t* s_start = reinterpret_cast<int32_t*>(hist + kScatterWarps * ws);
  int32_t* s_wsum = s_start + rows + 1;  // kScatterWarps
  const int b = blockIdx.y;
  const int w0 = blockIdx.x * rows;
  const int wn = min(rows, n - w0);
  const Idx* ib = idx + (int64_t)b * E;
  float acc[kMaxPairs];
#pragma unroll
  for (int k = 0; k < kMaxPairs; ++k) acc[k] = 0.0f;
  for (int e0 = 0; e0 < E; e0 += kTile) {
    const int len = min(kTile, E - e0);
    __syncthreads();  // the previous tile's sums have read s_order
#pragma unroll 4
    for (int t = threadIdx.x; t < len; t += kScatterThreads) {
      const Idx v = ib[e0 + t];
      s_d[t] = v >= (Idx)w0 && v < (Idx)(w0 + wn) ? (int16_t)(v - (Idx)w0)
                                                   : (int16_t)-1;
    }
    __syncthreads();
    ogc::stable_partition<kScatterWarps>(
        len, wn, [&](int t) { return (int)s_d[t]; }, hist, ws, s_start,
        s_wsum, [&](int pos, int t) { s_order[pos] = (uint16_t)t; });
    ogc::sum_segments<kMaxPairs, kSumAhead>(
        acc, wn * C, C, s_start, [&](int s) { return e0 + s_order[s]; },
        cot + (int64_t)b * E * C);
  }
  float* o = out + ((int64_t)b * n + w0) * C;
#pragma unroll
  for (int k = 0; k < kMaxPairs; ++k) {
    const int p = threadIdx.x + k * kScatterThreads;
    if (p < wn * C) o[p] = acc[k];
  }
}

}  // namespace

// src (B, N, C) f32, idx (B, E) int32 in [0, N); out (B, E, C) f32.
// Requires 1 <= N <= 1024, 1 <= C <= 16, E >= 1.  Launches on `stream` and
// returns the CUDA error (0 on success).
extern "C" int ogc_gather_rows_onehot(const void* src, const void* idx, int B,
                                      int N, int C, int E, void* out,
                                      void* stream) {
  if (B < 1 || N < 1 || N > kMaxN || C < 1 || C > kMaxC || E < 1) {
    return (int)cudaErrorInvalidValue;
  }
  // Edges per block: a multiple of 128 from kMinEdges to kMaxEdges, so that
  // the grid covers the card about kTargetBlocks / 132 times.
  int64_t epb = ((int64_t)B * E + kTargetBlocks - 1) / kTargetBlocks;
  epb = (epb + 127) / 128 * 128;
  epb = epb < kMinEdges ? kMinEdges : (epb > kMaxEdges ? kMaxEdges : epb);
  const dim3 grid((E + epb - 1) / epb, B);
  const uint32_t* s = (const uint32_t*)src;
  const int32_t* i = (const int32_t*)idx;
  uint32_t* o = (uint32_t*)out;
  int e = (int)epb;
  void* args[] = {&s, &i, &N, &E, &e, &o};
  // cudaLaunchKernel returns the launch's own error: no second call.
  switch (C) {
#define OGC_GATHER_CASE(c)                                                 \
  case c:                                                                  \
    return (int)cudaLaunchKernel((const void*)gather_rows_kernel<c>, grid, \
                                 dim3(kGatherThreads), args, 0,            \
                                 (cudaStream_t)stream);
    OGC_GATHER_CASE(1) OGC_GATHER_CASE(2) OGC_GATHER_CASE(3)
    OGC_GATHER_CASE(4) OGC_GATHER_CASE(5) OGC_GATHER_CASE(6)
    OGC_GATHER_CASE(7) OGC_GATHER_CASE(8) OGC_GATHER_CASE(9)
    OGC_GATHER_CASE(10) OGC_GATHER_CASE(11) OGC_GATHER_CASE(12)
    OGC_GATHER_CASE(13) OGC_GATHER_CASE(14) OGC_GATHER_CASE(15)
    OGC_GATHER_CASE(16)
#undef OGC_GATHER_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// idx (B, E) int32 (int64 if idx64), cot (B, E, C) f32; out (B, n, C) f32,
// every row written (rows no edge addresses are 0).  `rows` destinations a
// block (ops/onehot.py::onehot_scatter_plan).  Requires 1 <= n <= 1024,
// 1 <= C <= 16, 1 <= rows <= n, rows * C <= 2048, E >= 0, B <= 65535.
extern "C" int ogc_scatter_add_rows_onehot(const void* idx, int idx64,
                                           const void* cot, int B, int E,
                                           int C, int n, int rows, void* out,
                                           void* stream) {
  if (B < 1 || B > 65535 || n < 1 || n > kMaxN || C < 1 || C > kMaxC ||
      E < 0 || rows < 1 || rows > n ||
      rows * C > kMaxPairs * kScatterThreads) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = scatter_smem(rows);
  const dim3 grid((n + rows - 1) / rows, B);
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (idx64) {
    static int done[ogc::kMaxDevices];
    if ((err = ogc::smem_opt_in(scatter_rows_kernel<int64_t>, smem, done))) {
      return (int)err;
    }
    scatter_rows_kernel<int64_t><<<grid, kScatterThreads, smem, st>>>(
        (const int64_t*)idx, (const float*)cot, E, C, n, rows, (float*)out);
  } else {
    static int done[ogc::kMaxDevices];
    if ((err = ogc::smem_opt_in(scatter_rows_kernel<int32_t>, smem, done))) {
      return (int)err;
    }
    scatter_rows_kernel<int32_t><<<grid, kScatterThreads, smem, st>>>(
        (const int32_t*)idx, (const float*)cot, E, C, n, rows, (float*)out);
  }
  return (int)cudaGetLastError();
}
