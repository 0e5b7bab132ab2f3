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
// Scatter design: the one-hot product done as compares.  One block per
// (cloud, 128 destination rows); each thread owns one destination row and
// its C <= 16 sums in registers.  The block walks the cloud's edges in
// tiles of 1024: the tile's indices and cotangent rows go to shared memory
// (16-byte loads).  A warp then takes the tile 32 edges at a time: each
// lane compares one edge's index with the warp's 32 rows, and six ballots
// give every lane the mask of the chunk's edges addressed to its row, which
// it adds in ascending e (all lanes at once, so a hub row costs its own
// in-degree, not its warp's).  No atomics, no sort: the order is fixed by
// the walk, so results repeat bit for bit.  Bound on the H100: the
// compares, one per (warp of rows, edge), and the tile loads, which every
// row block of a cloud repeats (from L2); at the SAPIEN smooth-loss shapes
// (n = 512, E = 4096 / 8192) only 16 warps work on a cloud, so latency, not
// bytes, sets the time.  Splitting the edge range across blocks would need
// a second ordered pass and is not done.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gather_rows.cuh"

namespace {

constexpr int kMaxN = 1024;
constexpr int kMaxC = 16;
constexpr int kGatherThreads = 256;
constexpr int kGatherWarps = kGatherThreads / 32;
constexpr int kScatterRows = 128;
constexpr int kTile = 1024;
// Gather blocks: about 8 per SM of the card's 132, each 256 to 4096 edges.
constexpr int kTargetBlocks = 1056;
constexpr int kMinEdges = 256;
constexpr int kMaxEdges = 4096;

// Copy n 4-byte words from device to shared memory with the block's
// threads: 16-byte loads, four in flight per thread, when the source is
// 16-byte aligned (dst always is); word by word otherwise.
template <int kThreads>
__device__ __forceinline__ void stage(uint32_t* __restrict__ dst,
                                      const uint32_t* __restrict__ src,
                                      int n) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n >> 2;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll 4
    for (int t = threadIdx.x; t < n4; t += kThreads) d4[t] = __ldg(s4 + t);
    done = n4 << 2;
  }
#pragma unroll 4
  for (int t = done + threadIdx.x; t < n; t += kThreads) {
    dst[t] = __ldg(src + t);
  }
}

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

__global__ void __launch_bounds__(kScatterRows)
    scatter_rows_kernel(const int32_t* __restrict__ idx,
                        const float* __restrict__ cot, int E, int C, int n,
                        float* __restrict__ out) {
  // Dynamic shared memory: kTile indices, then kTile * C cotangents.
  extern __shared__ uint4 smem_s[];
  int32_t* s_idx = reinterpret_cast<int32_t*>(smem_s);
  float* s_cot = reinterpret_cast<float*>(smem_s) + kTile;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kScatterRows + (threadIdx.x & ~31);
  const int r = r0 + lane;
  const uint32_t* idxb = reinterpret_cast<const uint32_t*>(idx) +
                         (int64_t)b * E;
  const uint32_t* cotb = reinterpret_cast<const uint32_t*>(cot) +
                         (int64_t)b * E * C;
  float acc[kMaxC];
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) acc[c] = 0.0f;
  for (int e0 = 0; e0 < E; e0 += kTile) {
    const int len = min(kTile, E - e0);
    __syncthreads();  // the previous tile's walk is done
    stage<kScatterRows>(reinterpret_cast<uint32_t*>(s_idx), idxb + e0, len);
    stage<kScatterRows>(reinterpret_cast<uint32_t*>(s_cot),
                        cotb + (int64_t)e0 * C, len * C);
    __syncthreads();
    // 32 edges at a time, one per lane.  A ballot finds the edges
    // addressed to this warp's 32 rows; five more spell out each edge's
    // row bit by bit, so every lane gets the mask of its own edges and
    // adds them in ascending e, all lanes at once.
    for (int base = 0; base < len; base += 32) {
      const int e = base + lane;
      const int d = e < len ? s_idx[e] - r0 : -1;
      const bool hit = (unsigned)d < 32u;
      const unsigned hits = __ballot_sync(0xffffffffu, hit);
      if (hits == 0) continue;
      unsigned mine = hits;
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const unsigned bit = __ballot_sync(0xffffffffu, hit && ((d >> k) & 1));
        mine &= ((lane >> k) & 1) ? bit : ~bit;
      }
      while (mine) {
        const int j = __ffs(mine) - 1;
        mine &= mine - 1;
        const float* row = s_cot + (base + j) * C;
#pragma unroll
        for (int c = 0; c < kMaxC; ++c) {
          if (c < C) acc[c] = __fadd_rn(acc[c], row[c]);
        }
      }
    }
  }
  if (r < n) {
    float* o = out + ((int64_t)b * n + r) * C;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c < C) o[c] = acc[c];
    }
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

// idx (B, E) int32, cot (B, E, C) f32; out (B, n, C) f32, every row written
// (rows no edge addresses are 0).  Requires 1 <= n <= 1024, 1 <= C <= 16.
extern "C" int ogc_scatter_add_rows_onehot(const void* idx, const void* cot,
                                           int B, int E, int C, int n,
                                           void* out, void* stream) {
  if (B < 1 || n < 1 || n > kMaxN || C < 1 || C > kMaxC || E < 0) {
    return (int)cudaErrorInvalidValue;
  }
  static int done[ogc::kMaxDevices];
  const int smem = kTile * (1 + C) * (int)sizeof(float);
  const cudaError_t err = ogc::smem_opt_in(scatter_rows_kernel, smem, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kScatterRows - 1) / kScatterRows, B);
  scatter_rows_kernel<<<grid, kScatterRows, smem, (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const float*)cot, E, C, n, (float*)out);
  return (int)cudaGetLastError();
}
