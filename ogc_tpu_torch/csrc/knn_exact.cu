// Exact k-nearest neighbours on Hopper.
//
// Replaces the Pallas TPU kernels ogc_tpu/ops/pallas_knn.py::_knn_exact_kernel
// and ::_knn_exact_kernel_removal (entry points _knn_exact_pallas /
// knn_exact; knn_exact_mxu_certified has the same contract).
//
// Contract: query (B, N, 3), points (B, M, 3) f32 ->
//   dist (B, N, k) f32 = sqrt(max(d2, 0)), idx (B, N, k) int32,
// ascending by d2 with ties to the LOWER index.  d2 is the direct
// per-coordinate form ((dx*dx + dy*dy) + dz*dz), dx = p - q, pinned with
// __fmul_rn/__fadd_rn against FMA contraction (pallas_knn.py:369-372).
// d2 >= +0 always (squares and their sums are never -0.0), so the bits of
// d2 as an unsigned integer order it as the float does, and the key (d2
// bits, index) orders candidates exactly as a stable sort of d2 does.
//
// Two kernels; the host picks one by k (ops/knn.py::knn_plan) and passes
// it.  Both stream the candidates in ascending index order through
// shared-memory tiles of (x, y, z, 0) entries, one 16-byte load each.
//
// knn_exact_kernel (k <= 8): one thread per query.  Each thread keeps a
// sorted (d2, idx) list of KCAP = 4 or 8 entries in registers and inserts
// a candidate only when it is strictly below the current last entry (a
// later candidate with an equal d2 has a higher index, so strict `<` gives
// the lower-index tie rule; the reference's own insertion,
// pointnet2/src/interpolate_gpu.cu:30-46) by a fully unrolled
// compare-and-swap pass.  It is bound by the distance loop, and wins where
// the queries fill the card (ops/knn.py::knn_plan).  At larger k the
// insertions set its time: a query of 8192 candidates inserts about k * (1
// + ln(M / k)) of them, each a k-step pass that its whole warp runs
// whenever any of its 32 queries inserts.
//
// knn_warp_kernel (every other search): one warp per query, eight queries per block
// sharing the tiles.  Lane l takes candidate j0 + l of every 32; the warp
// computes four such steps' keys and votes once whether any is strictly
// below the current k-th key (every key is, until the list holds k).  If
// one is, a ballot per step marks them and the survivors are appended, in
// index order, to a per-warp buffer in shared memory.  When the buffer may
// not take another 32, the warp merges it into its sorted list of k keys
// (shared memory, 1 or 2 per lane): each survivor's rank is the number of
// list keys <= it (a binary search: a list key has the lower index) plus
// the survivors before it in key order, each list key's rank its position
// plus the survivors strictly below it; every entry of rank < k is written
// to its place, and the k-th key becomes the new threshold.  Few candidates
// survive once the list is full (about k * ln(M / k)), so the merges are
// rare and cost the warp O(buffer) steps each, instead of a serial k-step
// pass per insertion in every thread; 16 x 2048 queries make 32768 warps,
// and the list sits in shared memory, not in 128+ registers.
//
// Bound on the H100: ~9 FP32 operations per (query, candidate) pair a
// search must test; the all-pairs count is the kernels' own work.  The
// warp kernel's time goes to the distance loop's instructions (a 16-byte
// load, 8 operations and a compare per pair, a vote per 128) and, more as
// k grows, to the merges.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "neighbors.cuh"

namespace {

using ogc::d2_to;

constexpr int kThreads = 128;
constexpr int kTile = 1024;

// Stage candidates t0 .. t0 + n - 1 of p into the tile, nthreads threads.
__device__ __forceinline__ void stage_tile(float4* tile, const float* p,
                                           int t0, int n, int nthreads) {
  for (int j = threadIdx.x; j < n; j += nthreads) {
    const float* pj = p + (size_t)(t0 + j) * 3;
    tile[j] = make_float4(pj[0], pj[1], pj[2], 0.0f);
  }
}

template <int KCAP>
__global__ void __launch_bounds__(kThreads)
    knn_exact_kernel(const float* __restrict__ query,
                     const float* __restrict__ points, int N, int M, int k,
                     float* __restrict__ dist, int32_t* __restrict__ idx) {
  __shared__ float4 tile[kTile];

  const int b = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const bool active = n < N;
  const float* q = query + ((size_t)b * N + (active ? n : 0)) * 3;
  const float qx = q[0], qy = q[1], qz = q[2];
  const float* p = points + (size_t)b * M * 3;

  float bd[KCAP];
  int bi[KCAP];
#pragma unroll
  for (int i = 0; i < KCAP; ++i) {
    bd[i] = INFINITY;
    bi[i] = 0x7fffffff;
  }

  for (int t0 = 0; t0 < M; t0 += kTile) {
    const int cnt = min(kTile, M - t0);
    __syncthreads();
    stage_tile(tile, p, t0, cnt, kThreads);
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < cnt; ++j) {
      float cd = d2_to(tile[j], qx, qy, qz);
      if (cd < bd[KCAP - 1]) {
        int ci = t0 + j;
        // Bubble the candidate into place.  Displaced entries move on with
        // the lexicographic (d2, idx) rule, which keeps equal-d2 entries in
        // ascending index order.
#pragma unroll
        for (int i = 0; i < KCAP; ++i) {
          const bool swap = cd < bd[i] || (cd == bd[i] && ci < bi[i]);
          const float td = bd[i];
          const int ti = bi[i];
          bd[i] = swap ? cd : td;
          bi[i] = swap ? ci : ti;
          cd = swap ? td : cd;
          ci = swap ? ti : ci;
        }
      }
    }
  }
  if (!active) return;
  float* od = dist + ((size_t)b * N + n) * k;
  int32_t* oi = idx + ((size_t)b * N + n) * k;
#pragma unroll
  for (int i = 0; i < KCAP; ++i) {
    if (i < k) {
      od[i] = sqrtf(fmaxf(bd[i], 0.0f));
      oi[i] = bi[i];
    }
  }
}

// ---- one warp per query -------------------------------------------------

constexpr int kWarps = 8;       // queries (warps) per block
constexpr int kWarpTile = 1024; // candidates per shared-memory tile
constexpr int kSteps = 4;       // steps of 32 candidates per vote
static_assert(kWarpTile % (32 * kSteps) == 0, "whole groups per tile");

// LPL: list entries per lane, k <= 32 * LPL.
template <int LPL>
__global__ void __launch_bounds__(kWarps * 32)
    knn_warp_kernel(const float* __restrict__ query,
                    const float* __restrict__ points, int N, int M, int k,
                    float* __restrict__ dist, int32_t* __restrict__ idx) {
  __shared__ float4 tile[kWarpTile];
  __shared__ uint32_t lkey[kWarps][32 * LPL];
  __shared__ int32_t lidx[kWarps][32 * LPL];
  __shared__ uint32_t bkey[kWarps][ogc::kSelBuf];
  __shared__ int32_t bidx[kWarps][ogc::kSelBuf];

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int n = blockIdx.x * kWarps + w;
  const bool active = n < N;  // uniform over the warp
  const float* q = query + ((size_t)b * N + (active ? n : 0)) * 3;
  const float qx = q[0], qy = q[1], qz = q[2];
  const float* p = points + (size_t)b * M * 3;
  uint32_t* lk = lkey[w];
  int32_t* li = lidx[w];
  uint32_t* bk = bkey[w];
  int32_t* bi = bidx[w];
  // Keys strictly below thr survive: every key (a masked lane's is
  // 0xffffffff) until the list holds k.
  uint32_t thr = 0xffffffffu;
  int nv = 0, cnt = 0;

  for (int t0 = 0; t0 < M; t0 += kWarpTile) {
    const int tn = min(kWarpTile, M - t0);
    __syncthreads();
    stage_tile(tile, p, t0, tn, kWarps * 32);
    __syncthreads();
    if (!active) continue;
    for (int j0 = 0; j0 < tn; j0 += 32 * kSteps) {
      // kSteps steps of 32 candidates: their keys first, then one vote.
      // The threshold only falls, so a group with no key below it now has
      // nothing to keep, and most groups end here once the list is full.
      uint32_t key[kSteps];
      bool any = false;
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int j = j0 + 32 * u + lane;
        key[u] = 0xffffffffu;
        if (j < tn) key[u] = __float_as_uint(d2_to(tile[j], qx, qy, qz));
        any |= key[u] < thr;
      }
      if (!__any_sync(0xffffffffu, any)) continue;
#pragma unroll
      for (int u = 0; u < kSteps; ++u)
        ogc::warp_offer<LPL, true>(key[u], t0 + j0 + 32 * u + lane, lk, li,
                                   bk, bi, cnt, nv, k, thr, lane);
    }
  }
  if (!active) return;
  if (cnt > 0)
    ogc::warp_merge<LPL, true>(lk, li, bk, bi, cnt, nv, k, thr, lane);
  float* od = dist + ((size_t)b * N + n) * k;
  int32_t* oi = idx + ((size_t)b * N + n) * k;
#pragma unroll
  for (int t = 0; t < LPL; ++t) {
    const int j = lane + 32 * t;
    if (j < k) {
      od[j] = sqrtf(fmaxf(__uint_as_float(lk[j]), 0.0f));
      oi[j] = li[j];
    }
  }
}

template <int KCAP>
cudaError_t launch_thread(const float* q, const float* p, int B, int N,
                          int M, int k, float* d, int32_t* i,
                          cudaStream_t stream) {
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  knn_exact_kernel<KCAP><<<grid, kThreads, 0, stream>>>(q, p, N, M, k, d, i);
  return cudaGetLastError();
}

template <int LPL>
cudaError_t launch_warp(const float* q, const float* p, int B, int N, int M,
                        int k, float* d, int32_t* i, cudaStream_t stream) {
  const dim3 grid((N + kWarps - 1) / kWarps, B);
  knn_warp_kernel<LPL><<<grid, kWarps * 32, 0, stream>>>(q, p, N, M, k, d,
                                                         i);
  return cudaGetLastError();
}

}  // namespace

// query (B, N, 3), points (B, M, 3) f32 contiguous; dist (B, N, k) f32 and
// idx (B, N, k) int32.  Requires 1 <= k <= min(M, 64).  warp = 0: one
// thread per query (k <= 8: a list of 4 or 8 entries in registers);
// warp = 1: one warp per query (k <= 32 or k <= 64).  Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int ogc_knn_exact(const void* query, const void* points, int B,
                             int N, int M, int k, int warp, void* dist,
                             void* idx, void* stream) {
  const float* q = (const float*)query;
  const float* p = (const float*)points;
  float* d = (float*)dist;
  int32_t* i = (int32_t*)idx;
  cudaStream_t s = (cudaStream_t)stream;
  if (k < 1 || k > 64 || k > M) return (int)cudaErrorInvalidValue;
  if (warp) {
    if (k <= 32) return (int)launch_warp<1>(q, p, B, N, M, k, d, i, s);
    return (int)launch_warp<2>(q, p, B, N, M, k, d, i, s);
  }
  if (k <= 4) return (int)launch_thread<4>(q, p, B, N, M, k, d, i, s);
  if (k <= 8) return (int)launch_thread<8>(q, p, B, N, M, k, d, i, s);
  return (int)cudaErrorInvalidValue;
}
