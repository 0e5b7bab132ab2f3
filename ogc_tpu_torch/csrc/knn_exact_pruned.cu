// Bound-pruned exact k-nearest neighbours on Hopper.
//
// Replaces the Pallas TPU kernel ogc_tpu/ops/pallas_knn.py::
// _knn_exact_pruned_kernel (entry points _exact_pruned_pallas /
// knn_exact_pruned).
//
// Contract (the kernel's part): Morton-sorted queries q_s (B, Np, 3) in
// tiles of qt with their original rows qid (B, Np), Morton-sorted points
// p4 (B, Mp, 4) in blocks of cb, each (x, y, z, the bits of its original
// id), rows >= M pads, the blocks' boxes p_box (B, Mp / cb, 6), and per
// tile the blocks `order` (B, nbq, nbp) whose first `count` (B, nbq)
// survive (csrc/pruned_prologue.cu) ->
//   dist (B, N, k) f32 = sqrt(max(d2, 0)), idx (B, N, k) int32 original
// ids, row qid[s] for sorted query s < N: the k smallest (d2, id) pairs
// over the tile's surviving blocks, ascending.  The prologue proves that
// every pruned block lies strictly beyond each query's k-th neighbour, so
// this is #2's answer (csrc/knn_exact.cu): ascending d2, ties to the lower
// index, d2 in the direct per-coordinate form ((dx*dx + dy*dy) + dz*dz),
// dx = p - q, pinned (neighbors.cuh::d2_rn).
//
// Design: a warp per query, 16 warps a CTA (the sizes chip_smoke.py's
// pruned_crossover timed best at the path's shapes), no shared staging.  The
// warp takes its tile's survivors 64 at a time, nearest first by its query's
// lower bound to each block's box (pruned.cuh::nearest_first, a bitonic sort
// of (bound, block) keys; with several queries a warp, the smallest of their
// bounds), and stops at the first block whose bound is strictly above the
// k-th d2 (of every query): no pair of that block or a later one can enter,
// while at equality a tied pair of lower id still could.  Lane l loads
// entries l, l + 32, l + 64, l + 96 of a block (one 16-byte load each;
// neighbouring queries in Morton order read the same blocks through L1).  A
// pair's key is the unique 64-bit (bits(d2) << 32) | id (d2 >= +0.0, so the
// bit order is the numeric order): blocks arrive nearest first and a block's
// points in Morton order, not in id order, so the selection compares (d2,
// id) itself, where #2's payload merge lets the earlier arrival win a tie.
// The keys go through neighbors.cuh's warp selection (a vote of the block's
// four steps against the k-th key, a ballot into a buffer of 64, a bitonic
// merge into a sorted list of k).  Pad rows are never offered: the survivors
// hold k real points.
//
// Bound on the H100: bytes (both clouds read once, the rows written once)
// against 8 FP32 operations per (query, candidate) pair of the queries'
// k-th-distance cubes.  At the flow forward's enc_loc SA1 (16 clouds, 4096
// queries, 8192 points, k 32) that is 0.0057 ms (bytes); the search takes
// ~0.53 ms of device time, ~0.82 without the nearest-first stop (at 8 warps
// a CTA; PERF.md §6).  What is left is per query, not per byte: the sort of
// its survivors' bounds and the 64-bit bitonic merges of its selection, on
// the few blocks it walks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "neighbors.cuh"
#include "pruned.cuh"

// The launch size: queries a warp and warps a CTA.  chip_smoke.py's
// pruned_crossover builds this file with other values (-D) to time them at
// the path's shapes; the library takes these.
#ifndef OGC_KNN4_QUERIES
#define OGC_KNN4_QUERIES 1
#endif
#ifndef OGC_KNN4_WARPS
#define OGC_KNN4_WARPS 16
#endif

namespace {

using Key = unsigned long long;
constexpr int kQueries = OGC_KNN4_QUERIES;
constexpr int kWarps = OGC_KNN4_WARPS;

template <int LPL>
__global__ void __launch_bounds__(kWarps * 32) pruned_knn_kernel(
    const float* __restrict__ qs, const float4* __restrict__ p4,
    const float* __restrict__ p_box, const int32_t* __restrict__ qid,
    const int32_t* __restrict__ order, const int32_t* __restrict__ count,
    int N, int M, int Np, int Mp, int nbq, int nbp, int k, int cb, int qt,
    float* __restrict__ dist, int32_t* __restrict__ idx) {
  constexpr int Q = kQueries;
  static_assert(kWarps * Q * (32 * LPL + ogc::kSelBuf) * sizeof(Key) <=
                    48 * 1024,
                "the lists fit static shared memory");
  __shared__ Key lkey[kWarps][Q][32 * LPL];
  __shared__ Key bkey[kWarps][Q][ogc::kSelBuf];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y, s0 = (blockIdx.x * kWarps + w) * Q;
  if (s0 >= N) return;  // a warp of its own: no barrier follows
  // Q divides qt: the warp's queries share a tile, and rows >= N are the
  // tile's padding (walked, not written).
  float qx[Q], qy[Q], qz[Q];
  Key thr[Q];  // every key until the list holds k
  int nv[Q], cnt[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const float* q = qs + ((size_t)b * Np + s0 + j) * 3;
    qx[j] = q[0];
    qy[j] = q[1];
    qz[j] = q[2];
    thr[j] = ~0ull;
    nv[j] = cnt[j] = 0;
  }
  const size_t row = (size_t)b * nbq + s0 / qt;
  const int32_t* ord = order + row * nbp;
  const int n_surv = count[row];
  const float4* p = p4 + (size_t)b * Mp;
  const float* box = p_box + (size_t)b * nbp * 6;

  for (int g0 = 0; g0 < n_surv; g0 += 64) {
    const int ng = min(64, n_surv - g0);
    unsigned long long near[2];
    // Nearest first by the smallest of the queries' bounds: a block whose
    // bound is strictly above every query's k-th d2 holds nothing for any.
    ogc::nearest_first(near, ng, [&](int i) {
      const float* bx = box + (size_t)ord[g0 + i] * 6;
      float lb = ogc::point_lb2(qx[0], qy[0], qz[0], bx);
#pragma unroll
      for (int j = 1; j < Q; ++j)
        lb = fminf(lb, ogc::point_lb2(qx[j], qy[j], qz[j], bx));
      return lb;
    }, lane);
    for (int e = 0; e < ng; ++e) {
      const int2 item = ogc::nth_nearest(near, e);
      bool stop = true;
#pragma unroll
      for (int j = 0; j < Q; ++j)
        stop &= nv[j] == k && __int_as_float(item.x) >
                                  __uint_as_float((uint32_t)(thr[j] >> 32));
      if (stop) break;  // the later items' bounds are no smaller
      const int base = ord[g0 + item.y] * cb;
      Key key[Q][4];
      bool any[Q];
#pragma unroll
      for (int j = 0; j < Q; ++j) any[j] = false;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = 32 * v + lane;
        const float4 e4 = p[base + min(r, cb - 1)];
        const bool real = r < cb && base + r < M;
#pragma unroll
        for (int j = 0; j < Q; ++j) {
          const float d = ogc::d2_to(e4, qx[j], qy[j], qz[j]);
          key[j][v] = real ? ((Key)__float_as_uint(d) << 32) |
                                 __float_as_uint(e4.w)
                           : ~0ull;
          any[j] |= key[j][v] < thr[j];
        }
      }
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        // The threshold only falls, so a block with no key below it has
        // nothing to keep.
        if (!__any_sync(0xffffffffu, any[j])) continue;
#pragma unroll
        for (int v = 0; v < 4; ++v)
          ogc::offer_unique<LPL>(key[j][v], lkey[w][j], bkey[w][j], cnt[j],
                                 nv[j], k, thr[j], lane);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const int s = s0 + j;
    if (s >= N) break;
    Key* lk = lkey[w][j];
    if (cnt[j] > 0)
      ogc::merge_unique<LPL>(lk, bkey[w][j], cnt[j], nv[j], k, thr[j], lane);
    const size_t out = ((size_t)b * N + qid[(size_t)b * Np + s]) * k;
#pragma unroll
    for (int t = 0; t < LPL; ++t) {
      const int i = lane + 32 * t;
      if (i < k) {
        const Key key = lk[i];
        dist[out + i] = sqrtf(fmaxf(__uint_as_float((uint32_t)(key >> 32)),
                                    0.0f));
        idx[out + i] = (int32_t)(uint32_t)key;
      }
    }
  }
}

}  // namespace

// qs (B, Np, 3) f32, p4 (B, Mp, 4) f32 (x, y, z, id bits), p_box (B, nbp,
// 6) f32, qid (B, Np), order (B, nbq, nbp) and count (B, nbq) int32 from
// ogc_pruned_sort / ogc_pruned_select, all contiguous; Np = nbq * qt, Mp =
// nbp * cb, rows >= M of p4 are pads; dist (B, N, k) f32 and idx (B, N, k)
// int32.  1 <= k <= 64, 1 <= cb <= 128, qt a multiple of the queries a
// warp.  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int ogc_knn_exact_pruned(const void* qs, const void* p4,
                                    const void* p_box, const void* qid,
                                    const void* order, const void* count,
                                    int B, int N, int M, int Np, int Mp,
                                    int nbp, int k, int cb, int qt,
                                    void* dist, void* idx, void* stream) {
  if (B < 1 || N < 1 || k < 1 || k > 64 || cb < 1 || cb > 128 || qt < 1 ||
      qt % kQueries || Np % qt || Mp != nbp * cb || M > Mp || N > Np)
    return (int)cudaErrorInvalidValue;
  constexpr int per_cta = kWarps * kQueries;
  const dim3 grid((N + per_cta - 1) / per_cta, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 32)
    pruned_knn_kernel<1><<<grid, kWarps * 32, 0, st>>>(
        (const float*)qs, (const float4*)p4, (const float*)p_box,
        (const int32_t*)qid, (const int32_t*)order, (const int32_t*)count, N,
        M, Np, Mp, Np / qt, nbp, k, cb, qt, (float*)dist, (int32_t*)idx);
  else
    pruned_knn_kernel<2><<<grid, kWarps * 32, 0, st>>>(
        (const float*)qs, (const float4*)p4, (const float*)p_box,
        (const int32_t*)qid, (const int32_t*)order, (const int32_t*)count, N,
        M, Np, Mp, Np / qt, nbp, k, cb, qt, (float*)dist, (int32_t*)idx);
  return (int)cudaGetLastError();
}
