// Candidate-pruned approximate KNN on Hopper.
//
// Replaces the Pallas TPU kernel ogc_tpu/ops/pallas_knn.py::
// _knn_pruned_kernel (#6, via _knn_pruned_pallas and the entry point
// knn_pruned).
//
// Contract (pallas_knn.py:1164-1237).  Both clouds are Morton-sorted by
// the fused prologue (csrc/pruned_prologue.cu), the points padded to whole
// blocks of cb with pad points at 1e6 and pad id mask_low = 2^idx_bits - 1,
// idx_bits = max(1, bitlen(mp - 1)).  Each query tile of qt sorted queries
// has its n_cand candidate blocks `cand` (a multiple of blk), taken in
// chunks of blk blocks.  At each within-block position r the chunk keeps
// ONE winner: the minimum (d2, original id) over its blk blocks, ties to
// the lower id (the thinning groups distant blocks, not neighbouring
// points).  d2 is the direct form ((dx*dx + dy*dy) + dz*dz), dx = p - q,
// pinned (neighbors.cuh::d2_rn).  A winner's int32 key is (bits(d2) &
// ~mask_low) | id.  Output: the k smallest DISTINCT keys ascending (pads
// share one key; INT32_MAX where a row has fewer), as idx = key & mask_low
// and the truncated dist = sqrt(max(d2, 0)), at row qid[s] of sorted query
// s < N.
//
// Design: #3's warp kernel (knn_blockmin.cu) over a tile's candidates: a
// CTA of 16 warps per (query tile, batch item, slice of 32 queries), two
// queries a warp (OGC_KNN6_WARPS, OGC_KNN6_QUERIES).  The CTA stages
// whole chunks, about 1024 points at a time, as (x, y, z, id) entries in
// shared memory (pruned.cuh::stage_blocks); lane l owns positions l,
// l + 32, l + 64, l + 96 of a chunk, takes each one's minimum over the
// chunk's blk blocks in registers for both queries (each entry read once
// serves both), and builds the keys; the warp votes each query's four
// keys against its k-th key and offers them to neighbors.cuh's unique-key
// selection (a ballot into a buffer of 64, a bitonic merge into a sorted
// list of k).  The real keys
// are unique: a candidate block is chosen once and the ids differ.  Pad
// rows all sit at one point, so every pad winner of a query has the same
// key (its id mask_low is no real id); a pad winner is not offered but
// remembered, and offered once after the walk, where the merge places it
// by value among the real keys.
//
// Bound on the H100: operations.  The function needs each query against
// its tile's n_cand x cb candidates, 8 FP32 operations each (3 sub, 3 mul,
// 2 add), plus the thinning compares: at B = 8, 4096 queries, 32 blocks of
// 128, ~1.1 GFLOP, ~0.016 ms at 67 TFLOP/s; the search takes ~0.18 ms of
// device time there (PERF.md §6), 11x its bound.  Each pair costs ~11-12
// issued instructions (the compare and selects of the chunk minimum
// besides), as in #3, and the selection grows with k.  The launch size is
// the one chip_smoke.py's pruned_crossover timed best at the bench's
// shapes.  It stages, where #4's warps load for themselves in nearest-
// first order: a chunk joins distant blocks, so its bound would stop
// little.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gather_rows.cuh"
#include "neighbors.cuh"
#include "pruned.cuh"

// The launch size: queries a warp and warps a CTA.  chip_smoke.py's
// pruned_crossover builds this file with other values (-D) to time them at
// the path's shapes; the library takes these.
#ifndef OGC_KNN6_QUERIES
#define OGC_KNN6_QUERIES 2
#endif
#ifndef OGC_KNN6_WARPS
#define OGC_KNN6_WARPS 16
#endif

namespace {

constexpr int kWarps = OGC_KNN6_WARPS;
constexpr int kQueries = OGC_KNN6_QUERIES;
constexpr int kStage = 1024;   // staged point entries, at least a chunk

template <int LPL>
__global__ void __launch_bounds__(kWarps * 32) cand_knn_kernel(
    const float* __restrict__ qs, const float4* __restrict__ p4,
    const int32_t* __restrict__ qid, const int32_t* __restrict__ cand, int N,
    int M, int Np, int Mp, int n_cand, int k, int blk, int cb, int qt,
    int idx_bits, int stage_chunks, float* __restrict__ dist,
    int32_t* __restrict__ idx) {
  constexpr int Q = kQueries;
  extern __shared__ float4 smem[];
  const int chunk = blk * cb;
  float4* stage = smem;
  uint32_t* lkey = reinterpret_cast<uint32_t*>(smem + stage_chunks * chunk);
  uint32_t* bkey = lkey + kWarps * Q * 32 * LPL;

  const int split = qt / (kWarps * Q);  // CTAs per tile
  const int tile = blockIdx.x / split, b = blockIdx.y;
  const int nbq = gridDim.x / split;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s0 = tile * qt + (blockIdx.x - tile * split) * kWarps * Q + w * Q;
  const bool active = s0 < N;  // uniform over the warp
  const uint32_t mask_low = (1u << idx_bits) - 1u;
  float qx[Q], qy[Q], qz[Q];
  uint32_t thr[Q], pad_key[Q];
  int nv[Q], cnt[Q];
  bool saw_pad[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const float* q = qs + ((size_t)b * Np + s0 + j) * 3;
    qx[j] = q[0];
    qy[j] = q[1];
    qz[j] = q[2];
    thr[j] = 0xffffffffu;  // every key until the list holds k
    nv[j] = 0;
    cnt[j] = 0;
    pad_key[j] = 0xffffffffu;
    saw_pad[j] = false;
  }
  const int32_t* c_t = cand + ((size_t)b * nbq + tile) * n_cand;
  const float4* p = p4 + (size_t)b * Mp;
  const int chunks = n_cand / blk;

  for (int c0 = 0; c0 < chunks; c0 += stage_chunks) {
    const int nc = min(stage_chunks, chunks - c0);
    __syncthreads();  // the previous stage is consumed
    ogc::stage_blocks(stage, c_t + c0 * blk, nc * blk, cb, p, M);
    __syncthreads();
    if (!active) continue;
    for (int ci = 0; ci < nc; ++ci) {
      const float4* ch = stage + ci * chunk;
      uint32_t key[Q][4];
      bool any[Q];
#pragma unroll
      for (int j = 0; j < Q; ++j) any[j] = false;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = 32 * v + lane;
        const int rr = min(r, cb - 1);
        float vmin[Q];
        uint32_t amin[Q];
#pragma unroll
        for (int j = 0; j < Q; ++j) {
          vmin[j] = 0.0f;
          amin[j] = 0u;
        }
        for (int i = 0; i < blk; ++i) {
          const float4 e = ch[i * cb + rr];
          const uint32_t wb = __float_as_uint(e.w);  // id, sign: a pad
#pragma unroll
          for (int j = 0; j < Q; ++j) {
            const float d = ogc::d2_to(e, qx[j], qy[j], qz[j]);
            if (i == 0 || d < vmin[j] ||
                (d == vmin[j] &&
                 (wb & 0x7fffffffu) < (amin[j] & 0x7fffffffu))) {
              vmin[j] = d;
              amin[j] = wb;
            }
          }
        }
#pragma unroll
        for (int j = 0; j < Q; ++j) {
          uint32_t kk = (__float_as_uint(vmin[j]) & ~mask_low) |
                        (amin[j] & 0x7fffffffu);
          if (r >= cb) {
            kk = 0xffffffffu;
          } else if (amin[j] >> 31) {  // a pad: remembered, not offered
            pad_key[j] = kk;
            saw_pad[j] = true;
            kk = 0xffffffffu;
          }
          key[j][v] = kk;
          any[j] |= kk < thr[j];
        }
      }
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        if (!__any_sync(0xffffffffu, any[j])) continue;
        uint32_t* lk = lkey + (w * Q + j) * 32 * LPL;
        uint32_t* bk = bkey + (w * Q + j) * ogc::kSelBuf;
#pragma unroll
        for (int v = 0; v < 4; ++v)
          ogc::offer_unique<LPL>(key[j][v], lk, bk, cnt[j], nv[j], k, thr[j],
                                 lane);
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const int s = s0 + j;
    if (s >= N) break;
    uint32_t* lk = lkey + (w * Q + j) * 32 * LPL;
    const unsigned pads = __ballot_sync(0xffffffffu, saw_pad[j]);
    if (pads) {  // the one pad key, offered once, merged by value
      const uint32_t pk = __shfl_sync(0xffffffffu, pad_key[j],
                                      __ffs(pads) - 1);
      ogc::offer_unique<LPL>(lane == 0 ? pk : 0xffffffffu, lk,
                             bkey + (w * Q + j) * ogc::kSelBuf, cnt[j], nv[j],
                             k, thr[j], lane);
    }
    if (cnt[j] > 0)
      ogc::merge_unique<LPL>(lk, bkey + (w * Q + j) * ogc::kSelBuf, cnt[j],
                             nv[j], k, thr[j], lane);
    const size_t out = ((size_t)b * N + qid[(size_t)b * Np + s]) * k;
#pragma unroll
    for (int t = 0; t < LPL; ++t) {
      const int i = lane + 32 * t;
      if (i < k) {
        const uint32_t key = i < nv[j] ? lk[i] : 0x7fffffffu;
        idx[out + i] = (int32_t)(key & mask_low);
        const float d2 = __uint_as_float(key & ~mask_low);
        // max(d2, 0) that keeps a NaN, as torch.clamp and jnp.maximum do.
        dist[out + i] = sqrtf(d2 < 0.0f ? 0.0f : d2);
      }
    }
  }
}

template <int LPL>
int launch(const float* qs, const float4* p4, const int32_t* qid,
           const int32_t* cand, int B, int N, int M, int Np, int Mp,
           int n_cand, int k, int blk, int cb, int qt, int idx_bits,
           float* dist, int32_t* idx, cudaStream_t s) {
  static int done[ogc::kMaxDevices];
  const int chunk = blk * cb;
  const int stage_chunks = max(1, kStage / chunk);
  const size_t smem = (size_t)stage_chunks * chunk * sizeof(float4) +
                      (size_t)kWarps * kQueries * (32 * LPL + ogc::kSelBuf) *
                          sizeof(uint32_t);
  auto kernel = cand_knn_kernel<LPL>;
  cudaError_t err = ogc::smem_opt_in(kernel, (int)smem, done);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(Np / (kWarps * kQueries), B), kWarps * 32, smem, s>>>(
      qs, p4, qid, cand, N, M, Np, Mp, n_cand, k, blk, cb, qt, idx_bits,
      stage_chunks, dist, idx);
  return (int)cudaGetLastError();
}

}  // namespace

// qs (B, Np, 3) f32, p4 (B, Mp, 4) f32 (x, y, z, id bits), qid (B, Np)
// and cand (B, Np / qt, n_cand) int32 from ogc_pruned_sort /
// ogc_pruned_select, block ids in [0, Mp / cb), rows >= M of p4 are pads;
// dist (B, N, k) f32 and idx (B, N, k) int32.  Np a multiple of qt, qt of
// the queries a CTA takes (32), 1 <= cb <= 128 with Mp a multiple of cb,
// n_cand a multiple of blk, blk * cb <= 3072, 1 <= k <= 64.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int ogc_knn_cand(const void* qs, const void* p4, const void* qid,
                            const void* cand, int B, int N, int M, int Np,
                            int Mp, int n_cand, int k, int blk, int cb,
                            int qt, int idx_bits, void* dist, void* idx,
                            void* stream) {
  if (B < 1 || N < 1 || qt < 1 || qt % (kWarps * kQueries) || Np % qt ||
      N > Np || cb < 1 || cb > 128 || Mp % cb || M > Mp || blk < 1 ||
      n_cand < blk || n_cand % blk || blk * cb > 3072 || k < 1 || k > 64)
    return (int)cudaErrorInvalidValue;
  const float* q = (const float*)qs;
  const float4* p = (const float4*)p4;
  const int32_t* qi = (const int32_t*)qid;
  const int32_t* c = (const int32_t*)cand;
  float* d = (float*)dist;
  int32_t* i = (int32_t*)idx;
  cudaStream_t s = (cudaStream_t)stream;
  return k <= 32 ? launch<1>(q, p, qi, c, B, N, M, Np, Mp, n_cand, k, blk, cb,
                             qt, idx_bits, d, i, s)
                 : launch<2>(q, p, qi, c, B, N, M, Np, Mp, n_cand, k, blk, cb,
                             qt, idx_bits, d, i, s);
}
