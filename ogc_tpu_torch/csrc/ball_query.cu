// Ball queries on Hopper: the exact one and the block-min one, one kernel.
//
// Replaces the Pallas TPU kernel ogc_tpu/ops/pallas_knn.py::
// _ball_exact_pruned_kernel (entry point ball_query_exact_pruned) and
// ::_knn_kernel in its ball modes: exact (ball_query_exact, blk = 1) and
// thinned (ball_query_blockmin, blk 4-32); ogc_tpu/ops/core.py::_fill_balls
// completes all of them.
//
// Contract: points (B, N, 3), centres (B, M, 3) f32 -> idx (B, M, ns)
// int32, the filled ball of every centre.  The candidates are cut into runs
// of blk consecutive indices and a run's key is its lowest index j with
// d2(j) < r2 (strict); the ball is the first ns run keys in index order, an
// under-full ball repeats its first index in the remaining slots, and an
// empty ball is all zeros (reference pointnet2/src/ball_query_gpu.cu:9-45).
// With blk = 1 that is the exact ball: the ns LOWEST in-radius indices.  The
// block-min mode pads the points to Np = ceil(N / 1024) * 1024 with pad
// points at (1e6, 1e6, 1e6) (pallas_knn.py:1496-1498); the exact one has
// no pads (Np = N).  d2 is the direct per-coordinate form of neighbors.cuh.
//
// Design: one warp per centre, 8 warps a block sharing shared-memory tiles
// of 1024 (x, y, z, 0) entries (padded to whole votes: in the exact mode
// the entries past N are at 1e30, whose d2 is +inf).  The warp walks the
// candidates in index order, 32 at a time: lane l takes candidate j0 + l
// (a conflict-free 16-byte load), and a ballot of d2 < r2 marks the
// in-radius lanes of each step.  Four steps are tested before one test of
// their ballots: most of them are empty in an under-full ball, and cost
// the warp nothing more.  Otherwise, per step, with blk > 1 a lane keeps
// its hit only when no lower lane of its aligned group of blk lanes hit
// (blk divides 32 and steps start at multiples of 32, so a group is a
// run), and a second ballot marks the winners.  A __popc of the winners
// below a lane gives its slot: the ball is written in index order by
// construction, with no selection and no per-lane branch on the data.
// The warp stops once ns slots are filled (a warp-uniform test), the block
// at the next tile once all its warps have (__syncthreads_and); then the
// lanes fill the remaining slots.  No atomics: deterministic.  Two centres
// a warp sharing each load were no faster on under-full balls and slower
// on crowded ones (a warp waits for its slower centre; PERF.md §6).
// (The TPU kernel's Morton sort, AABB pruning and ns masked-min
// extractions rebuild the index order after visiting blocks out of order;
// this kernel visits all of them in order.)
//
// Bound on the H100: at the smooth loss's shape (8192 centres x 8192
// points, ns 64, r 2) most balls hold fewer than 64 points, so most warps
// test all N points: the N x M sweep, ~11 instructions a pair (a 16-byte
// load, 8 FP32 operations, a compare, a vote).  The function itself needs
// far less: a search pruned by spatial cells tests only the points near
// each centre, so its bound is the bytes (~2.7 us per call at that shape).
// Cell or Morton tiling that keeps the index order is the next design.

#include <cuda_runtime.h>
#include <stdint.h>

#include "neighbors.cuh"

namespace {

using ogc::d2_to;

constexpr int kWarps = 8;    // centres (warps) per block
constexpr int kTile = 1024;
constexpr int kSteps = 4;    // steps of 32 candidates per vote
constexpr float kPad = 1e6f;
constexpr float kFar = 1e30f;  // past Np: (1e30)^2 is +inf

// Candidate g of a cloud of N points padded with points at 1e6.
__device__ __forceinline__ float4 point(const float* __restrict__ p, int N,
                                        int g) {
  if (g >= N) return make_float4(kPad, kPad, kPad, 0.0f);
  const float* pg = p + (size_t)g * 3;
  return make_float4(pg[0], pg[1], pg[2], 0.0f);
}

template <int BLK>
__global__ void __launch_bounds__(kWarps * 32)
    ball_kernel(const float* __restrict__ points,
                const float* __restrict__ centres, int N, int M, int Np,
                int ns, float r2, int32_t* __restrict__ idx) {
  static_assert(BLK >= 1 && BLK <= 32 && (BLK & (BLK - 1)) == 0, "blk");
  __shared__ float4 tile[kTile];

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int m = blockIdx.x * kWarps + w;
  const float* p = points + (size_t)b * N * 3;
  const unsigned below = (1u << lane) - 1;
  // The lanes below this one in its run (aligned group of BLK lanes).
  const unsigned group_below =
      below & (BLK == 32 ? 0xffffffffu
                         : ((1u << BLK) - 1) << (lane & ~(BLK - 1)));
  const float* c = centres + ((size_t)b * M + min(m, M - 1)) * 3;
  const float cx = c[0], cy = c[1], cz = c[2];
  int32_t* out = idx + ((size_t)b * M + min(m, M - 1)) * ns;
  int cnt = 0, first = 0;
  bool done = m >= M;  // uniform over the warp

  for (int t0 = 0; t0 < Np; t0 += kTile) {
    // Also the barrier that keeps the previous tile alive until every warp
    // is done with it.
    if (__syncthreads_and(done)) break;
    const int len = min(kTile, Np - t0);
    // Whole votes: entries past Np (the exact mode's ragged end) are far
    // enough that d2 is +inf, never below r2.
    const int len_v = (len + 32 * kSteps - 1) & ~(32 * kSteps - 1);
    for (int j = threadIdx.x; j < len_v; j += kWarps * 32)
      tile[j] = j < len ? point(p, N, t0 + j)
                        : make_float4(kFar, kFar, kFar, 0.0f);
    __syncthreads();
    for (int j0 = 0; j0 < len && !done; j0 += 32 * kSteps) {
      const float4* e = tile + j0 + lane;
      unsigned hits[kSteps];  // the in-radius lanes of step u
      unsigned any = 0;
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        hits[u] = __ballot_sync(0xffffffffu,
                                d2_to(e[32 * u], cx, cy, cz) < r2);
        any |= hits[u];
      }
      if (!any) continue;
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        if (!hits[u] || done) continue;  // uniform over the warp
        bool win = hits[u] >> lane & 1;
        unsigned wins = hits[u];
        if (BLK > 1) {
          win = win && !(hits[u] & group_below);
          wins = __ballot_sync(0xffffffffu, win);
        }
        const int base = t0 + j0 + 32 * u;
        if (cnt == 0) first = base + __ffs(wins) - 1;
        const int slot = cnt + __popc(wins & below);
        if (win && slot < ns) out[slot] = base + lane;
        cnt += __popc(wins);
        done = cnt >= ns;
      }
    }
  }
  // Fill: repeat the first hit; an empty ball stays all zeros (first = 0).
  if (m >= M) return;
  for (int s = min(cnt, ns) + lane; s < ns; s += 32) out[s] = first;
}

template <int BLK>
int launch(const float* p, const float* c, int B, int N, int M, int Np,
           int ns, float r2, int32_t* idx, cudaStream_t s) {
  const dim3 grid((M + kWarps - 1) / kWarps, B);
  ball_kernel<BLK><<<grid, kWarps * 32, 0, s>>>(p, c, N, M, Np, ns, r2, idx);
  return (int)cudaGetLastError();
}

}  // namespace

// points (B, N, 3), centres (B, M, 3) f32 contiguous; idx (B, M, ns)
// int32, the filled balls.  blk = 1 (exact: Np = N) or 4, 8, 16, 32
// (block-min: Np = ceil(N / 1024) * 1024, pads past N); ns >= 1.  Launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int ogc_ball_query(const void* points, const void* centres, int B,
                              int N, int M, int Np, int ns, int blk, float r2,
                              void* idx, void* stream) {
  if (ns < 1 || Np < N || (blk > 1 && Np % kTile != 0))
    return (int)cudaErrorInvalidValue;
  const float* p = (const float*)points;
  const float* c = (const float*)centres;
  int32_t* i = (int32_t*)idx;
  cudaStream_t s = (cudaStream_t)stream;
  switch (blk) {
    case 1: return launch<1>(p, c, B, N, M, Np, ns, r2, i, s);
    case 4: return launch<4>(p, c, B, N, M, Np, ns, r2, i, s);
    case 8: return launch<8>(p, c, B, N, M, Np, ns, r2, i, s);
    case 16: return launch<16>(p, c, B, N, M, Np, ns, r2, i, s);
    case 32: return launch<32>(p, c, B, N, M, Np, ns, r2, i, s);
  }
  return (int)cudaErrorInvalidValue;
}
