// Block-min approximate KNN on Hopper.
//
// Replaces the Pallas TPU kernel ogc_tpu/ops/pallas_knn.py::_knn_kernel in
// its thinned KNN mode (entry point knn_blockmin).  Its ball modes, thinned
// (ball_query_blockmin) and exact (ball_query_exact, blk = 1), are served
// by ball_query.cu.
//
// Contract (pallas_knn.py:147-312, :1402-1453).  The points are padded to
// Mp = ceil(M / 1024) * 1024 with pad points at (1e6, 1e6, 1e6), split into
// Mp / blk runs of blk consecutive candidates, and each run keeps ONE
// winner: its minimum FULL d2, ties to the lowest index.  Its int32 key is
// (bits(d2) & ~mask_low) | idx, mask_low = 2^idx_bits - 1, idx_bits =
// max(1, bitlen(Mp - 1)); the minimum is taken before the truncation (two
// candidates whose d2 agree above idx_bits keep the nearer one, not the
// lower index).  Output: the k smallest keys ascending, as idx = key &
// mask_low and the TRUNCATED dist = sqrt(max(float(key & ~mask_low), 0)).
// d2 is the direct per-coordinate form of neighbors.cuh.  Keys are unique
// (their low bits are the index) and >= 0, so they order as uint32.
//
// Two kernels; the host picks one (ops/knn_blockmin.py::blockmin_plan) and
// passes it.  Both stream the candidates through shared-memory tiles of
// 1024 (x, y, z, 0) entries (Mp is a multiple of that and blk divides it,
// so no run straddles two tiles), and both template the run length blk.
//
// blockmin_thread_kernel (k <= 8 over many queries: every k = 3 site of
// the paths): one thread per query, every thread of a block reading the
// same entry (a broadcast, with an immediate offset); a run's winner in
// registers, then a sorted list of KCAP = 4 or 8 keys that takes a key
// only when it is below the last entry, by an unrolled compare-and-swap
// pass.  At k = 3 a query inserts a few of its runs.
//
// blockmin_warp_kernel (every other search): one warp per two queries, 16
// warps a block sharing the tiles.  Lane l takes runs l, l + 32, ... of a
// tile and walks each run alone, so a run's minimum over (d2, index) stays
// in its registers (reducing a run across lanes would cost log2(blk)
// 64-bit shuffle-and-compare steps per candidate).  The tile is staged
// with entry c at slot c ^ ((c / blk) & 7): the staging writes of 8
// consecutive entries and a quarter-warp's reads of candidate t of 8
// consecutive runs each touch 8 distinct 16-byte bank groups, so both are
// conflict-free, and each lane keeps its swizzled offsets in registers, so
// a load is a register plus an immediate.  Each loaded entry serves both
// queries.  Up to four steps' run keys (one run a lane a step) are voted
// against each query's k-th key at once; survivors go through
// neighbors.cuh's warp selection (a ballot into a buffer of 64, merged by
// a bitonic network into a list of k keys in shared memory), not a serial
// k-step insertion that a warp runs whenever any lane inserts.  Two
// queries a warp and 16 warps a block were the fastest of 1-4 queries and
// 8-16 warps at every warp-kernel site (PERF.md §6).
//
// Bound on the H100: operations.  The function needs every (query,
// candidate) pair, 8 FP32 operations each (3 sub, 3 mul, 2 add; the run
// minimum's compare and selects besides): 16 x 2048 x 8192 pairs of SA0
// are ~2.1 GFLOP, ~0.032 ms at 67 TFLOP/s.  Bytes are small (the cloud,
// 96 KB, is read once per block from L2).  Both kernels issue ~11-12
// instructions a pair (the compares and selects are not in the bound), so
// the sweep alone runs at ~1/3 of the bound at best; the warp kernel adds
// its selection, which grows with k.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "neighbors.cuh"

namespace {

using ogc::d2_to;

constexpr int kThreads = 128;  // thread kernel: queries per block
constexpr int kWarps = 16;     // warp kernel: warps per block
constexpr int kQueries = 2;    // warp kernel: queries per warp
constexpr int kTile = 1024;
constexpr float kPad = 1e6f;

// Entry j of the candidates [t0, t0 + kTile) of one cloud of M points;
// indices >= M are pads.
__device__ __forceinline__ float4 tile_entry(const float* __restrict__ p,
                                             int M, int g) {
  if (g >= M) return make_float4(kPad, kPad, kPad, 0.0f);
  const float* pg = p + (size_t)g * 3;
  return make_float4(pg[0], pg[1], pg[2], 0.0f);
}

template <int KCAP, int BLK>
__global__ void __launch_bounds__(kThreads)
    blockmin_thread_kernel(const float* __restrict__ query,
                           const float* __restrict__ points, int N, int M,
                           int Mp, int k, int idx_bits,
                           float* __restrict__ dist,
                           int32_t* __restrict__ idx) {
  __shared__ float4 tile[kTile];

  const int b = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const bool active = n < N;
  const float* q = query + ((size_t)b * N + (active ? n : 0)) * 3;
  const float qx = q[0], qy = q[1], qz = q[2];
  const float* p = points + (size_t)b * M * 3;
  const int32_t mask_low = (int32_t)((1u << idx_bits) - 1u);

  int32_t keys[KCAP];
#pragma unroll
  for (int i = 0; i < KCAP; ++i) keys[i] = 0x7fffffff;

  for (int t0 = 0; t0 < Mp; t0 += kTile) {
    __syncthreads();
    for (int j = threadIdx.x; j < kTile; j += kThreads)
      tile[j] = tile_entry(p, M, t0 + j);
    __syncthreads();
    if (!active) continue;
    for (int g0 = 0; g0 < kTile; g0 += BLK) {
      float vmin = d2_to(tile[g0], qx, qy, qz);
      int amin = 0;
#pragma unroll
      for (int t = 1; t < BLK; ++t) {
        const float d = d2_to(tile[g0 + t], qx, qy, qz);
        if (d < vmin) {  // strict: ties keep the lower index
          vmin = d;
          amin = t;
        }
      }
      int32_t key = (__float_as_int(vmin) & ~mask_low) | (t0 + g0 + amin);
      if (key < keys[KCAP - 1]) {
#pragma unroll
        for (int i = 0; i < KCAP; ++i) {
          const bool swap = key < keys[i];
          const int32_t t = keys[i];
          keys[i] = swap ? key : t;
          key = swap ? t : key;
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
      oi[i] = keys[i] & mask_low;
      od[i] = sqrtf(fmaxf(__int_as_float(keys[i] & ~mask_low), 0.0f));
    }
  }
}

// LPL: list entries per lane (k <= 32 * LPL).
template <int LPL, int BLK>
__global__ void __launch_bounds__(kWarps * 32)
    blockmin_warp_kernel(const float* __restrict__ query,
                         const float* __restrict__ points, int N, int M,
                         int Mp, int k, int idx_bits,
                         float* __restrict__ dist,
                         int32_t* __restrict__ idx) {
  constexpr int S = kTile / (32 * BLK);  // steps (32 runs each) per tile
  constexpr int V = S < 4 ? S : 4;       // steps per vote
  static_assert(S % V == 0, "whole votes per tile");
  constexpr int O = BLK < 8 ? BLK : 8;   // swizzled offsets per lane
  __shared__ float4 tile[kTile];
  __shared__ uint32_t lkey[kWarps * kQueries][32 * LPL];
  __shared__ uint32_t bkey[kWarps * kQueries][ogc::kSelBuf];

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int n0 = (blockIdx.x * kWarps + w) * kQueries;
  const bool active = n0 < N;  // uniform over the warp
  const float* p = points + (size_t)b * M * 3;
  const uint32_t mask_low = (1u << idx_bits) - 1u;
  float qx[kQueries], qy[kQueries], qz[kQueries];
  uint32_t thr[kQueries];
  int nv[kQueries], cnt[kQueries];
#pragma unroll
  for (int j = 0; j < kQueries; ++j) {
    const int n = min(n0 + j, N - 1);
    const float* q = query + ((size_t)b * N + max(n, 0)) * 3;
    qx[j] = q[0];
    qy[j] = q[1];
    qz[j] = q[2];
    // Keys strictly below thr survive: every key until the list holds k;
    // none for a slot past the last query.
    thr[j] = n0 + j < N ? 0xffffffffu : 0u;
    nv[j] = 0;
    cnt[j] = 0;
  }
  // Candidate t of this lane's run at step s sits at slot 32 * BLK * s +
  // (t & ~7) + off[t & 7]: the run starts at (32 s + lane) * BLK, and the
  // swizzle (run & 7 = lane & 7) changes only the low 3 bits of the slot.
  // The offsets (in bytes) are computed once and kept opaque, so every
  // load is a register plus an immediate.
  uint32_t off[O];
#pragma unroll
  for (int j = 0; j < O; ++j) {
    off[j] = (uint32_t)((lane * BLK + j) ^ (lane & 7)) * sizeof(float4);
    asm volatile("" : "+r"(off[j]));
  }

  for (int t0 = 0; t0 < Mp; t0 += kTile) {
    __syncthreads();
    for (int c = threadIdx.x; c < kTile; c += kWarps * 32)
      tile[c ^ ((c / BLK) & 7)] = tile_entry(p, M, t0 + c);
    __syncthreads();
    if (!active) continue;
#pragma unroll 1
    for (int s0 = 0; s0 < S; s0 += V) {
      uint32_t key[kQueries][V];
      bool any[kQueries];
#pragma unroll
      for (int j = 0; j < kQueries; ++j) any[j] = false;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int base = (32 * (s0 + v) + lane) * BLK;  // this lane's run
        const char* row =
            reinterpret_cast<const char*>(tile + 32 * BLK * (s0 + v));
        float vmin[kQueries];
        int amin[kQueries];
#pragma unroll
        for (int j = 0; j < kQueries; ++j) {
          vmin[j] = 0.0f;
          amin[j] = 0;
        }
#pragma unroll
        for (int t = 0; t < BLK; ++t) {
          const float4 e = *reinterpret_cast<const float4*>(
              row + off[t & 7] + (t & ~7) * sizeof(float4));
#pragma unroll
          for (int j = 0; j < kQueries; ++j) {
            const float d = d2_to(e, qx[j], qy[j], qz[j]);
            if (t == 0 || d < vmin[j]) {  // strict: ties keep the lower
              vmin[j] = d;
              amin[j] = t;
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kQueries; ++j) {
          key[j][v] = (__float_as_uint(vmin[j]) & ~mask_low) |
                      (uint32_t)(t0 + base + amin[j]);
          any[j] |= key[j][v] < thr[j];
        }
      }
#pragma unroll
      for (int j = 0; j < kQueries; ++j) {
        // The threshold only falls, so a vote with no key below it has
        // nothing to keep, and most end here once the list is full.
        if (!__any_sync(0xffffffffu, any[j])) continue;
#pragma unroll
        for (int v = 0; v < V; ++v)
          ogc::warp_offer<LPL, false>(key[j][v], 0, lkey[w * kQueries + j], nullptr,
                                      bkey[w * kQueries + j], nullptr, cnt[j],
                                      nv[j], k, thr[j], lane);
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int j = 0; j < kQueries; ++j) {
    const int n = n0 + j;
    if (n >= N) break;
    uint32_t* lk = lkey[w * kQueries + j];
    if (cnt[j] > 0)
      ogc::warp_merge<LPL, false>(lk, nullptr, bkey[w * kQueries + j], nullptr,
                                  cnt[j], nv[j], k, thr[j], lane);
    float* od = dist + ((size_t)b * N + n) * k;
    int32_t* oi = idx + ((size_t)b * N + n) * k;
#pragma unroll
    for (int t = 0; t < LPL; ++t) {
      const int i = lane + 32 * t;
      if (i < k) {
        const uint32_t key = lk[i];
        oi[i] = (int32_t)(key & mask_low);
        od[i] = sqrtf(fmaxf(__uint_as_float(key & ~mask_low), 0.0f));
      }
    }
  }
}

struct Args {
  const float* q;
  const float* p;
  int B, N, M, Mp, k, idx_bits;
  float* d;
  int32_t* i;
  cudaStream_t s;
};

template <int KCAP, int BLK>
int launch_thread(const Args& a) {
  const dim3 grid((a.N + kThreads - 1) / kThreads, a.B);
  blockmin_thread_kernel<KCAP, BLK><<<grid, kThreads, 0, a.s>>>(
      a.q, a.p, a.N, a.M, a.Mp, a.k, a.idx_bits, a.d, a.i);
  return (int)cudaGetLastError();
}

template <int LPL, int BLK>
int launch_warp(const Args& a) {
  const int per_block = kWarps * kQueries;
  const dim3 grid((a.N + per_block - 1) / per_block, a.B);
  blockmin_warp_kernel<LPL, BLK><<<grid, kWarps * 32, 0, a.s>>>(
      a.q, a.p, a.N, a.M, a.Mp, a.k, a.idx_bits, a.d, a.i);
  return (int)cudaGetLastError();
}

template <int BLK>
int launch_blk(const Args& a, int warp, int cap) {
  if (!warp && cap == 4) return launch_thread<4, BLK>(a);
  if (!warp && cap == 8) return launch_thread<8, BLK>(a);
  if (warp && cap == 32) return launch_warp<1, BLK>(a);
  if (warp && cap == 64) return launch_warp<2, BLK>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// query (B, N, 3), points (B, M, 3) f32 contiguous; dist (B, N, k) f32 and
// idx (B, N, k) int32.  Mp = ceil(M / 1024) * 1024, blk in {4, 8, 16, 32},
// idx_bits = max(1, bitlen(Mp - 1)), ceil(M / blk) >= k.  warp = 0: one
// thread per query, cap (4 or 8) >= k; warp = 1: one warp per two queries,
// cap (32 or 64) >= k.  Launches on `stream` and returns cudaGetLastError()
// (0 on success).
extern "C" int ogc_knn_blockmin(const void* query, const void* points, int B,
                                int N, int M, int Mp, int k, int blk,
                                int idx_bits, int warp, int cap, void* dist,
                                void* idx, void* stream) {
  if (k < 1 || k > cap || Mp % kTile != 0 || (M + blk - 1) / blk < k)
    return (int)cudaErrorInvalidValue;
  const Args a{(const float*)query, (const float*)points, B, N, M, Mp, k,
               idx_bits, (float*)dist, (int32_t*)idx, (cudaStream_t)stream};
  switch (blk) {
    case 4: return launch_blk<4>(a, warp, cap);
    case 8: return launch_blk<8>(a, warp, cap);
    case 16: return launch_blk<16>(a, warp, cap);
    case 32: return launch_blk<32>(a, warp, cap);
  }
  return (int)cudaErrorInvalidValue;
}
