// Block-min approximate KNN and ball query on Hopper.
//
// Replaces the Pallas TPU kernel ogc_tpu/ops/pallas_knn.py::_knn_kernel in
// its thinned modes (entry points knn_blockmin and ball_query_blockmin; its
// exact-ball mode, blk = 1, is served by ball_query.cu), plus the
// ogc_tpu/ops/core.py::_fill_balls padding of the ball mode's output.
//
// Contract (pallas_knn.py:147-312, :1402-1510).  The points are padded to
// Mp = ceil(M / 1024) * 1024 with pad points at (1e6, 1e6, 1e6), split into
// Mp / blk runs of blk consecutive candidates, and each run keeps ONE
// winner.  d2 is the direct per-coordinate form ((dx*dx + dy*dy) + dz*dz),
// dx = p - q, pinned with __fmul_rn/__fadd_rn against FMA contraction.
//   KNN mode:  a run's winner is its minimum d2, ties to the lowest index;
//     its int32 key is (bits(d2) & ~mask_low) | idx, mask_low =
//     2^idx_bits - 1, idx_bits = max(1, bitlen(Mp - 1)).  Output: the k
//     smallest keys ascending, as idx = key & mask_low and the TRUNCATED
//     dist = sqrt(max(float(key & ~mask_low), 0)).
//   Ball mode: a run's key is its lowest index with d2 < r2, or none.
//     Valid keys rise with the run, so the output is the first ns valid run
//     winners in run order, filled as the reference fills a ball (slots past
//     the count repeat the first; an empty ball is all zeros).
//
// Design: one thread per query, a block of kThreads queries of one cloud;
// candidates stream through shared-memory tiles of 1024 points (Mp is a
// multiple of that, and blk divides it, so no run straddles two tiles).
// KNN: a running run winner in registers, and a sorted list of KCAP >= k
// int32 keys that takes a key only when it is below the current last entry
// (keys are unique: their low bits are the index), by an unrolled
// compare-and-swap pass.  Ball: a hit ends its run (the scan jumps to the
// next run), a thread stops at ns hits, and a block stops once all its
// threads have (__syncthreads_and).  No atomics: deterministic.
//
// Bound on the H100: operations.  The function needs every (query,
// candidate) pair of the KNN sweep, ~8 FP32 operations each (3 sub, 3 mul,
// 2 add; the run minimum's compare besides): 16 x 8192 x 8192 pairs of the
// smooth KNN are ~8.6 GFLOP, ~0.13 ms at 67 TFLOP/s.  Bytes are small (the
// cloud, 96 KB, is read once per query block from L2).  Every thread of a
// block reads the same shared-memory word (a broadcast), so the sweep runs
// at the FP32 pipe's rate; the insertions are rare by comparison (a query
// inserts ~k (1 + ln(G / k)) of its G run winners).  The ball mode stops
// early: a full ball needs only the candidates up to its ns-th valid run.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;
constexpr float kPad = 1e6f;

__device__ __forceinline__ float d2_rn(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Stage candidates [t0, t0 + kTile) of one cloud; indices >= M are pads.
__device__ __forceinline__ void load_tile(const float* __restrict__ p, int M,
                                          int t0, float* tx, float* ty,
                                          float* tz) {
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const int g = t0 + j;
    if (g < M) {
      const float* pj = p + (size_t)g * 3;
      tx[j] = pj[0];
      ty[j] = pj[1];
      tz[j] = pj[2];
    } else {
      tx[j] = kPad;
      ty[j] = kPad;
      tz[j] = kPad;
    }
  }
}

template <int KCAP>
__global__ void __launch_bounds__(kThreads)
    knn_blockmin_kernel(const float* __restrict__ query,
                        const float* __restrict__ points, int N, int M,
                        int Mp, int k, int blk, int idx_bits,
                        float* __restrict__ dist, int32_t* __restrict__ idx) {
  __shared__ float tx[kTile];
  __shared__ float ty[kTile];
  __shared__ float tz[kTile];

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
    load_tile(p, M, t0, tx, ty, tz);
    __syncthreads();
    if (!active) continue;
    for (int g0 = 0; g0 < kTile; g0 += blk) {
      float vmin = d2_rn(tx[g0] - qx, ty[g0] - qy, tz[g0] - qz);
      int amin = g0;
      for (int t = 1; t < blk; ++t) {
        const int j = g0 + t;
        const float d = d2_rn(tx[j] - qx, ty[j] - qy, tz[j] - qz);
        if (d < vmin) {  // strict: ties keep the lower index
          vmin = d;
          amin = j;
        }
      }
      int32_t key = (__float_as_int(vmin) & ~mask_low) | (t0 + amin);
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

__global__ void __launch_bounds__(kThreads)
    ball_blockmin_kernel(const float* __restrict__ points,
                         const float* __restrict__ centres, int N, int M,
                         int Np, int ns, int blk, float r2,
                         int32_t* __restrict__ idx) {
  __shared__ float tx[kTile];
  __shared__ float ty[kTile];
  __shared__ float tz[kTile];

  const int b = blockIdx.y;
  const int m = blockIdx.x * kThreads + threadIdx.x;
  const bool active = m < M;
  const float* c = centres + ((size_t)b * M + (active ? m : 0)) * 3;
  const float cx = c[0], cy = c[1], cz = c[2];
  const float* p = points + (size_t)b * N * 3;
  int32_t* out = idx + ((size_t)b * M + (active ? m : 0)) * ns;

  int cnt = 0;
  int first = 0;
  for (int t0 = 0; t0 < Np; t0 += kTile) {
    // Also the barrier that keeps the previous tile alive until every
    // thread is done with it.
    if (__syncthreads_and(!active || cnt >= ns)) break;
    load_tile(p, N, t0, tx, ty, tz);
    __syncthreads();
    if (!active || cnt >= ns) continue;
    for (int j = 0; j < kTile;) {
      if (d2_rn(tx[j] - cx, ty[j] - cy, tz[j] - cz) < r2) {
        if (cnt == 0) first = t0 + j;
        out[cnt] = t0 + j;
        if (++cnt == ns) break;
        j = (j | (blk - 1)) + 1;  // the run has its winner: next run
      } else {
        ++j;
      }
    }
  }
  if (!active) return;
  for (int s = cnt; s < ns; ++s) out[s] = first;
}

template <int KCAP>
cudaError_t launch_knn(const float* q, const float* p, int B, int N, int M,
                       int Mp, int k, int blk, int idx_bits, float* d,
                       int32_t* i, cudaStream_t stream) {
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  knn_blockmin_kernel<KCAP><<<grid, kThreads, 0, stream>>>(
      q, p, N, M, Mp, k, blk, idx_bits, d, i);
  return cudaGetLastError();
}

bool valid_blk(int blk, int Mp) {
  return blk >= 1 && blk <= kTile && (blk & (blk - 1)) == 0 &&
         Mp % kTile == 0;
}

}  // namespace

// query (B, N, 3), points (B, M, 3) f32 contiguous; dist (B, N, k) f32 and
// idx (B, N, k) int32.  Mp = ceil(M / 1024) * 1024, blk a power of two,
// idx_bits = max(1, bitlen(Mp - 1)), 1 <= k <= 64 and ceil(M / blk) >= k.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int ogc_knn_blockmin(const void* query, const void* points, int B,
                                int N, int M, int Mp, int k, int blk,
                                int idx_bits, void* dist, void* idx,
                                void* stream) {
  if (!valid_blk(blk, Mp) || k < 1 || (M + blk - 1) / blk < k)
    return (int)cudaErrorInvalidValue;
  const float* q = (const float*)query;
  const float* p = (const float*)points;
  float* d = (float*)dist;
  int32_t* i = (int32_t*)idx;
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 4) return (int)launch_knn<4>(q, p, B, N, M, Mp, k, blk, idx_bits, d, i, s);
  if (k <= 8) return (int)launch_knn<8>(q, p, B, N, M, Mp, k, blk, idx_bits, d, i, s);
  if (k <= 16) return (int)launch_knn<16>(q, p, B, N, M, Mp, k, blk, idx_bits, d, i, s);
  if (k <= 32) return (int)launch_knn<32>(q, p, B, N, M, Mp, k, blk, idx_bits, d, i, s);
  if (k <= 64) return (int)launch_knn<64>(q, p, B, N, M, Mp, k, blk, idx_bits, d, i, s);
  return (int)cudaErrorInvalidValue;
}

// points (B, N, 3), centres (B, M, 3) f32 contiguous; idx (B, M, ns) int32,
// the filled balls.  Np = ceil(N / 1024) * 1024, blk a power of two,
// ns >= 1.  Launches on `stream` and returns cudaGetLastError().
extern "C" int ogc_ball_blockmin(const void* points, const void* centres,
                                 int B, int N, int M, int Np, int ns, int blk,
                                 float r2, void* idx, void* stream) {
  if (!valid_blk(blk, Np) || ns < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + kThreads - 1) / kThreads, B);
  ball_blockmin_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)points, (const float*)centres, N, M, Np, ns, blk, r2,
      (int32_t*)idx);
  return (int)cudaGetLastError();
}
