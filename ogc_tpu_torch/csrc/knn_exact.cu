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
//
// Design: one thread per query.  Candidates stream in ascending index order
// through shared-memory tiles; each thread keeps a sorted (d2, idx) list of
// KCAP >= k entries and inserts a candidate only when it is strictly below
// the current last entry.  A later candidate with an equal d2 has a higher
// index, so strict `<` gives the lower-index tie rule for free (the
// reference's own insertion, pointnet2/src/interpolate_gpu.cu:30-46).  The
// insertion is a fully unrolled lexicographic compare-and-swap pass, so the
// list stays in registers for small KCAP.  The TPU kernel's padding of M to
// 1024 is not needed: a GPU tile has no shape constraint.
//
// Bound on the H100: ~8 FP32 operations per (query, candidate) pair, with
// every thread of a block reading the same shared-memory word (a broadcast),
// plus the insertions.  At k = 64 the insertions dominate: a query of the
// 2048 x 8192 eval call inserts about k * (1 + ln(M / k)) = 375 of its 8192
// candidates, each a 64-step compare-and-swap pass, and a warp runs that
// pass whenever any of its 32 queries inserts, i.e. on most candidates.
// With only 16,384 queries (~4 warps per SM) there is little occupancy to
// hide it.  A warp-cooperative selection (per-thread queues merged across
// the warp) is the next design; at k = 3 the kernel is bound by the
// distance loop.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;

__device__ __forceinline__ float d2_rn(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

template <int KCAP>
__global__ void __launch_bounds__(kThreads)
    knn_exact_kernel(const float* __restrict__ query,
                     const float* __restrict__ points, int N, int M, int k,
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
    for (int j = threadIdx.x; j < cnt; j += kThreads) {
      const float* pj = p + (size_t)(t0 + j) * 3;
      tx[j] = pj[0];
      ty[j] = pj[1];
      tz[j] = pj[2];
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < cnt; ++j) {
      float cd = d2_rn(tx[j] - qx, ty[j] - qy, tz[j] - qz);
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

template <int KCAP>
cudaError_t launch(const float* q, const float* p, int B, int N, int M, int k,
                   float* d, int32_t* i, cudaStream_t stream) {
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  knn_exact_kernel<KCAP><<<grid, kThreads, 0, stream>>>(q, p, N, M, k, d, i);
  return cudaGetLastError();
}

}  // namespace

// query (B, N, 3), points (B, M, 3) f32 contiguous; dist (B, N, k) f32 and
// idx (B, N, k) int32.  Requires 1 <= k <= min(M, 64).  Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int ogc_knn_exact(const void* query, const void* points, int B,
                             int N, int M, int k, void* dist, void* idx,
                             void* stream) {
  const float* q = (const float*)query;
  const float* p = (const float*)points;
  float* d = (float*)dist;
  int32_t* i = (int32_t*)idx;
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 4) return (int)launch<4>(q, p, B, N, M, k, d, i, s);
  if (k <= 8) return (int)launch<8>(q, p, B, N, M, k, d, i, s);
  if (k <= 16) return (int)launch<16>(q, p, B, N, M, k, d, i, s);
  if (k <= 32) return (int)launch<32>(q, p, B, N, M, k, d, i, s);
  if (k <= 64) return (int)launch<64>(q, p, B, N, M, k, d, i, s);
  return (int)cudaErrorInvalidValue;
}
