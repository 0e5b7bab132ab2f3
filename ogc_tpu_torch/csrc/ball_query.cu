// Exact ball query on Hopper.
//
// Replaces the Pallas TPU kernel ogc_tpu/ops/pallas_knn.py::
// _ball_exact_pruned_kernel (entry point ball_query_exact_pruned), and the
// exact-ball mode of ::_knn_kernel (ball_query_exact, blk=1); both have this
// contract, and ogc_tpu/ops/core.py::_fill_balls completes it.
//
// Contract: points (B, N, 3), centres (B, M, 3) f32 -> idx (B, M, ns) int32,
// the filled ball of every centre: the ns LOWEST indices j with
// d2(j) < r2 (strict), in ascending order; an under-full ball repeats its
// first index in the remaining slots; an empty ball is all zeros
// (reference pointnet2/src/ball_query_gpu.cu:9-45).  d2 is the direct
// per-coordinate form ((dx*dx + dy*dy) + dz*dz), dx = p - c, pinned with
// __fmul_rn/__fadd_rn against FMA contraction (pallas_knn.py:856-859).
//
// Design: one thread per centre.  Points stream in ascending index order
// through shared-memory tiles, so a thread's hits arrive already sorted:
// each hit is written straight to its slot and no selection is needed (the
// TPU kernel's Morton sort, AABB pruning and ns masked-min extractions
// rebuild that order after visiting blocks out of order).  Once every
// centre of the block holds ns hits the block stops (__syncthreads_and):
// the remaining indices are all higher, so none of them can enter -- exact.
//
// Bound on the H100: ~8 FP32 operations per (centre, point) pair scanned,
// with every thread of a block reading the same shared-memory word (a
// broadcast).  At the smooth loss's shape (8192 centres x 8192 points,
// ns 64, r 2) most balls hold fewer than 64 points, so most threads scan
// all N points and the early stop rarely fires: the work is the full
// N x M distance sweep.  Bytes are small (the 8 MB output).  The hit writes
// are uncoalesced (each thread its own row), but a thread writes at most
// ns of them.  The function itself needs far less than this sweep: a search
// pruned by spatial cells tests only the points near each centre, so its
// bound is the bytes (~2.7 us per call at that shape), and this design runs
// at ~200x it; cell or Morton tiling that keeps the ascending-index order
// is the next design.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;

__device__ __forceinline__ float d2_rn(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__global__ void __launch_bounds__(kThreads)
    ball_query_kernel(const float* __restrict__ points,
                      const float* __restrict__ centres, int N, int M, int ns,
                      float r2, int32_t* __restrict__ idx) {
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
  for (int t0 = 0; t0 < N; t0 += kTile) {
    // Also the barrier that keeps the previous tile alive until every
    // thread is done with it.
    if (__syncthreads_and(!active || cnt >= ns)) break;
    const int len = min(kTile, N - t0);
    for (int j = threadIdx.x; j < len; j += kThreads) {
      const float* pj = p + (size_t)(t0 + j) * 3;
      tx[j] = pj[0];
      ty[j] = pj[1];
      tz[j] = pj[2];
    }
    __syncthreads();
    if (!active || cnt >= ns) continue;
    for (int j = 0; j < len; ++j) {
      const float d2 = d2_rn(tx[j] - cx, ty[j] - cy, tz[j] - cz);
      if (d2 < r2) {
        if (cnt == 0) first = t0 + j;
        out[cnt] = t0 + j;
        if (++cnt == ns) break;
      }
    }
  }
  if (!active) return;
  // Fill: repeat the first hit; an empty ball stays all zeros (first = 0).
  for (int s = cnt; s < ns; ++s) out[s] = first;
}

}  // namespace

// points (B, N, 3), centres (B, M, 3) f32 contiguous; idx (B, M, ns) int32.
// Requires ns >= 1.  Launches on `stream` and returns cudaGetLastError()
// (0 on success).
extern "C" int ogc_ball_query(const void* points, const void* centres, int B,
                              int N, int M, int ns, float r2, void* idx,
                              void* stream) {
  if (ns < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + kThreads - 1) / kThreads, B);
  ball_query_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)points, (const float*)centres, N, M, ns, r2,
      (int32_t*)idx);
  return (int)cudaGetLastError();
}
