// Bound-pruned exact k-nearest neighbours on Hopper.
//
// Replaces the Pallas TPU kernel ogc_tpu/ops/pallas_knn.py::
// _knn_exact_pruned_kernel (entry points _exact_pruned_pallas /
// knn_exact_pruned).
//
// Contract (the kernel's part): Morton-sorted queries q_s (B, Np, 3) in
// tiles of qt, Morton-sorted points p_s (B, Mp, 3) in blocks of cb with
// their original ids pid (B, Mp) (pad points at 1e6 with id 2^30), and per
// tile the surviving blocks `order` (B, nbq, nbp), survivors first, and
// their number `count` (B, nbq) ->
//   dist (B, Np, k) f32 = sqrt(max(d2, 0)), idx (B, Np, k) int32 original
// ids: the k smallest (d2, id) pairs over the tile's surviving blocks,
// ascending.  The prologue in ops/knn_pruned.py proves that every pruned
// block lies strictly beyond each query's k-th neighbour, so this is #2's
// answer (csrc/knn_exact.cu): ascending d2, ties to the lower index, d2 in
// the direct per-coordinate form ((dx*dx + dy*dy) + dz*dz), dx = p - q,
// pinned with __fmul_rn / __fadd_rn.
//
// Design: one CTA per (query tile, cloud), one thread per query.  The CTA
// streams its tile's `count` survivor blocks through shared memory (cb
// points and ids each); every thread keeps its query's sorted (d2, id)
// list of KCAP >= k entries in registers.  Blocks arrive in ascending
// lower-bound order, not in index order, so the order of insertion must
// not matter: both the admission test and the insertion compare (d2, id)
// lexicographically, and the list is the k smallest pairs whatever the
// order.  The TPU kernel's compaction of survivors into VMEM scratch and
// its k rounds of masked-min extraction are not needed: a thread inserts as
// it goes.
//
// Bound on the H100: ~9 FP32 operations per (query, surviving candidate)
// pair, plus the insertions (k-step compare-and-swap passes), so the
// distance work is the survivor share of #2's.  The insertions, not the
// distances, set the time: a query inserts ~k (1 + ln(n / k)) of its n
// candidates whatever their order, and a warp runs the k-step pass when
// any of its 32 queries inserts.  So the kernel takes about #2's time at
// survivor shares of 0.5-0.8, and skipping blocks by the tile's or each
// query's current k-th distance (both exact) did not change it on the
// H100 (PERF.md).  A cheaper selection (a warp-cooperative merge) is the
// next design, as for #2.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxCb = 128;

__device__ __forceinline__ float d2_rn(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

template <int KCAP>
__global__ void knn_exact_pruned_kernel(
    const float* __restrict__ qs, const float* __restrict__ ps,
    const int32_t* __restrict__ pid, const int32_t* __restrict__ order,
    const int32_t* __restrict__ count, int Np, int Mp, int nbq, int nbp,
    int k, int cb, float* __restrict__ dist, int32_t* __restrict__ idx) {
  __shared__ float tx[kMaxCb];
  __shared__ float ty[kMaxCb];
  __shared__ float tz[kMaxCb];
  __shared__ int32_t ti[kMaxCb];

  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int n = tile * blockDim.x + threadIdx.x;  // Np is a multiple of qt
  const float* q = qs + ((size_t)b * Np + n) * 3;
  const float qx = q[0], qy = q[1], qz = q[2];
  const float* p = ps + (size_t)b * Mp * 3;
  const int32_t* id = pid + (size_t)b * Mp;
  const int32_t* ord = order + ((size_t)b * nbq + tile) * nbp;
  const int cnt = count[(size_t)b * nbq + tile];

  float bd[KCAP];
  int bi[KCAP];
#pragma unroll
  for (int i = 0; i < KCAP; ++i) {
    bd[i] = INFINITY;
    bi[i] = 0x7fffffff;
  }

  for (int j = 0; j < cnt; ++j) {
    const int base = ord[j] * cb;
    __syncthreads();
    for (int t = threadIdx.x; t < cb; t += blockDim.x) {
      const float* pt = p + (size_t)(base + t) * 3;
      tx[t] = pt[0];
      ty[t] = pt[1];
      tz[t] = pt[2];
      ti[t] = id[base + t];
    }
    __syncthreads();
    for (int t = 0; t < cb; ++t) {
      float cd = d2_rn(tx[t] - qx, ty[t] - qy, tz[t] - qz);
      int ci = ti[t];
      if (cd < bd[KCAP - 1] || (cd == bd[KCAP - 1] && ci < bi[KCAP - 1])) {
#pragma unroll
        for (int i = 0; i < KCAP; ++i) {
          const bool swap = cd < bd[i] || (cd == bd[i] && ci < bi[i]);
          const float td = bd[i];
          const int tj = bi[i];
          bd[i] = swap ? cd : td;
          bi[i] = swap ? ci : tj;
          cd = swap ? td : cd;
          ci = swap ? tj : ci;
        }
      }
    }
  }
  float* od = dist + ((size_t)b * Np + n) * k;
  int32_t* oi = idx + ((size_t)b * Np + n) * k;
#pragma unroll
  for (int i = 0; i < KCAP; ++i) {
    if (i < k) {
      od[i] = sqrtf(fmaxf(bd[i], 0.0f));
      oi[i] = bi[i];
    }
  }
}

template <int KCAP>
cudaError_t launch(const float* qs, const float* ps, const int32_t* pid,
                   const int32_t* order, const int32_t* count, int B, int Np,
                   int Mp, int nbq, int nbp, int k, int cb, int qt, float* d,
                   int32_t* i, cudaStream_t stream) {
  const dim3 grid(nbq, B);
  knn_exact_pruned_kernel<KCAP><<<grid, qt, 0, stream>>>(
      qs, ps, pid, order, count, Np, Mp, nbq, nbp, k, cb, d, i);
  return cudaGetLastError();
}

}  // namespace

// qs (B, Np, 3) and ps (B, Mp, 3) f32, pid (B, Mp) int32, order (B, nbq,
// nbp) int32 and count (B, nbq) int32, all contiguous; Np = nbq * qt,
// Mp = nbp * cb;
// dist (B, Np, k) f32 and idx (B, Np, k) int32.  Requires 1 <= k <= 64,
// 1 <= cb <= 128 and 32 <= qt <= 1024.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int ogc_knn_exact_pruned(const void* qs, const void* ps,
                                    const void* pid, const void* order,
                                    const void* count, int B, int Np, int Mp,
                                    int nbq, int nbp, int k, int cb, int qt,
                                    void* dist, void* idx, void* stream) {
  if (cb < 1 || cb > kMaxCb || qt < 32 || qt > 1024 || Np != nbq * qt ||
      Mp != nbp * cb)
    return (int)cudaErrorInvalidValue;
  const float* q = (const float*)qs;
  const float* p = (const float*)ps;
  const int32_t* pi = (const int32_t*)pid;
  const int32_t* o = (const int32_t*)order;
  const int32_t* c = (const int32_t*)count;
  float* d = (float*)dist;
  int32_t* i = (int32_t*)idx;
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 4) return (int)launch<4>(q, p, pi, o, c, B, Np, Mp, nbq, nbp, k, cb, qt, d, i, s);
  if (k <= 8) return (int)launch<8>(q, p, pi, o, c, B, Np, Mp, nbq, nbp, k, cb, qt, d, i, s);
  if (k <= 16) return (int)launch<16>(q, p, pi, o, c, B, Np, Mp, nbq, nbp, k, cb, qt, d, i, s);
  if (k <= 32) return (int)launch<32>(q, p, pi, o, c, B, Np, Mp, nbq, nbp, k, cb, qt, d, i, s);
  if (k <= 64) return (int)launch<64>(q, p, pi, o, c, B, Np, Mp, nbq, nbp, k, cb, qt, d, i, s);
  return (int)cudaErrorInvalidValue;
}
