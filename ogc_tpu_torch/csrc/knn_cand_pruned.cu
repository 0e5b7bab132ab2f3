// Candidate-pruned approximate KNN on Hopper.
//
// Replaces the Pallas TPU kernel ogc_tpu/ops/pallas_knn.py::
// _knn_pruned_kernel (#6, via _knn_pruned_pallas and the entry point
// knn_pruned).
//
// Contract (pallas_knn.py:1164-1237).  Both clouds are Morton-sorted by the
// wrapper (ops/knn_cand.py), the points padded to whole blocks of cb with
// pad points at 1e6 and pad id mask_low = 2^idx_bits - 1, idx_bits =
// max(1, bitlen(mp - 1)).  Each query tile of qt sorted queries has its
// n_cand candidate blocks (a multiple of blk), taken in chunks of blk
// blocks.  At each within-block position r the chunk keeps ONE winner: the
// minimum (d2, original id) over its blk blocks, ties to the lower id (the
// thinning groups distant blocks, not neighbouring points).  d2 is the
// direct form ((dx*dx + dy*dy) + dz*dz), dx = p - q, pinned with
// __fmul_rn/__fadd_rn.  A winner's int32 key is (bits(d2) & ~mask_low) | id.
// Output: the k smallest DISTINCT keys ascending (pads share one key), as
// idx = key & mask_low and the truncated dist = sqrt(max(d2, 0)), in sorted
// query order; the wrapper un-sorts the rows.
//
// Design: one CTA per (cloud, query tile), one thread per query, as #4
// (knn_exact_pruned.cu).  Each chunk's blk x cb points and ids are staged in
// shared memory; every thread reads the same word (a broadcast).  A thread
// keeps a sorted register list of KCAP >= k keys and takes a key only when
// it is below the last entry and not already listed, by an unrolled
// compare-and-swap pass, as #3 (knn_blockmin.cu).  No atomics:
// deterministic.
//
// Bound on the H100: operations.  The function needs each query against its
// tile's n_cand x cb candidates, ~8 FP32 operations each (3 sub, 3 mul,
// 2 add), plus the thinning compares: at B = 8, 4096 queries, 32 blocks of
// 128, ~1.1 GFLOP, ~0.016 ms at 67 TFLOP/s.  The insertions, a k-step pass
// each, run ~k (1 + ln(G / k)) times per query over its G = n_cand x cb /
// blk keys, and the warp runs each of its lanes' passes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float d2_rn(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

template <int KCAP>
__global__ void __launch_bounds__(kMaxThreads)
    knn_cand_kernel(const float* __restrict__ q_s,
                    const float* __restrict__ p_s,
                    const int32_t* __restrict__ pid,
                    const int32_t* __restrict__ cand, int np, int mp,
                    int n_cand, int k, int blk, int cb, int idx_bits,
                    float* __restrict__ dist, int32_t* __restrict__ idx) {
  extern __shared__ uint4 smem[];
  const int stage = blk * cb;
  float* sx = reinterpret_cast<float*>(smem);
  float* sy = sx + stage;
  float* sz = sy + stage;
  int32_t* sid = reinterpret_cast<int32_t*>(sz + stage);

  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int n = tile * blockDim.x + threadIdx.x;  // np is a multiple of qt
  const float* q = q_s + ((int64_t)b * np + n) * 3;
  const float qx = q[0], qy = q[1], qz = q[2];
  const float* p = p_s + (int64_t)b * mp * 3;
  const int32_t* ids = pid + (int64_t)b * mp;
  const int32_t* c_t = cand + ((int64_t)b * gridDim.x + tile) * n_cand;
  const int32_t mask_low = (int32_t)((1u << idx_bits) - 1u);

  int32_t keys[KCAP];
#pragma unroll
  for (int i = 0; i < KCAP; ++i) keys[i] = 0x7fffffff;

  for (int c0 = 0; c0 < n_cand; c0 += blk) {
    __syncthreads();  // the previous chunk is consumed
    for (int u = threadIdx.x; u < stage; u += blockDim.x) {
      const int i = u / cb;
      const int row = c_t[c0 + i] * cb + (u - i * cb);
      sx[u] = p[(int64_t)row * 3];
      sy[u] = p[(int64_t)row * 3 + 1];
      sz[u] = p[(int64_t)row * 3 + 2];
      sid[u] = ids[row];
    }
    __syncthreads();
    for (int r = 0; r < cb; ++r) {
      float vmin = d2_rn(sx[r] - qx, sy[r] - qy, sz[r] - qz);
      int32_t amin = sid[r];
      for (int i = 1; i < blk; ++i) {
        const int u = i * cb + r;
        const float d = d2_rn(sx[u] - qx, sy[u] - qy, sz[u] - qz);
        const int32_t id = sid[u];
        if (d < vmin || (d == vmin && id < amin)) {
          vmin = d;
          amin = id;
        }
      }
      int32_t key = (__float_as_int(vmin) & ~mask_low) | amin;
      if (key < keys[KCAP - 1]) {
        bool listed = false;
#pragma unroll
        for (int i = 0; i < KCAP; ++i) listed |= keys[i] == key;
        if (!listed) {
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
  }
  float* od = dist + ((int64_t)b * np + n) * k;
  int32_t* oi = idx + ((int64_t)b * np + n) * k;
#pragma unroll
  for (int i = 0; i < KCAP; ++i) {
    if (i < k) {
      oi[i] = keys[i] & mask_low;
      const float d2 = __int_as_float(keys[i] & ~mask_low);
      // max(d2, 0) that keeps a NaN, as torch.clamp and jnp.maximum do.
      od[i] = sqrtf(d2 < 0.0f ? 0.0f : d2);
    }
  }
}

template <int KCAP>
cudaError_t launch(const float* q, const float* p, const int32_t* pid,
                   const int32_t* cand, int B, int np, int mp, int n_cand,
                   int k, int blk, int cb, int qt, int idx_bits, float* d,
                   int32_t* i, cudaStream_t stream) {
  const dim3 grid(np / qt, B);
  const size_t smem = (size_t)blk * cb * 16;
  knn_cand_kernel<KCAP><<<grid, qt, smem, stream>>>(
      q, p, pid, cand, np, mp, n_cand, k, blk, cb, idx_bits, d, i);
  return cudaGetLastError();
}

}  // namespace

// q_s (B, np, 3), p_s (B, mp, 3) f32, pid (B, mp) int32, cand (B, np / qt,
// n_cand) int32 block ids in [0, mp / cb); dist (B, np, k) f32 and idx
// (B, np, k) int32.  Requires np a multiple of qt, 32 <= qt <= 256 a
// multiple of 32, 1 <= cb <= 128 with mp a multiple of cb, n_cand a multiple
// of blk, blk * cb * 16 <= 48 KiB, 1 <= k <= 64.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int ogc_knn_cand(const void* q_s, const void* p_s, const void* pid,
                            const void* cand, int B, int np, int mp,
                            int n_cand, int k, int blk, int cb, int qt,
                            int idx_bits, void* dist, void* idx,
                            void* stream) {
  if (B < 1 || qt < 32 || qt > kMaxThreads || qt % 32 || np % qt ||
      cb < 1 || cb > 128 || mp % cb || blk < 1 || n_cand % blk ||
      blk * cb * 16 > 49152 || k < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const float* q = (const float*)q_s;
  const float* p = (const float*)p_s;
  const int32_t* id = (const int32_t*)pid;
  const int32_t* c = (const int32_t*)cand;
  float* d = (float*)dist;
  int32_t* i = (int32_t*)idx;
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 4) return (int)launch<4>(q, p, id, c, B, np, mp, n_cand, k, blk, cb, qt, idx_bits, d, i, s);
  if (k <= 8) return (int)launch<8>(q, p, id, c, B, np, mp, n_cand, k, blk, cb, qt, idx_bits, d, i, s);
  if (k <= 16) return (int)launch<16>(q, p, id, c, B, np, mp, n_cand, k, blk, cb, qt, idx_bits, d, i, s);
  if (k <= 32) return (int)launch<32>(q, p, id, c, B, np, mp, n_cand, k, blk, cb, qt, idx_bits, d, i, s);
  if (k <= 64) return (int)launch<64>(q, p, id, c, B, np, mp, n_cand, k, blk, cb, qt, idx_bits, d, i, s);
  return (int)cudaErrorInvalidValue;
}
