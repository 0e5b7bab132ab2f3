// Device helpers of the pruned neighbour searches #4 (knn_exact_pruned.cu)
// and #6 (knn_cand_pruned.cu) and of their fused prologue
// (pruned_prologue.cu): the 30-bit Morton code, the box lower bounds, the
// staging of a tile's chosen point blocks (#6), and the nearest-first order
// in which a warp walks its blocks (#4).
//
// The prologue sorts both clouds by Morton code and cuts the sorted points
// into blocks of cb rows and the sorted queries into tiles of qt rows; a
// box is (lo x, y, z, hi x, y, z) over a block's or tile's rows.  Every
// expression is pinned (__fsub_rn, __fdiv_rn, __fmul_rn, __fadd_rn) to the
// torch form of ops/knn_pruned.py and ops/knn_cand.py, so that no
// contraction moves a code or a bound.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "neighbors.cuh"

namespace ogc {

// Spread the low 10 bits of v to every 3rd bit.
__device__ __forceinline__ uint32_t expand_bits10(uint32_t v) {
  v &= 0x3FFu;
  v = (v | (v << 16)) & 0x030000FFu;
  v = (v | (v << 8)) & 0x0300F00Fu;
  v = (v | (v << 4)) & 0x030C30C3u;
  v = (v | (v << 2)) & 0x09249249u;
  return v;
}

// One coordinate quantized to the cloud's box: (x - lo) / ext * 1023,
// clamped to [0, 1023], truncated (ext = max(hi - lo, 1e-6)).
__device__ __forceinline__ uint32_t quantize10(float x, float lo, float ext) {
  const float u = __fmul_rn(__fdiv_rn(__fsub_rn(x, lo), ext), 1023.0f);
  return (uint32_t)__float2int_rz(fminf(fmaxf(u, 0.0f), 1023.0f));
}

__device__ __forceinline__ uint32_t morton30(float x, float y, float z,
                                             const float (&lo)[3],
                                             const float (&ext)[3]) {
  return (expand_bits10(quantize10(x, lo[0], ext[0])) << 2) |
         (expand_bits10(quantize10(y, lo[1], ext[1])) << 1) |
         expand_bits10(quantize10(z, lo[2], ext[2]));
}

// The exact lower bound of d2 between a query tile's box q and a point
// block's box p: per axis gap = max(q.lo - p.hi, p.lo - q.hi, 0), then
// (gx^2 + gy^2) + gz^2.  Each rounding is monotone, so no rounded d2 of a
// pair in the two boxes is below it.
__device__ __forceinline__ float box_lb2(const float* q, const float* p) {
  float g2[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float gap = fmaxf(fmaxf(__fsub_rn(q[c], p[3 + c]),
                                  __fsub_rn(p[c], q[3 + c])), 0.0f);
    g2[c] = __fmul_rn(gap, gap);
  }
  return __fadd_rn(__fadd_rn(g2[0], g2[1]), g2[2]);
}

// The exact lower bound of d2 between the query (x, y, z) and the points
// of a block with box p, as box_lb2 for a tile of one query.
__device__ __forceinline__ float point_lb2(float x, float y, float z,
                                           const float* p) {
  const float q[6] = {x, y, z, x, y, z};
  return box_lb2(q, p);
}

// The squared distance of the doubled box centres: ((q.lo + q.hi) -
// (p.lo + p.hi))^2 summed as (x + y) + z.
__device__ __forceinline__ float box_c2c(const float* q, const float* p) {
  float d2[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float d = __fsub_rn(__fadd_rn(q[c], q[3 + c]),
                              __fadd_rn(p[c], p[3 + c]));
    d2[c] = __fmul_rn(d, d);
  }
  return __fadd_rn(__fadd_rn(d2[0], d2[1]), d2[2]);
}

// Stage `nb` chosen blocks of one cloud's sorted points p4, blocks[0..nb),
// as (x, y, z, w) entries: entry j * cb + r is row blocks[j] * cb + r, w
// its original id's bits with the sign bit set on a pad row (row >= M).
// Called by the whole CTA; the caller syncs before and after.
__device__ __forceinline__ void stage_blocks(float4* stage,
                                             const int32_t* blocks, int nb,
                                             int cb,
                                             const float4* __restrict__ p4,
                                             int M) {
  for (int e = threadIdx.x; e < nb * cb; e += blockDim.x) {
    const int j = e / cb;
    const int row = blocks[j] * cb + (e - j * cb);
    float4 v = p4[row];
    if (row >= M) v.w = __uint_as_float(__float_as_uint(v.w) | 0x80000000u);
    stage[e] = v;
  }
}

// The order in which a warp walks up to 64 listed blocks,
// nearest first: lane l gives item l's and item l + 32's lower bound
// (bound(i) >= +0.0, for i < n), and x becomes the sorted unique keys
// bits(bound) << 32 | i, element e in x[e >> 5] of lane e & 31
// (neighbors.cuh's network); items >= n sort last.  Called by the whole
// warp.
template <typename Bound>
__device__ __forceinline__ void nearest_first(unsigned long long (&x)[2],
                                              int n, Bound bound, int lane) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int i = lane + 32 * t;
    x[t] = i < n ? (unsigned long long)__float_as_uint(bound(i)) << 32 | i
                 : ~0ull;
  }
  bitonic_sort64(x, lane);
}

// Element e of nearest_first's order: (the item's bound, the item).
__device__ __forceinline__ int2 nth_nearest(const unsigned long long (&x)[2],
                                            int e) {
  const unsigned long long v =
      __shfl_sync(0xffffffffu, e < 32 ? x[0] : x[1], e & 31);
  return make_int2((int)(v >> 32), (int)(v & 0xffffffffu));
}

}  // namespace ogc
