// Device helpers of the deterministic scatter-adds: the CSR build of #11
// (scatter_add.cu) and the per-block stable partitions of #8 (onehot.cu)
// and #10 (onehot_bs.cu).
//
// Every counter and every position has exactly one writing thread, so no
// result depends on the order in which threads run: a warp walks its rows
// 32 at a time, lanes with the same key find each other with
// __match_any_sync, the lowest of them adds the group's size to the warp's
// own histogram, and a lane's rank among the earlier lanes of its group
// (popc) places it.  Warps, steps and lanes are taken in ascending row
// order, so the partition is stable.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ogc {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFullMask, v, off);
    if (lane >= off) v += o;
  }
  return v;
}

// out[i] = carry + a[0] + ... + a[i-1] for i < n, by one whole warp;
// returns carry + the sum of a.
__device__ __forceinline__ int warp_exclusive_scan(const int32_t* a, int n,
                                                   int carry, int32_t* out) {
  const int lane = threadIdx.x & 31;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    const int v = i < n ? a[i] : 0;
    const int incl = warp_inclusive_scan(v);
    if (i < n) out[i] = carry + incl - v;
    carry += __shfl_sync(kFullMask, incl, 31);
  }
  return carry;
}

// One warp walks rows [r0, r1) 32 at a time in ascending r; for every lane
// of a step it calls f(in, r, d, rank, len): d = key(r), `in` if d >= 0,
// `rank` the number of this step's rows with key d and a lower r, and `len`
// the step's rows with key d at the group's first lane (0 at the others),
// the groups found by __match_any_sync.  key(r) is called for r < r1 only
// and returns the row's key, or -1 for a row to skip.  Every lane calls f,
// then the warp syncs.  The keys of kWalkAhead steps are loaded, and their
// groups matched, before the first f: neither a load nor a match a step
// then puts its latency into every step.  (Finding the groups by a ballot
// per key bit instead of the match measured slower, even for 32 keys.)
constexpr int kWalkAhead = 8;

template <typename Key, typename F>
__device__ __forceinline__ void warp_walk(int r0, int r1, Key key, F f) {
  const int lane = threadIdx.x & 31;
  const unsigned below = lanemask_lt();
  for (int rb = r0; rb < r1; rb += 32 * kWalkAhead) {
    int d[kWalkAhead];
    unsigned group[kWalkAhead];
#pragma unroll
    for (int u = 0; u < kWalkAhead; ++u) {
      const int r = rb + 32 * u + lane;
      const int v = key(min(r, r1 - 1));
      d[u] = r < r1 ? v : -1;
    }
#pragma unroll
    for (int u = 0; u < kWalkAhead; ++u) {
      group[u] = __match_any_sync(kFullMask, (unsigned)d[u]);
    }
#pragma unroll
    for (int u = 0; u < kWalkAhead; ++u) {
      if (rb + 32 * u >= r1) break;
      const bool in = d[u] >= 0;
      const bool first = in && (group[u] & below) == 0;
      f(in, rb + 32 * u + lane, d[u], __popc(group[u] & below),
        first ? __popc(group[u]) : 0);
      __syncwarp();
    }
  }
}

// The W warps' counts hist[w * ws + d] (d < n) become positions, by the
// whole block: hist[w * ws + d] = start[d] + the counts of warps before w
// at d, and start[d] = the counts of every warp at keys below d; start[n]
// is the total.  A thread takes a run of consecutive keys; the runs' sums
// are scanned across the block (wsum: one int per warp of the block).
// Ends with a barrier.
template <int W>
__device__ __forceinline__ void counts_to_positions(uint16_t* hist, int ws,
                                                    int n, int32_t* start,
                                                    int32_t* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int K = (n + blockDim.x - 1) / blockDim.x;
  const int d0 = min(n, (int)threadIdx.x * K), d1 = min(n, d0 + K);
  int run = 0;
  for (int d = d0; d < d1; ++d) {
#pragma unroll
    for (int w = 0; w < W; ++w) run += hist[w * ws + d];
  }
  const int incl = warp_inclusive_scan(run);
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int before = incl - run;
  for (int w = 0; w < warp; ++w) before += wsum[w];
  for (int d = d0; d < d1; ++d) {
    start[d] = before;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int x = hist[w * ws + d];
      hist[w * ws + d] = (uint16_t)before;
      before += x;
    }
  }
  if (threadIdx.x == blockDim.x - 1) start[n] = before;
  __syncthreads();
}

// A stable counting sort of items [0, len) by key(t) in [0, n) (-1: the
// item is left out), by a block of W warps: warp w takes a contiguous
// slice of whole steps, counts it (warp_walk) into its 16-bit histogram
// (hist: W x ws, ws even and >= n), the counts become positions
// (counts_to_positions: start[0..n]), and a second walk calls put(pos, t)
// once for every kept item, pos its place in (key, t) order.  len <= 65535.
// Called by every thread of the block after the keys are readable; ends
// with a barrier.
template <int W, typename Key, typename Put>
__device__ __forceinline__ void stable_partition(int len, int n, Key key,
                                                 uint16_t* hist, int ws,
                                                 int32_t* start,
                                                 int32_t* wsum, Put put) {
  for (int i = threadIdx.x; i < W * ws / 2; i += blockDim.x) {
    reinterpret_cast<uint32_t*>(hist)[i] = 0u;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int sub = (len + 32 * W - 1) / (32 * W) * 32;
  const int r0 = min(len, warp * sub), r1 = min(len, r0 + sub);
  uint16_t* h = hist + warp * ws;
  warp_walk(r0, r1, key, [&](bool, int, int d, int, int cnt) {
    if (cnt) h[d] += cnt;
  });
  __syncthreads();
  counts_to_positions<W>(hist, ws, n, start, wsum);
  warp_walk(r0, r1, key, [&](bool in, int t, int d, int rank, int cnt) {
    const int pos = in ? h[d] + rank : 0;
    __syncwarp();
    if (cnt) h[d] += cnt;
    if (in) put(pos, t);
  });
  __syncthreads();
}

// Thread t of the block adds, for each of its (row, channel) pairs
// p = t + k * blockDim.x < pairs (k < P; row p / C, channel p % C), the
// values g[src(s) * C + channel] for s in [start[row], start[row + 1]) in
// ascending s to acc[k], each with __fadd_rn.  U values are loaded before
// the first of them is added; loads past a segment read its last entry
// again, so none is conditional.  For short segments (a few times U).
template <int P, int U, typename Src>
__device__ __forceinline__ void sum_segments(float (&acc)[P], int pairs,
                                             int C,
                                             const int32_t* __restrict__ start,
                                             Src src,
                                             const float* __restrict__ g) {
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int p = threadIdx.x + k * blockDim.x;
    const int r = p / C;
    const int c = p - r * C;
    const int s0 = p < pairs ? start[r] : 0;
    const int s1 = p < pairs ? start[r + 1] : 0;
    for (int s = s0; s < s1; s += U) {
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        v[u] = __ldg(g + (int64_t)src(min(s + u, s1 - 1)) * C + c);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (s + u < s1) acc[k] = __fadd_rn(acc[k], v[u]);
      }
    }
  }
}

// Thread t of the block adds, for each of its (row, channel) pairs
// p = t + k * blockDim.x < pairs (k < P; row p / C, channel p % C), the
// values g[src(s) * C + channel] for s in [start[row], start[row + 1]) in
// ascending s to acc[k], each with __fadd_rn; s runs over [0, len).  The
// values of V list entries at a time are first copied to shared memory by
// the whole block with cp.async (consecutive threads on consecutive
// channels, no registers held, every copy in flight at once), the next V
// entries' copies started before the current ones are summed (val: two
// buffers of V * C floats); so a long segment (a hub row) costs adds from
// shared memory, not one load latency after another.  Called by every
// thread of the block; ends with a barrier.
template <int P, typename Src>
__device__ __forceinline__ void sum_staged(float (&acc)[P], int pairs, int C,
                                           int len,
                                           const int32_t* __restrict__ start,
                                           Src src,
                                           const float* __restrict__ g,
                                           float* __restrict__ val, int V) {
  // i = f / C by a multiply by ceil(2^32 / C): exact for f < 2^32 / C.
  const uint64_t magic = ((1ull << 32) + C - 1) / C;
  auto fetch = [&](int c0, float* buf) {
    const int vn = min(V, len - c0) * C;
    for (int f = threadIdx.x; f < vn; f += blockDim.x) {
      const int i = (int)(((uint64_t)f * magic) >> 32);
      const float* from = g + (int64_t)src(c0 + i) * C + (f - i * C);
      const unsigned to = (unsigned)__cvta_generic_to_shared(buf + f);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(to),
                   "l"(from));
    }
    asm volatile("cp.async.commit_group;");
  };
  if (len > 0) fetch(0, val);
  for (int c0 = 0, k = 0; c0 < len; c0 += V, ++k) {
    const float* cur = val + (k & 1) * V * C;
    if (c0 + V < len) {
      fetch(c0 + V, val + ((k + 1) & 1) * V * C);
      asm volatile("cp.async.wait_group 1;");
    } else {
      asm volatile("cp.async.wait_group 0;");
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int p = threadIdx.x + j * blockDim.x;
      const int r = p / C;
      const int c = p - r * C;
      const int s0 = p < pairs ? max(start[r], c0) : 0;
      const int s1 = p < pairs ? min(start[r + 1], c0 + V) : 0;
      const float* v = cur + c;
      int s = s0;
      for (; s + 8 <= s1; s += 8) {  // eight loads, then eight adds
        float x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) x[u] = v[(s + u - c0) * C];
#pragma unroll
        for (int u = 0; u < 8; ++u) acc[j] = __fadd_rn(acc[j], x[u]);
      }
      for (; s < s1; ++s) acc[j] = __fadd_rn(acc[j], v[(s - c0) * C]);
    }
    __syncthreads();  // the buffer is free for the copies after the next
  }
}

}  // namespace ogc
