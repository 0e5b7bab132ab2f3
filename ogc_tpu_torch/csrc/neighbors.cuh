// Device helpers shared by the neighbour searches #2 (knn_exact.cu), #3
// (knn_blockmin.cu) and the ball queries #3 / #5 (ball_query.cu): the pinned
// direct-form distance, the (x, y, z, 0) tile entry, and the warp selection
// of the k smallest uint32 keys.
//
// The distance is ((dx*dx + dy*dy) + dz*dz), dx = p - q, each operation
// rounded on its own (__fmul_rn / __fadd_rn) so that no FMA contraction can
// change a distance and with it a neighbour or a tie order.
//
// Warp selection (one warp per query).  Each lane offers one key at a time;
// a ballot of the keys strictly below the current threshold appends them,
// in lane order, to the query's survivor buffer in shared memory, and the
// threshold is every key (0xffffffff) until the list holds k.  When the
// buffer may not take another 32, the warp merges it into the query's
// sorted list of k keys (1 or 2 per lane), and the k-th key becomes the
// new threshold.  With a payload (an index riding with each key; #2's
// keys tie) a survivor's rank is the number of list keys <= it (a binary
// search: a list key came first) plus the survivors before it in key order
// (buffer position breaks a tie), a list key's rank its position plus the
// survivors strictly below it, and every entry of rank < k is written to
// its place.  Unique keys (#3's) merge through a bitonic network instead.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ogc {

constexpr int kSelBuf = 64;  // survivor buffer per query (keys)

__device__ __forceinline__ float d2_rn(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// A tile entry (x, y, z, 0), one 16-byte shared-memory load.
__device__ __forceinline__ float d2_to(const float4& c, float qx, float qy,
                                       float qz) {
  return d2_rn(c.x - qx, c.y - qy, c.z - qz);
}

// One compare-exchange stage of a bitonic network over the 64 keys x[0]
// (element lane) and x[1] (element lane + 32): element e meets e ^ stride
// and keeps the smaller key when its half of a size-block runs ascending.
template <int SIZE, int STRIDE>
__device__ __forceinline__ void bitonic_stage(uint32_t (&x)[2], int lane) {
  if (STRIDE == 32) {  // the partner is this lane's other key
    const uint32_t lo = min(x[0], x[1]), hi = max(x[0], x[1]);
    const bool up = SIZE == 64;  // element lane: (lane & SIZE) == 0
    x[0] = up ? lo : hi;
    x[1] = up ? hi : lo;
    return;
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int e = lane + 32 * t;
    const uint32_t p = __shfl_xor_sync(0xffffffffu, x[t], STRIDE);
    const bool keep_min = ((e & STRIDE) == 0) == ((e & SIZE) == 0);
    x[t] = keep_min ? min(x[t], p) : max(x[t], p);
  }
}

// Sort the 64 keys x ascending (element e = lane + 32 t).
__device__ __forceinline__ void bitonic_sort64(uint32_t (&x)[2], int lane) {
  bitonic_stage<2, 1>(x, lane);
  bitonic_stage<4, 2>(x, lane);
  bitonic_stage<4, 1>(x, lane);
  bitonic_stage<8, 4>(x, lane);
  bitonic_stage<8, 2>(x, lane);
  bitonic_stage<8, 1>(x, lane);
  bitonic_stage<16, 8>(x, lane);
  bitonic_stage<16, 4>(x, lane);
  bitonic_stage<16, 2>(x, lane);
  bitonic_stage<16, 1>(x, lane);
  bitonic_stage<32, 16>(x, lane);
  bitonic_stage<32, 8>(x, lane);
  bitonic_stage<32, 4>(x, lane);
  bitonic_stage<32, 2>(x, lane);
  bitonic_stage<32, 1>(x, lane);
  bitonic_stage<64, 32>(x, lane);
  bitonic_stage<64, 16>(x, lane);
  bitonic_stage<64, 8>(x, lane);
  bitonic_stage<64, 4>(x, lane);
  bitonic_stage<64, 2>(x, lane);
  bitonic_stage<64, 1>(x, lane);
}

// Merge the u survivors bk (with payload bi when PAY) into the sorted list
// lk (li) of nv <= k entries; keep the k smallest keys; update nv and thr.
// Without a payload the keys are unique (their low bits are an index) and
// the merge is a bitonic network: the buffer, padded to 64 with
// 0xffffffff, is sorted; min(list[i], buffer[63 - i]) holds the 64
// smallest keys of both as a bitonic sequence, and six more stages sort it.
// With a payload (keys that tie) each entry's rank is counted, as above.
template <int LPL, bool PAY>
__device__ __forceinline__ void warp_merge(uint32_t* lk, int32_t* li,
                                           const uint32_t* bk,
                                           const int32_t* bi, int u, int& nv,
                                           int k, uint32_t& thr, int lane) {
  static_assert(kSelBuf == 64, "the bitonic merge takes 64 survivors");
  constexpr int BPL = kSelBuf / 32;
  __syncwarp();
  if (!PAY) {
    uint32_t b[2], l[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j = lane + 32 * t;
      b[t] = j < u ? bk[j] : 0xffffffffu;
      l[t] = t < LPL && j < nv ? lk[j] : 0xffffffffu;
    }
    bitonic_sort64(b, lane);
    // list[i] against buffer[63 - i], i = lane + 32 t: 63 - i is lane
    // 31 - lane of the other register.
    const uint32_t r0 = __shfl_sync(0xffffffffu, b[1], 31 - lane);
    const uint32_t r1 = __shfl_sync(0xffffffffu, b[0], 31 - lane);
    l[0] = min(l[0], r0);
    l[1] = min(l[1], r1);
    bitonic_stage<64, 32>(l, lane);
    bitonic_stage<64, 16>(l, lane);
    bitonic_stage<64, 8>(l, lane);
    bitonic_stage<64, 4>(l, lane);
    bitonic_stage<64, 2>(l, lane);
    bitonic_stage<64, 1>(l, lane);
    __syncwarp();
#pragma unroll
    for (int t = 0; t < LPL; ++t) lk[lane + 32 * t] = l[t];
    __syncwarp();
    nv = min(nv + u, k);
    if (nv == k) thr = lk[k - 1];
    return;
  }
  uint32_t kb[BPL];
  int32_t ib[BPL];
  int rb[BPL];
#pragma unroll
  for (int t = 0; t < BPL; ++t) {
    const int pos = lane + 32 * t;
    kb[t] = 0xffffffffu;
    ib[t] = 0;
    rb[t] = k;  // an empty slot: its rank stays >= k, it is never written
    if (pos < u) {
      kb[t] = bk[pos];
      if (PAY) ib[t] = bi[pos];
      int lo = 0, hi = nv;  // list keys <= kb[t] come first
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (lk[mid] <= kb[t])
          lo = mid + 1;
        else
          hi = mid;
      }
      rb[t] = lo;
    }
  }
  uint32_t kl[LPL];
  int32_t il[LPL];
  int rl[LPL];
#pragma unroll
  for (int t = 0; t < LPL; ++t) {
    const int j = lane + 32 * t;
    kl[t] = 0;
    il[t] = 0;
    rl[t] = k;
    if (j < nv) {
      kl[t] = lk[j];
      if (PAY) il[t] = li[j];
      rl[t] = j;
    }
  }
  for (int i = 0; i < u; ++i) {
    const uint32_t v = bk[i];
#pragma unroll
    for (int t = 0; t < BPL; ++t)
      rb[t] += (v < kb[t]) | ((v == kb[t]) & (i < lane + 32 * t));
#pragma unroll
    for (int t = 0; t < LPL; ++t) rl[t] += v < kl[t];
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < BPL; ++t)
    if (rb[t] < k) {
      lk[rb[t]] = kb[t];
      if (PAY) li[rb[t]] = ib[t];
    }
#pragma unroll
  for (int t = 0; t < LPL; ++t)
    if (rl[t] < k) {
      lk[rl[t]] = kl[t];
      if (PAY) li[rl[t]] = il[t];
    }
  __syncwarp();
  nv = min(nv + u, k);
  if (nv == k) thr = lk[k - 1];
}

// Offer this lane's key (payload id): the keys strictly below thr are
// appended to the buffer bk (bi) after its cnt entries, in lane order, and
// the buffer is merged into the list when it may not take another 32.
// Called by the whole warp.
template <int LPL, bool PAY>
__device__ __forceinline__ void warp_offer(uint32_t key, int32_t id,
                                           uint32_t* lk, int32_t* li,
                                           uint32_t* bk, int32_t* bi,
                                           int& cnt, int& nv, int k,
                                           uint32_t& thr, int lane) {
  const bool pass = key < thr;
  const unsigned mask = __ballot_sync(0xffffffffu, pass);
  if (pass) {
    const int pos = cnt + __popc(mask & ((1u << lane) - 1));
    bk[pos] = key;
    if (PAY) bi[pos] = id;
  }
  cnt += __popc(mask);
  if (cnt > kSelBuf - 32) {
    warp_merge<LPL, PAY>(lk, li, bk, bi, cnt, nv, k, thr, lane);
    cnt = 0;
  }
}

}  // namespace ogc
