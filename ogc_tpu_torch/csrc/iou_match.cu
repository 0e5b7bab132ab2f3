// Mask matching by IoU for the invariance loss, on Hopper: the K x K IoU of
// two argmax segmentations and its maximum-IoU linear assignment, one CTA a
// cloud pair.
//
// Replaces no Pallas kernel.  The JAX package matches in-graph
// (ogc_tpu/losses/seg_unsup.py::match_mask_by_iou with
// ogc_tpu/utils/lap.py's lax.while_loop), so its training step never leaves
// the device; the port's host path (ops/iou_match.py::iou_match_plain: a
// numpy IoU and utils/lap.py) reads both label maps back and waits for the
// device.  This kernel keeps the matching on the card.
//
// Contract: seg1, seg2 (B, N) int64 labels in [0, K) (an argmax; a label
// outside it is not counted), K <= 32 ->
//   col_ind (B, K) int64, col_ind[b, g] = seg2's slot matched to seg1's g,
// equal to ops/iou_match.py::iou_match_plain's, ties included:
//   * the IoU: inter[g, p] = #{n : seg1[n] = g, seg2[n] = p} from an
//     integer histogram, cnt1 / cnt2 its row / column sums, then in float32
//     and numpy's order iou = inter / max((cnt1[g] + cnt2[p]) - inter,
//     1e-10).  Every count is an integer below 2^24, so inter, the counts
//     and the union are exact and the division, correctly rounded in both,
//     gives the host's bits;
//   * the assignment: utils/lap.py::_solve_one step for step on cost =
//     -iou (shortest augmenting paths, Jonker-Volgenant), every float32
//     expression in numpy's left-to-right order with the sums and
//     differences pinned (__fadd_rn / __fsub_rn; the library is also built
//     with -fmad=false), the dual updates' zero terms added as numpy adds
//     them, _INF = 1e30, and the argmin over the columns taking the first
//     index among equal values and a NaN first, as np.argmin does.
//
// Design: one CTA of kThreads threads per cloud pair (grid B).  The
// histogram: the threads stride over the N labels, each warp adding into a
// private K x K int32 copy in shared memory (4 KB at K = 32): the lanes with
// one (g, p) key find each other with __match_any_sync and their leader adds
// their number, so a crowded bin (random-weight masks put most points in one
// slot) costs one add a warp, not 32.  The copies are summed, the counts and
// the IoU follow, and one warp solves the assignment: lane j owns column j
// (shortest, pred, done, v in registers), the row state (u, col4row,
// row4col, the rows reached) and the cost matrix sit in shared memory, and
// each Dijkstra step's argmin is a butterfly of shuffles over (value, index).
//
// Bound on the H100: bytes -- both label maps read once, the columns written
// once, 2 B N 8 + B K 8 bytes over 3.35 TB/s (0.3 us at B = 8, N = 8192).
// The kernel is far from it: the assignment is K sequential Dijkstra
// searches of up to K steps, each a chain of shuffles, in one warp a pair.
// What it buys is that the host never waits for the device here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInf = 1e30f;  // utils/lap.py's _INF

// (a, ia) precedes (b, ib) in np.argmin's order: a NaN first (the lower
// index among NaNs), then the smaller value, then the lower index.
__device__ __forceinline__ bool precedes(float a, int ia, float b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na || nb) return na && (!nb || ia < ib);
  return a < b || (a == b && ia < ib);
}

__global__ void __launch_bounds__(kThreads)
    iou_match_kernel(const int64_t* __restrict__ seg1,
                     const int64_t* __restrict__ seg2, int N, int K,
                     int64_t* __restrict__ col_ind) {
  extern __shared__ int hist[];  // kWarps copies of K x K
  __shared__ float cost[kMaxK * kMaxK];
  __shared__ int cnt1[kMaxK], cnt2[kMaxK];
  __shared__ float u[kMaxK];
  __shared__ int col4row[kMaxK], row4col[kMaxK], reached[kMaxK];

  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int KK = K * K;
  for (int e = tid; e < kWarps * KK; e += kThreads) hist[e] = 0;
  __syncthreads();

  // Histogram: warp-uniform trips, so every lane takes part in the match.
  const int64_t* l1 = seg1 + (int64_t)b * N;
  const int64_t* l2 = seg2 + (int64_t)b * N;
  int* own = hist + warp * KK;
  for (int base = warp * 32; base < N; base += kThreads) {
    const int n = base + lane;
    int key = -1;
    if (n < N) {
      const int64_t g = l1[n], p = l2[n];
      if (g >= 0 && g < K && p >= 0 && p < K) key = (int)g * K + (int)p;
    }
    const unsigned peers = __match_any_sync(kFull, key);
    if (key >= 0 && lane == __ffs(peers) - 1) own[key] += __popc(peers);
  }
  __syncthreads();
  for (int e = tid; e < KK; e += kThreads) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += hist[w * KK + e];
    hist[e] = s;
  }
  __syncthreads();
  if (tid < K) {
    int s = 0;
    for (int p = 0; p < K; ++p) s += hist[tid * K + p];
    cnt1[tid] = s;
  } else if (tid >= 32 && tid < 32 + K) {
    const int p = tid - 32;
    int s = 0;
    for (int g = 0; g < K; ++g) s += hist[g * K + p];
    cnt2[p] = s;
  }
  __syncthreads();
  for (int e = tid; e < KK; e += kThreads) {
    const int g = e / K, p = e - g * K;
    const float inter = (float)hist[e];
    const float uni =
        __fsub_rn(__fadd_rn((float)cnt1[g], (float)cnt2[p]), inter);
    cost[e] = -__fdiv_rn(inter, fmaxf(uni, 1e-10f));
  }
  __syncthreads();
  if (warp != 0) return;

  // The assignment (utils/lap.py::_solve_one), one warp.
  float v = 0.0f;
  if (lane < K) {
    u[lane] = 0.0f;
    col4row[lane] = -1;
    row4col[lane] = -1;
  }
  __syncwarp();
  for (int cur = 0; cur < K; ++cur) {
    float shortest = kInf;
    int pred = 0;
    bool done = false;
    if (lane < K) reached[lane] = 0;
    __syncwarp();
    float min_val = 0.0f;
    int sink = -1, i = cur;
    while (sink < 0) {
      if (lane == 0) reached[i] = 1;
      const float ui = u[i];
      if (lane < K && !done) {
        const float d = __fsub_rn(
            __fsub_rn(__fadd_rn(min_val, cost[i * K + lane]), ui), v);
        if (d < shortest) {
          pred = i;
          shortest = d;
        }
      }
      // Lanes past K hold +inf, above every column's value.
      float best = lane < K ? (done ? kInf : shortest)
                            : __int_as_float(0x7f800000);
      int j = lane;
      for (int off = 16; off; off >>= 1) {
        const float ob = __shfl_xor_sync(kFull, best, off);
        const int oj = __shfl_xor_sync(kFull, j, off);
        if (precedes(ob, oj, best, j)) {
          best = ob;
          j = oj;
        }
      }
      min_val = best;
      if (lane == j) done = true;
      const int r = row4col[j];
      if (r < 0)
        sink = j;
      else
        i = r;
    }
    // Dual updates (scipy's rectangular_lsap.cpp, as utils/lap.py).
    __syncwarp();
    if (lane == 0) u[cur] = __fadd_rn(u[cur], min_val);
    __syncwarp();
    const int c = lane < K ? min(max(col4row[lane], 0), K - 1) : 0;
    const float short_c = __shfl_sync(kFull, shortest, c);
    if (lane < K) {
      const bool other = reached[lane] && lane != cur;
      u[lane] =
          __fadd_rn(u[lane], other ? __fsub_rn(min_val, short_c) : 0.0f);
    }
    v = __fsub_rn(v, done ? __fsub_rn(min_val, shortest) : 0.0f);
    __syncwarp();
    // Augment along the alternating path back to cur.
    int j = sink;
    while (true) {
      const int row = __shfl_sync(kFull, pred, j);
      const int next = col4row[row];
      __syncwarp();
      if (lane == 0) {
        row4col[j] = row;
        col4row[row] = j;
      }
      __syncwarp();
      j = next;
      if (row == cur) break;
    }
  }
  if (lane < K) col_ind[(int64_t)b * K + lane] = col4row[lane];
}

}  // namespace

extern "C" int ogc_iou_match(const void* seg1, const void* seg2, int B, int N,
                             int K, void* col_ind, void* stream) {
  if (B < 1 || N < 0 || K < 1 || K > kMaxK)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kWarps * K * K * sizeof(int);
  iou_match_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const int64_t*)seg1, (const int64_t*)seg2, N, K, (int64_t*)col_ind);
  return (int)cudaGetLastError();
}
