// The fused prologue of the pruned KNNs #4 (knn_exact_pruned.cu) and #6
// (knn_cand_pruned.cu) on Hopper.
//
// Replaces the torch prologues of ops/knn_pruned.py (prologue, survivors)
// and ops/knn_cand.py (prologue), which copy the JAX package's
// (ogc_tpu/ops/pallas_knn.py::_pruned_prologue :977, _survivor_order :1032,
// knn_pruned :1345-1398): a chain of ~300 small launches a call for
// microseconds of device work at the paths' sizes.  Two launches here:
//
// sort_kernel (ogc_pruned_sort): a CTA per cloud, the point cloud and the
// query cloud of each batch item.  The cloud's min and max (a block
// reduction), each point's 30-bit Morton code (pruned.cuh::morton30, the
// torch arithmetic pinned), and a stable LSD radix sort of the codes by
// four 8-bit digits (radix_pass): the order torch.sort(stable=True) and
// jnp.argsort give.  Then the sorted rows with their original indices
// (a point as (x, y, z, id bits), one 16-byte load for the searches), the
// pad rows (a point pad at 1e6 with the pad id; a query pad at 1e6, or a
// copy of the last sorted query for #4), and the box of every block
// (points) or tile (queries), pads left out where the module leaves them
// out.  A cloud of more than kMaxRun points (16384, shared memory) takes
// one CTA per run, then merge_kernel places each key code << 32 |
// index at its rank among all runs (its place in its run plus a binary
// search in each other run; the keys are unique) and finish_kernel writes
// the pads and boxes: two launches more.
//
// select_kernel (ogc_pruned_select): a CTA per (query tile, batch item).
// lb2 against every point block (pruned.cuh::box_lb2), written out; then
//   #4: theta_tile = max over the tile's queries of kth * kth * inflate
//       (kth the #3 pre-pass's last column), survive = lb2 <= theta_tile,
//       `order` every block by (survive ? lb2 : inf, block), `count` the
//       survivors;
//   #6: score = f32(f64(lb2) + f64(c2c) * f64(f32(1e-3))), rounded once
//       (XLA's fused lb2 + 1e-3 * c2c), written out, and `cand` the n_cand
//       blocks of smallest (score, block).
// A block's place is its rank, the number of blocks whose (value bits,
// block) pair is smaller: values are >= +0.0 (or +inf), so their bits
// order as the numbers, and the pairs are unique.
//
// Bound on the H100: bytes, about a microsecond (each cloud read once, the
// sorted rows, boxes and lists written once).  What holds the sort above
// it is one CTA per cloud: it takes ~0.055 ms at 8192 points (PERF.md §6),
// its radix passes and barriers run on one SM, and it parallelises only
// across clouds.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "csr.cuh"
#include "gather_rows.cuh"
#include "pruned.cuh"

namespace {

constexpr int kSortThreads = 1024;
constexpr int kMaxRun = 16384;  // keys a CTA sorts: 128 KiB of shared memory
constexpr int kSelectThreads = 256;
constexpr float kBig = 1e9f;  // the box of no row: lo 1e9, hi -1e9
constexpr float kPad = 1e6f;

// One side of the batch: the points or the queries.
struct Cloud {
  const float* x;           // (B, n, 3) input rows
  float* xs;                // (B, size, width) sorted rows, then pads; width
                            // 4 carries each row's original index (pads
                            // pad_id) as the bits of its fourth float
  int32_t* ids;             // (B, size) the original indices, or null
  float* box;               // (B, size / cb, 6) lo x, y, z, hi x, y, z
  unsigned long long* run;  // (B, n) sorted runs, when n > the run length
  int n, size, cb, width;
  int pad_id;
  int repeat_last;          // pads copy the last sorted row, else at 1e6
  int boxed;                // rows >= boxed are left out of the boxes
};

struct Clouds {
  Cloud c[2];  // points, queries
};


// The min and max of each coordinate over rows [0, n) of x, by the block;
// red holds 6 floats per warp plus 6.
__device__ void cloud_bounds(const float* __restrict__ x, int n,
                             float (&lo)[3], float (&hi)[3], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float v[6];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    v[c] = INFINITY;
    v[3 + c] = -INFINITY;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float t = x[(size_t)i * 3 + c];
      v[c] = fminf(v[c], t);
      v[3 + c] = fmaxf(v[3 + c], t);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v[c] = fminf(v[c], __shfl_xor_sync(0xffffffffu, v[c], off));
      v[3 + c] = fmaxf(v[3 + c], __shfl_xor_sync(0xffffffffu, v[3 + c], off));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 6; ++c) red[warp * 6 + c] = v[c];
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    const int c = threadIdx.x;
    float r = red[c];
    for (int w = 1; w < warps; ++w)
      r = c < 3 ? fminf(r, red[w * 6 + c]) : fmaxf(r, red[w * 6 + c]);
    red[warps * 6 + c] = r;
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    lo[c] = red[warps * 6 + c];
    hi[c] = red[warps * 6 + 3 + c];
  }
  __syncthreads();
}

// Row `to` of the sorted cloud is input row `from` (original index `id`).
__device__ __forceinline__ void put_row(const Cloud& c, int b, int to,
                                        float x, float y, float z, int id) {
  float* r = c.xs + ((size_t)b * c.size + to) * c.width;
  if (c.width == 4) {
    *reinterpret_cast<float4*>(r) = make_float4(x, y, z, __int_as_float(id));
  } else {
    r[0] = x;
    r[1] = y;
    r[2] = z;
  }
  if (c.ids) c.ids[(size_t)b * c.size + to] = id;
}

__device__ __forceinline__ void place(const Cloud& c, int b, int to,
                                      int from) {
  const float* x = c.x + ((size_t)b * c.n + from) * 3;
  put_row(c, b, to, x[0], x[1], x[2], from);
}

// The pad rows [n, size) and every block's box, by the block, after the
// sorted rows [0, n) are written.  Ends with a barrier.
__device__ void finish_cloud(const Cloud& c, int b) {
  const int w = c.width;
  const float* xs = c.xs + (size_t)b * c.size * w;
  const float* last = xs + (size_t)(c.n - 1) * w;
  for (int i = c.n + threadIdx.x; i < c.size; i += blockDim.x) {
    if (c.repeat_last)
      put_row(c, b, i, last[0], last[1], last[2], c.pad_id);
    else
      put_row(c, b, i, kPad, kPad, kPad, c.pad_id);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb = c.size / c.cb;
  for (int j = warp; j < nb; j += blockDim.x >> 5) {
    float v[6];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      v[d] = INFINITY;
      v[3 + d] = -INFINITY;
    }
    for (int r = lane; r < c.cb; r += 32) {
      const int row = j * c.cb + r;
      const bool in = row < c.boxed;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float t = xs[(size_t)row * w + d];
        v[d] = fminf(v[d], in ? t : kBig);
        v[3 + d] = fmaxf(v[3 + d], in ? t : -kBig);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        v[d] = fminf(v[d], __shfl_xor_sync(0xffffffffu, v[d], off));
        v[3 + d] = fmaxf(v[3 + d], __shfl_xor_sync(0xffffffffu, v[3 + d],
                                                   off));
      }
    }
    if (lane < 6) c.box[((size_t)b * nb + j) * 6 + lane] = v[lane];
  }
  __syncthreads();
}

// One stable partition of the items cur[0, n) (n <= kMaxRun) by their
// 8-bit digit(r) (r the place in cur) into nxt, by the block: warp w takes
// a slice of at most kSteps whole steps of 32 places; the lanes of equal
// digits in a step find each other by eight ballots (one per digit bit: a
// fixed cost, where __match_any_sync iterates over the distinct digits),
// kept in registers; each group's first lane adds its size to the warp's
// histogram hist[w * 256 + d]; the counts become positions
// (csr.cuh::counts_to_positions), and the warp puts each item, step by
// step, at its digit's position plus its rank among the earlier equal
// items.  Ends with a barrier.
template <typename Digit>
__device__ void radix_pass(int n, Digit digit, const uint16_t* cur,
                           uint16_t* nxt, uint16_t* hist, int32_t* start,
                           int32_t* wsum) {
  constexpr int W = kSortThreads / 32;
  constexpr int kSteps = kMaxRun / kSortThreads;
  for (int i = threadIdx.x; i < W * 256 / 2; i += blockDim.x)
    reinterpret_cast<uint32_t*>(hist)[i] = 0u;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = ogc::lanemask_lt();
  const int sub = (n + 32 * W - 1) / (32 * W) * 32;
  const int r0 = min(n, warp * sub), r1 = min(n, r0 + sub);
  uint16_t* h = hist + warp * 256;
  int d[kSteps];
  unsigned m[kSteps];
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const int r = r0 + 32 * u + lane;
    d[u] = r < r1 ? digit(r) : -1;
  }
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    m[u] = 0u;
    if (r0 + 32 * u >= r1) continue;  // uniform over the warp
    unsigned g = __ballot_sync(0xffffffffu, d[u] >= 0);
#pragma unroll
    for (int bit = 0; bit < 8; ++bit) {
      const unsigned set = __ballot_sync(0xffffffffu, (d[u] >> bit) & 1);
      g &= (d[u] >> bit) & 1 ? set : ~set;
    }
    m[u] = d[u] >= 0 ? g : 0u;
  }
  __syncthreads();  // the histograms are zero
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    if (m[u] && !(m[u] & below)) h[d[u]] += __popc(m[u]);
    __syncwarp();
  }
  __syncthreads();
  ogc::counts_to_positions<W>(hist, 256, 256, start, wsum);
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const int pos = m[u] ? h[d[u]] + __popc(m[u] & below) : 0;
    __syncwarp();
    if (m[u] && !(m[u] & below)) h[d[u]] += __popc(m[u]);
    if (m[u]) nxt[pos] = cur[r0 + 32 * u + lane];
    __syncwarp();
  }
  __syncthreads();
}

// The block's stable sort of the n <= 65535 codes[0, n) (< 2^30): an LSD
// radix sort by four 8-bit digits, each pass a radix_pass of the current
// order.  Leaves in order[0, n) the indices of the codes ascending, equal
// codes in index order (the stable sort by code); `spare` is n more
// indices, hist kSortThreads / 32 * 256 counts.
__device__ void radix_sort(const uint32_t* codes, int n, uint16_t* order,
                           uint16_t* spare, uint16_t* hist, int32_t* start,
                           int32_t* wsum) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) order[i] = (uint16_t)i;
  __syncthreads();
  uint16_t *cur = order, *nxt = spare;
  for (int shift = 0; shift < 32; shift += 8) {
    radix_pass(
        n, [&](int r) { return (int)((codes[cur[r]] >> shift) & 255u); },
        cur, nxt, hist, start, wsum);
    uint16_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  // Four passes: the result is back in `order`.
}

// Grid (max runs, 2, B): run blockIdx.x (of `len` <= kMaxRun points) of
// cloud blockIdx.y of item blockIdx.z.  Dynamic shared memory: cap (the
// longest run) codes (uint32) and twice cap indices (uint16), the radix
// histograms, then the scan's and the reduction's words.
__global__ void __launch_bounds__(kSortThreads)
    sort_kernel(Clouds cs, int len, int cap) {
  extern __shared__ uint32_t codes[];
  uint16_t* order = reinterpret_cast<uint16_t*>(codes + cap);
  uint16_t* spare = order + cap;
  uint16_t* hist = spare + cap;
  int32_t* start = reinterpret_cast<int32_t*>(hist + kSortThreads / 32 * 256);
  int32_t* wsum = start + 257;
  float* red = reinterpret_cast<float*>(wsum + kSortThreads / 32);
  const Cloud& c = cs.c[blockIdx.y];
  const int b = blockIdx.z, r = blockIdx.x;
  if (r * len >= c.n) return;
  const float* x = c.x + (size_t)b * c.n * 3;
  float lo[3], hi[3], ext[3];
  cloud_bounds(x, c.n, lo, hi, red);
#pragma unroll
  for (int d = 0; d < 3; ++d) ext[d] = fmaxf(__fsub_rn(hi[d], lo[d]), 1e-6f);
  const int r0 = r * len, n = min(len, c.n - r0);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float* p = x + (size_t)(r0 + i) * 3;
    codes[i] = ogc::morton30(p[0], p[1], p[2], lo, ext);
  }
  __syncthreads();
  radix_sort(codes, n, order, spare, hist, start, wsum);
  if (c.n > len) {  // merge_kernel and finish_kernel take it from here
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int j = order[i];
      c.run[(size_t)b * c.n + r0 + i] =
          (unsigned long long)codes[j] << 32 | (unsigned)(r0 + j);
    }
    return;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) place(c, b, i, order[i]);
  __syncthreads();
  finish_cloud(c, b);
}

// Grid (ceil(max n / 256), 2, B), clouds of more than `len` points: key
// i of the sorted runs goes to its rank among all keys.
__global__ void merge_kernel(Clouds cs, int len) {
  const Cloud& c = cs.c[blockIdx.y];
  const int b = blockIdx.z;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (c.n <= len || i >= c.n) return;
  const unsigned long long* run = c.run + (size_t)b * c.n;
  const unsigned long long key = run[i];
  const int mine = i / len;
  int rank = i - mine * len;
  for (int r = 0; r * len < c.n; ++r) {
    if (r == mine) continue;
    int lo = r * len, hi = min(c.n, lo + len);  // keys below `key`
    const int base = lo;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (run[mid] < key)
        lo = mid + 1;
      else
        hi = mid;
    }
    rank += lo - base;
  }
  place(c, b, rank, (int)(key & 0xffffffffu));
}

// Grid (2, B): the pads and boxes of clouds of more than `len` points.
__global__ void __launch_bounds__(kSortThreads)
    finish_kernel(Clouds cs, int len) {
  const Cloud& c = cs.c[blockIdx.x];
  if (c.n > len) finish_cloud(c, blockIdx.y);
}

// The larger of the block's values v (>= 0), by the block; red holds one
// float per warp.
__device__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = fmaxf(m, red[w]);
  return m;
}

// Grid (nbq, B).  SURVIVORS: #4's order and count; else #6's cand.
template <bool SURVIVORS>
__global__ void __launch_bounds__(kSelectThreads) select_kernel(
    const float* __restrict__ p_box, const float* __restrict__ q_box,
    int nbp, const float* __restrict__ fd, int k, int qt, float inflate,
    int n_cand, float* lb2, float* score, int32_t* __restrict__ list,
    int32_t* __restrict__ count) {
  __shared__ float red[kSelectThreads / 32];
  __shared__ int survivors;
  const int tile = blockIdx.x, b = blockIdx.y, nbq = gridDim.x;
  const size_t row = (size_t)b * nbq + tile;
  const float* q = q_box + row * 6;
  const float* pb = p_box + (size_t)b * nbp * 6;
  float* l = lb2 + row * nbp;
  float* s = SURVIVORS ? nullptr : score + row * nbp;
  float theta = 0.0f;
  if (SURVIVORS) {
    if (threadIdx.x == 0) survivors = 0;  // before block_max's barrier
    float t = 0.0f;
    for (int i = threadIdx.x; i < qt; i += blockDim.x) {
      const float kth = fd[((size_t)b * nbq * qt + tile * qt + i) * k + k - 1];
      t = fmaxf(t, __fmul_rn(__fmul_rn(kth, kth), inflate));
    }
    theta = block_max(t, red);
  }
  int mine = 0;
  for (int j = threadIdx.x; j < nbp; j += blockDim.x) {
    const float v = ogc::box_lb2(q, pb + (size_t)j * 6);
    l[j] = v;
    if (SURVIVORS) {
      mine += v <= theta;
    } else {
      const double w = (double)1e-3f;
      s[j] = __double2float_rn(__dadd_rn(
          (double)v, __dmul_rn((double)ogc::box_c2c(q, pb + (size_t)j * 6),
                               w)));
    }
  }
  if (SURVIVORS && mine) atomicAdd(&survivors, mine);
  __syncthreads();  // every value written, the count complete
  const float inf = INFINITY;
  auto value = [&](int j) -> uint32_t {
    if (!SURVIVORS) return __float_as_uint(s[j]);
    const float v = l[j];
    return __float_as_uint(v <= theta ? v : inf);
  };
  int32_t* out = list + row * (SURVIVORS ? nbp : n_cand);
  for (int j = threadIdx.x; j < nbp; j += blockDim.x) {
    const uint32_t vj = value(j);
    int rank = 0;
    for (int i = 0; i < nbp; ++i) {
      const uint32_t vi = value(i);
      rank += vi < vj || (vi == vj && i < j);
    }
    if (SURVIVORS || rank < n_cand) out[rank] = j;
  }
  if (SURVIVORS && threadIdx.x == 0) count[row] = survivors;
}

int smem_done[ogc::kMaxDevices];

}  // namespace

// Sort both clouds of B items in runs of kMaxRun points (a CTA each) and
// box them.  points (B, M, 3), query (B, N, 3)
// f32; p4 (B, mp, 4) sorted points, each (x, y, z, the bits of its int32
// original index), p_box (B, mp / cb, 6); q_s (B, np, 3), qid (B, np),
// q_box (B, np / qt, 6); run_p (B, M) and run_q (B, N) uint64 scratch, only
// read when M or N > kMaxRun (else may be null).  Point pads at 1e6 with id
// p_pad_id; query pads with id -1, at 1e6, or a copy of the last sorted
// query when q_repeat; the boxes leave out points >= M and queries >=
// q_boxed.  Requires 1 <= M, N.  Launches sort_kernel, and merge_kernel
// and finish_kernel when a cloud has more than kMaxRun points, on `stream`;
// returns cudaGetLastError() (0 on success).
extern "C" int ogc_pruned_sort(const void* points, const void* query, int B,
                               int M, int N, int mp, int np, int cb, int qt,
                               int p_pad_id, int q_repeat, int q_boxed,
                               void* p4, void* p_box, void* q_s, void* qid,
                               void* q_box, void* run_p, void* run_q,
                               void* stream) {
  constexpr int run = kMaxRun;
  if (B < 1 || M < 1 || N < 1 || mp < M || np < N || cb < 1 || qt < 1 ||
      mp % cb || np % qt || (M > run && !run_p) || (N > run && !run_q))
    return (int)cudaErrorInvalidValue;
  Clouds cs;
  cs.c[0] = Cloud{(const float*)points, (float*)p4, nullptr, (float*)p_box,
                  (unsigned long long*)run_p, M, mp, cb, 4, p_pad_id, 0, M};
  cs.c[1] = Cloud{(const float*)query, (float*)q_s, (int32_t*)qid,
                  (float*)q_box, (unsigned long long*)run_q, N, np, qt, 3, -1,
                  q_repeat, q_boxed};
  const int cap = min(run, max(M, N));
  const int smem = cap * 8 + kSortThreads / 32 * 256 * 2 + 257 * 4 +
                   kSortThreads / 32 * 4 + (kSortThreads / 32 + 1) * 6 * 4;
  cudaError_t err = ogc::smem_opt_in(sort_kernel, smem, smem_done);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int runs = (max(M, N) + run - 1) / run;
  sort_kernel<<<dim3(runs, 2, B), kSortThreads, smem, s>>>(cs, run, cap);
  if (runs > 1) {
    merge_kernel<<<dim3((max(M, N) + 255) / 256, 2, B), 256, 0, s>>>(cs,
                                                                     run);
    finish_kernel<<<dim3(2, B), kSortThreads, 0, s>>>(cs, run);
  }
  return (int)cudaGetLastError();
}

// Per (query tile, item): lb2 (B, nbq, nbp) against every point block
// from the boxes p_box (B, nbp, 6) and q_box (B, nbq, 6).  survivors = 1
// (#4): theta from fd (B, nbq * qt, k), the #3 pre-pass's distances, and
// inflate; list (B, nbq, nbp) every block, survivors first, count (B,
// nbq).  survivors = 0 (#6): score (B, nbq, nbp), list (B, nbq, n_cand)
// the n_cand <= nbp blocks of smallest score.  Launches select_kernel on
// `stream`; returns cudaGetLastError() (0 on success).
extern "C" int ogc_pruned_select(const void* p_box, const void* q_box, int B,
                                 int nbq, int nbp, int survivors,
                                 const void* fd, int k, int qt, float inflate,
                                 int n_cand, void* lb2, void* score,
                                 void* list, void* count, void* stream) {
  if (B < 1 || nbq < 1 || nbp < 1 ||
      (survivors ? (!fd || k < 1 || qt < 1 || !count)
                 : (!score || n_cand < 1 || n_cand > nbp)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(nbq, B);
  if (survivors)
    select_kernel<true><<<grid, kSelectThreads, 0, s>>>(
        (const float*)p_box, (const float*)q_box, nbp, (const float*)fd, k,
        qt, inflate, n_cand, (float*)lb2, (float*)score, (int32_t*)list,
        (int32_t*)count);
  else
    select_kernel<false><<<grid, kSelectThreads, 0, s>>>(
        (const float*)p_box, (const float*)q_box, nbp, (const float*)fd, k,
        qt, inflate, n_cand, (float*)lb2, (float*)score, (int32_t*)list,
        (int32_t*)count);
  return (int)cudaGetLastError();
}
