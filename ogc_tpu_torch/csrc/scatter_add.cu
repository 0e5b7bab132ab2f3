// Deterministic row scatter-add on Hopper: the backward of every grouping
// gather in the port.
//
// Replaces the Pallas TPU kernel ogc_tpu/ops/pallas_scatter.py::
// scatter_add_rows (its inner `kernel`; tools/bench_pallas_scatter.py holds
// a bench copy of the same body).
//
// Contract: d[b, idx[b, r], :] += g[b, r, :] over r = 0, 1, ..., R-1 in
// that order, f32, every destination row starting from 0.0f.  The TPU grid
// runs sequentially, so that order is the Pallas kernel's own; keeping it
// makes this kernel bit-equal to it and to the plain version.  Every idx
// lies in [0, n_dest): a row outside gets no position in the CSR, and its
// slot of `order` is left unwritten inside its batch's last segment.
//
// Design: every counter and every sum has exactly one writing thread, so
// no result depends on the order in which threads run (no read-modify-write
// shared between threads, float or integer).  Three kernels build a stable
// CSR of the destinations (destination-major, ascending r inside a
// destination; int32 entries, the flattened source row b * R + r) and a
// fourth sums each destination's segment:
//
// 1. csr_count: a CTA per (batch, chunk of `chunk` rows).  Its 8 warps each
//    walk a contiguous eighth of the chunk 32 rows at a time; lanes with
//    the same destination find each other with __match_any_sync and the
//    lowest of them adds the group's size to the warp's own histogram in
//    shared memory (16-bit counts), so no two threads ever write one
//    counter.  The chunk's counts go to H[b][c][d], and the chunk's rows
//    below each destination tile (of `dt` destinations) to cum[b][c][t].
// 2. csr_scan: a CTA per (destination tile, batch).  The rows of the batch
//    below the tile are the sum over chunks of cum; the tile's counts are
//    scanned from there in (destination, chunk) order, in place (each
//    thread a run of consecutive entries, then one scan of the threads'
//    sums): H[b][c][d] becomes the position of chunk c's first row for d,
//    and start[b, d] the position of d's first row.
// 3. csr_place: a CTA per (batch, chunk) again.  It recounts its warps'
//    histograms, turns them into offsets (warps in order), and walks the
//    rows once more: a row's position is H[b][c][d] + its warp's offset +
//    its rank among the earlier lanes of its match group (popc), and the
//    group's lowest lane then advances the offset.  Chunks, warps, steps
//    and lanes are taken in order of r, so the CSR is stable.  (Grouping
//    the lanes by a bitonic sort of their keys instead of the match
//    measured slower.)
// 4. accumulate (ops/scatter.py::accumulate_plan): for C >= 32 a warp per
//    destination row (a source row read as whole 128-byte lines, lanes
//    over channels, ~16 loads a lane in flight); for C < 32 a thread per
//    (row, channel), the next 16 order entries loaded while the current 16
//    rows are read.  Every load is unconditional (past the segment, a
//    clamped one), so the compiler issues a batch's loads before its
//    first add.  Each element is summed in ascending r with __fadd_rn from
//    +0.0 and written once.  A hub row (a point that many neighbourhoods
//    list) keeps its serial tail: a split sum would change the bits.
//
// Destinations are taken in windows of at most kMaxWindow (the warps'
// 16-bit histograms of one window fill shared memory); a larger n_dest
// walks the chunk once per window.  ops/scatter.py::csr_plan picks chunk,
// dt and the window.
//
// Bound on the H100: bytes -- the gradient rows are read once (R x C x 4),
// the output written once, plus idx (read three times), the CSR (written
// and read) and the chunk counts.

#include <cuda_runtime.h>
#include <stdint.h>

#include "csr.cuh"
#include "gather_rows.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxWindow = 8192;
constexpr int kMaxChunk = 65280;  // offsets inside a chunk fit 16 bits
constexpr int kMaxSmem = 227 * 1024 - 1024;

using ogc::warp_exclusive_scan;
using ogc::warp_inclusive_scan;

// One warp walks rows [r0, r1) of a batch (ogc::warp_walk) with the key
// of row r its destination's offset in the window [w0, w0 + wn), -1
// outside.
template <typename Idx, typename F>
__device__ __forceinline__ void warp_walk(const Idx* __restrict__ ib, int r0,
                                          int r1, int w0, int wn, F f) {
  ogc::warp_walk(r0, r1, [&](int r) {
    const Idx v = ib[r];
    return v >= (Idx)w0 && v < (Idx)w0 + (Idx)wn ? (int)(v - (Idx)w0) : -1;
  }, f);
}

// Rows [r0, r1) of a batch that warp `warp` of chunk c walks.
__device__ __forceinline__ void warp_rows(int R, int chunk, int c, int warp,
                                          int& r0, int& r1) {
  const int sub = chunk / kWarps;
  r0 = min(R, c * chunk + warp * sub);
  r1 = min(R, r0 + sub);
}

// The warps' 16-bit histograms of one window: zeroed, then counted.  Ends
// with a barrier.
template <typename Idx>
__device__ __forceinline__ void count_window(const Idx* __restrict__ ib,
                                             int r0, int r1, int w0, int wn,
                                             int ws, uint16_t* hist) {
  for (int i = threadIdx.x; i < kWarps * ws / 2; i += kThreads) {
    reinterpret_cast<uint32_t*>(hist)[i] = 0u;
  }
  __syncthreads();
  uint16_t* h = hist + (threadIdx.x >> 5) * ws;
  warp_walk(ib, r0, r1, w0, wn, [&](bool, int, int d, int, int len) {
    if (len) h[d] += len;
  });
  __syncthreads();
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
    csr_count_kernel(const Idx* __restrict__ idx, int R, int n_dest,
                     int chunk, int nc, int dt, int win, int n_tiles,
                     int32_t* __restrict__ H, int32_t* __restrict__ cum) {
  extern __shared__ int32_t sm[];
  const int ws = (win + 31) & ~31;
  int32_t* part = sm;                    // ws / 32 sums of 32 destinations
  int32_t* tsum = part + ws / 32;        // the window's tile sums
  uint16_t* hist = reinterpret_cast<uint16_t*>(tsum + (win + dt - 1) / dt);
  const int c = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int r0, r1;
  warp_rows(R, chunk, c, warp, r0, r1);
  const Idx* ib = idx + (size_t)b * R;
  int32_t* hc = H + ((size_t)b * nc + c) * n_dest;
  int32_t* cc = cum + ((size_t)b * nc + c) * n_tiles;
  int carry = 0;  // warp 0: the chunk's rows below the window
  for (int w0 = 0; w0 < n_dest; w0 += win) {
    const int wn = min(win, n_dest - w0);
    const int wp = (wn + 31) & ~31;
    count_window(ib, r0, r1, w0, wn, ws, hist);
    for (int d = threadIdx.x; d < wp; d += kThreads) {
      int v = 0;
      if (d < wn) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v += hist[w * ws + d];
        hc[w0 + d] = v;
      }
      const int s = __reduce_add_sync(kFull, v);
      if (lane == 0) part[d >> 5] = s;
    }
    __syncthreads();
    const int tiles = (wn + dt - 1) / dt;
    const int per = dt / 32;
    for (int t = threadIdx.x; t < tiles; t += kThreads) {
      int v = 0;
      for (int q = t * per; q < min((t + 1) * per, wp / 32); ++q) v += part[q];
      tsum[t] = v;
    }
    __syncthreads();
    if (warp == 0) carry = warp_exclusive_scan(tsum, tiles, carry, cc + w0 / dt);
    __syncthreads();
  }
}

// The scan tile's count of (destination dl, chunk c) sits at
// s[c * (dt + 1) + dl]: loaded along dl (coalesced from H[b][c][d]), and a
// thread's run of consecutive scan entries (destination-major) falls on
// distinct banks across the threads (dt + 1 is 1 modulo 32).
__global__ void __launch_bounds__(kThreads)
    csr_scan_kernel(int R, int n_dest, int nc, int dt, int n_tiles,
                    int32_t* __restrict__ H, const int32_t* __restrict__ cum,
                    int32_t* __restrict__ start) {
  extern __shared__ int32_t s[];  // nc x (dt + 1)
  __shared__ int32_t wsum[kWarps];
  const int t = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d0 = t * dt, dn = min(dt, n_dest - d0);
  const int stride = dt + 1;
  int v = 0;
  for (int c = threadIdx.x; c < nc; c += kThreads) {
    v += cum[((size_t)b * nc + c) * n_tiles + t];
  }
  v = __reduce_add_sync(kFull, v);
  if (lane == 0) wsum[warp] = v;
  // Entry i of the tile in load order is (c, dl) = (i / dn, i % dn); a
  // thread loads 8 entries before it stores any (loads in flight, not one
  // latency an entry).
  const int E = dn * nc;
  const int32_t* hb = H + (size_t)b * nc * n_dest + d0;
  for (int i0 = 0; i0 < E; i0 += 8 * kThreads) {
    int x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = min(i0 + u * kThreads + (int)threadIdx.x, E - 1);
      const int c = i / dn;
      x[u] = hb[(size_t)c * n_dest + i - c * dn];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * kThreads + threadIdx.x;
      if (i < E) {
        const int c = i / dn;
        s[c * stride + i - c * dn] = x[u];
      }
    }
  }
  __syncthreads();
  int base = b * R;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) base += wsum[w];
  // Thread i scans scan entries [i * K, i * K + K) (entry e is (e / nc,
  // e % nc)) in place; then the threads' sums are scanned across the block.
  const int K = (E + kThreads - 1) / kThreads;
  const int e0 = min(E, (int)threadIdx.x * K), e1 = min(E, e0 + K);
  int dl = e0 / nc, c = e0 - dl * nc;
  int run = 0;
  for (int e = e0; e < e1; ++e) {
    const int at = c * stride + dl;
    const int x = s[at];
    s[at] = run;
    run += x;
    if (++c == nc) {
      c = 0;
      ++dl;
    }
  }
  const int incl = warp_inclusive_scan(run);
  __syncthreads();  // every thread has read wsum
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int before = base + incl - run;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) before += w < warp ? wsum[w] : 0;
  dl = e0 / nc;
  c = e0 - dl * nc;
  for (int e = e0; e < e1; ++e) {
    s[c * stride + dl] += before;
    if (++c == nc) {
      c = 0;
      ++dl;
    }
  }
  __syncthreads();
  for (int c2 = 0; c2 < nc; ++c2) {
    int32_t* hc = H + ((size_t)b * nc + c2) * n_dest + d0;
    for (int d = threadIdx.x; d < dn; d += kThreads) {
      hc[d] = s[c2 * stride + d];
    }
  }
  for (int d = threadIdx.x; d < dn; d += kThreads) {
    start[(size_t)b * n_dest + d0 + d] = s[d];
  }
  if (t == (int)gridDim.x - 1 && b == (int)gridDim.y - 1 && threadIdx.x == 0) {
    start[(size_t)gridDim.y * n_dest] = (int)gridDim.y * R;
  }
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
    csr_place_kernel(const Idx* __restrict__ idx, int R, int n_dest,
                     int chunk, int nc, int win,
                     const int32_t* __restrict__ H,
                     int32_t* __restrict__ order) {
  extern __shared__ int32_t sm[];
  const int ws = (win + 31) & ~31;
  int32_t* base = sm;  // the window's H[b][c][d]
  uint16_t* hist = reinterpret_cast<uint16_t*>(base + ws);
  const int c = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  int r0, r1;
  warp_rows(R, chunk, c, warp, r0, r1);
  const Idx* ib = idx + (size_t)b * R;
  const int32_t* hc = H + ((size_t)b * nc + c) * n_dest;
  const int row0 = b * R;
  uint16_t* h = hist + warp * ws;
  for (int w0 = 0; w0 < n_dest; w0 += win) {
    const int wn = min(win, n_dest - w0);
    for (int d = threadIdx.x; d < wn; d += kThreads) base[d] = hc[w0 + d];
    count_window(ib, r0, r1, w0, wn, ws, hist);
    // Each warp's counts become its offset: the rows of the earlier warps.
    for (int d = threadIdx.x; d < wn; d += kThreads) {
      int run = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int x = hist[w * ws + d];
        hist[w * ws + d] = (uint16_t)run;
        run += x;
      }
    }
    __syncthreads();
    warp_walk(ib, r0, r1, w0, wn,
              [&](bool in, int r, int d, int rank, int len) {
      const int pos = in ? base[d] + h[d] + rank : 0;
      __syncwarp();
      if (len) h[d] += len;
      if (in) order[pos] = row0 + r;
    });
    __syncthreads();
  }
}

// A warp per destination row: lane l sums channels cb + 32q + l (q < Q) of
// each block of 32Q channels (Q = ceil(C / 32) up to 8), 16 / Q source
// rows in flight (about 16 loads a thread), the segment's order entries
// loaded 32 at a time by the lanes.
// Every load is unconditional (a ragged row or channel reads a clamped
// one), so the compiler issues them all before the first add.
template <int Q>
__global__ void __launch_bounds__(kThreads)
    accumulate_warp_kernel(const float* __restrict__ g,
                           const int32_t* __restrict__ order,
                           const int32_t* __restrict__ start, int rows, int C,
                           float* __restrict__ out) {
  constexpr int U = 16 / Q;
  const int d = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (d >= rows) return;
  const int lane = threadIdx.x & 31;
  const int s0 = start[d], s1 = start[d + 1];
  for (int cb = 0; cb < C; cb += 32 * Q) {
    float acc[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[q] = 0.0f;
    for (int s = s0; s < s1; s += 32) {
      const int n = min(32, s1 - s);
      const int mine = order[s + min(lane, n - 1)];
      for (int u0 = 0; u0 < n; u0 += U) {
        float v[U][Q];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const size_t row =
              (size_t)__shfl_sync(kFull, mine, min(u0 + u, n - 1)) * C;
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            v[u][q] = __ldg(g + row + min(cb + q * 32 + lane, C - 1));
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (u0 + u < n) {
#pragma unroll
            for (int q = 0; q < Q; ++q) acc[q] = __fadd_rn(acc[q], v[u][q]);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int ch = cb + q * 32 + lane;
      if (ch < C) out[(size_t)d * C + ch] = acc[q];
    }
  }
}

// A thread per (destination row, channel): the next kRows order entries
// load while the current kRows source values do.  Loads past the segment
// read its last entry again, so none is conditional.
constexpr int kRows = 16;

__global__ void __launch_bounds__(kThreads)
    accumulate_thread_kernel(const float* __restrict__ g,
                             const int32_t* __restrict__ order,
                             const int32_t* __restrict__ start, int rows,
                             int C, float* __restrict__ out) {
  constexpr int U = kRows;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (int64_t)rows * C) return;
  const int d = (int)(t / C);
  const int c = (int)(t - (int64_t)d * C);
  const int s0 = start[d], s1 = start[d + 1];
  float acc = 0.0f;
  if (s0 < s1) {
    const int end = s1 - 1;
    int next[U];
#pragma unroll
    for (int u = 0; u < U; ++u) next[u] = order[min(s0 + u, end)];
    for (int s = s0; s < s1; s += U) {
      int cur[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        cur[u] = next[u];
        next[u] = order[min(s + U + u, end)];
      }
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = __ldg(g + (size_t)cur[u] * C + c);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        acc = s + u < s1 ? __fadd_rn(acc, v[u]) : acc;
      }
    }
  }
  out[t] = acc;
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes, int* done) {
  if (bytes > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  return ogc::smem_opt_in(kernel, (int)bytes, done);
}

template <typename Idx>
int csr(const Idx* idx, int B, int R, int n_dest, int chunk, int nc, int dt,
        int win, int32_t* scratch, cudaStream_t stream) {
  static int done_count[ogc::kMaxDevices], done_scan[ogc::kMaxDevices],
      done_place[ogc::kMaxDevices];
  if (B <= 0 || B > 65535 || R <= 0 || n_dest <= 0 || chunk <= 0 ||
      chunk % kThreads || chunk > kMaxChunk || nc <= 0 ||
      (int64_t)nc * chunk < R || (int64_t)(nc - 1) * chunk >= R || dt < 32 ||
      dt % 32 || win <= 0 || win > kMaxWindow ||
      (win < n_dest && win % dt) || (int64_t)B * R >= INT32_MAX ||
      (int64_t)B * n_dest >= INT32_MAX || (size_t)nc * dt > 8192) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_tiles = (n_dest + dt - 1) / dt;
  int32_t* order = scratch;
  int32_t* start = order + (size_t)B * R;
  int32_t* H = start + (size_t)B * n_dest + 1;
  int32_t* cum = H + (size_t)B * nc * n_dest;
  const int ws = (win + 31) & ~31;
  const size_t count_smem = (size_t)4 * (ws / 32 + (win + dt - 1) / dt) +
                            (size_t)2 * kWarps * ws;
  const size_t scan_smem = (size_t)4 * nc * (dt + 1);
  const size_t place_smem = (size_t)4 * ws + (size_t)2 * kWarps * ws;
  cudaError_t err;
  auto count = csr_count_kernel<Idx>;
  auto place = csr_place_kernel<Idx>;
  if ((err = opt_in(count, count_smem, done_count)) ||
      (err = opt_in(csr_scan_kernel, scan_smem, done_scan)) ||
      (err = opt_in(place, place_smem, done_place))) {
    return (int)err;
  }
  count<<<dim3(nc, B), kThreads, count_smem, stream>>>(
      idx, R, n_dest, chunk, nc, dt, win, n_tiles, H, cum);
  if ((err = cudaGetLastError())) return (int)err;
  csr_scan_kernel<<<dim3(n_tiles, B), kThreads, scan_smem, stream>>>(
      R, n_dest, nc, dt, n_tiles, H, cum, start);
  if ((err = cudaGetLastError())) return (int)err;
  place<<<dim3(nc, B), kThreads, place_smem, stream>>>(
      idx, R, n_dest, chunk, nc, win, H, order);
  return (int)cudaGetLastError();
}

int accumulate(const float* g, const int32_t* order, const int32_t* start,
               int rows, int C, int warp, float* out, cudaStream_t stream) {
  if (rows <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  if (!warp) {
    const int64_t n = (int64_t)rows * C;
    accumulate_thread_kernel<<<(unsigned)((n + kThreads - 1) / kThreads),
                               kThreads, 0, stream>>>(g, order, start, rows,
                                                      C, out);
    return (int)cudaGetLastError();
  }
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  switch (min(8, (C + 31) / 32)) {
#define OGC_ACC_CASE(q)                                        \
  case q:                                                      \
    accumulate_warp_kernel<q><<<blocks, kThreads, 0, stream>>>( \
        g, order, start, rows, C, out);                        \
    break;
    OGC_ACC_CASE(1) OGC_ACC_CASE(2) OGC_ACC_CASE(3) OGC_ACC_CASE(4)
    OGC_ACC_CASE(5) OGC_ACC_CASE(6) OGC_ACC_CASE(7) OGC_ACC_CASE(8)
#undef OGC_ACC_CASE
  }
  return (int)cudaGetLastError();
}

int csr_any(const void* idx, int idx64, int B, int R, int n_dest, int chunk,
            int nc, int dt, int win, int32_t* scratch, cudaStream_t stream) {
  return idx64 ? csr((const int64_t*)idx, B, R, n_dest, chunk, nc, dt, win,
                     scratch, stream)
               : csr((const int32_t*)idx, B, R, n_dest, chunk, nc, dt, win,
                     scratch, stream);
}

}  // namespace

// The CSR of idx (B, R) (int64 if idx64, else int32) over n_dest
// destinations, into `scratch` (int32, ops/scatter.py::csr_plan's words):
// order (B * R: flattened source rows b * R + r, destination-major,
// ascending r), start (B * n_dest + 1: each destination's first entry),
// then the chunks' counts.  Launches csr_count, csr_scan and csr_place on
// `stream`; returns the first CUDA error (0 on success).
extern "C" int ogc_scatter_csr(const void* idx, int idx64, int B, int R,
                               int n_dest, int chunk, int nc, int dt, int win,
                               void* scratch, void* stream) {
  return csr_any(idx, idx64, B, R, n_dest, chunk, nc, dt, win,
                 (int32_t*)scratch, (cudaStream_t)stream);
}

// out (rows, C) f32 = each destination's segment of g (.., C) f32 rows
// summed in order; order and start as ogc_scatter_csr writes them.  `warp`
// 1 takes a warp per destination row, 0 a thread per (row, channel).
extern "C" int ogc_scatter_accumulate(const void* g, const void* order,
                                      const void* start, int rows, int C,
                                      int warp, void* out, void* stream) {
  return accumulate((const float*)g, (const int32_t*)order,
                    (const int32_t*)start, rows, C, warp, (float*)out,
                    (cudaStream_t)stream);
}

// Both: g (B*R, C) f32 scattered by idx (B, R) into out (B*n_dest, C) f32.
extern "C" int ogc_scatter_add_rows(const void* idx, int idx64, const void* g,
                                    int B, int R, int n_dest, int C, int chunk,
                                    int nc, int dt, int win, int warp,
                                    void* scratch, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* s = (int32_t*)scratch;
  const int err = csr_any(idx, idx64, B, R, n_dest, chunk, nc, dt, win, s, st);
  if (err) return err;
  return accumulate((const float*)g, s, s + (size_t)B * R, B * n_dest, C,
                    warp, (float*)out, st);
}
