// Block-sparse row gather and its deterministic scatter-add on Hopper: the
// smooth-loss edge grouping of a Morton-sorted cloud (the "mxu" edge
// engine, losses/seg_unsup.py::_smooth_mxu).
//
// Replaces the Pallas TPU kernels ogc_tpu/ops/pallas_onehot.py::
// _bs_gather_kernel (#9, via _bs_gather_call) and ::_bs_scatter_kernel
// (#10, via _bs_scatter_call), the forward and backward of
// group_blocksparse.  On the TPU both are one-hot matrix products against
// the 128-row source blocks that a tile of 256 query rows reaches (at most
// 32, listed by _bs_prologue from the table itself); that was the TPU's way
// around its slow random-row gather, not the contract.  The contract:
//
//   gather   out[b, m, s, :] = src[b, idx[b, m, s], :]            (bit-equal)
//   scatter  out[b, r, :] = sum over edges (m, s) with idx[b, m, s] == r of
//            cot[b, m, s, :], in ascending edge order m * S + s, f32, from
//            0.0f, each add __fadd_rn
//
// The scatter order is the port's scatter contract (ops/scatter.py, #11),
// so #10 is bit-equal to #11 and to scatter_add_rows_plain.  The wrapper
// (ops/blocksparse.py) pads the table to 256-row tiles and an even S with
// index 0, as the JAX package does.  Pad edges are not gathered or
// scattered: the output is (B, M, S, C), the cotangent is read unpadded.
//
// Gather design: the gather writes B x M x S x C f32 once (138 MB at the
// KITTI-SF smooth tables) and reads a source of 1.4 MB, which stays in L2;
// the rows of a Morton-sorted unit of 32 query rows come mostly from L1.
// So the bound is bytes, the output above all, and the design stages no
// source block and has no cap: one block of 8 warps per (cloud, unit of 32
// padded table rows), about 16 KiB of shared memory, so that eight blocks
// share an SM and one's stores overlap another's loads.  The block walks
// its unit in pieces of at most 4096 padded edges (one piece at KITTI-SF):
// it reads each index once, 16 bytes at a time, clamps it, marks its block
// in the unit's presence row in shared memory, and puts the real edges'
// rows in order; ogc::copy_rows (gather_rows.cuh, C fixed at compile time,
// a template over 1..16) then writes the piece's output, which is
// contiguous, with 16-byte streaming stores.  Last the block writes its
// presence row whole: (B, nu, nb) uint8, whether rows [32 u, 32 u + 32) of
// the padded table reach block j, which is what #10 reads.  So the forward
// is one launch after bs_pad, with no torch prologue.
//
// Scatter design: one CTA per (cloud, block of 128 destination rows), 16
// warps: warp w sums rows (w % 4) * 32 + lane of the block in channels
// w / 4, w / 4 + 4, ... (C <= 16), in registers; the (row, channel) sums are
// independent, so splitting the channels changes no bit.  The CTA walks
// only the units of 32 table rows whose presence flag names its block, in
// ascending order, 4096 edges at a time: the indices go to shared memory,
// the warps compact
// the edges addressed to the block into a list in ascending order (ballots
// and a prefix over the warps), the CTA stages the listed cotangent rows
// (1024 at a time, every load in flight at once), and each warp takes the
// list 32 entries at a time as #8 does (onehot.cu): six ballots give every
// lane the mask of the entries addressed to its row, which it adds in
// ascending order from shared memory.  Each cotangent row is read once in
// all; no atomics, no sort: the walk fixes the order, and the results
// repeat bit for bit.  Bound on the H100: bytes (the cotangent read once,
// the indices, the output); the index re-reads of each block's tiles come
// from L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gather_rows.cuh"

namespace {

constexpr int kCB = 128;
constexpr int kRQ = 32;  // query rows per unit of the presence
constexpr int kMaxC = 16;
constexpr int kGatherThreads = 256;
constexpr int kGatherWarps = kGatherThreads / 32;
constexpr int kScatterThreads = 512;
constexpr int kWarps = kScatterThreads / 32;
constexpr int kRowWarps = kCB / 32;               // 4 warps cover the rows
constexpr int kChanGroups = kWarps / kRowWarps;   // and 4 the channels
constexpr int kLaneC = kMaxC / kChanGroups;       // sums per lane
constexpr int kSub = 4096;                        // edges staged at a time
constexpr int kPerWarp = kSub / kWarps;
constexpr int kPiece = 1024;                      // hits staged at a time
constexpr int kScatterSmem = (2 * kSub + kWarps) * 4 + kPiece * kMaxC * 4;

// The output position of padded edge e (row e / s_pad, slot e % s_pad) of a
// cloud: the count of real edges (slot < S) before it, row-major.
__device__ __forceinline__ int out_edge(int e, int s_pad, int S) {
  const int m = e / s_pad;
  return m * S + min(e - m * s_pad, S);
}

template <int C>
__global__ void __launch_bounds__(kGatherThreads)
    bs_gather_kernel(const uint32_t* __restrict__ src,
                     const int32_t* __restrict__ idx, int N, int M, int S,
                     int s_pad, int nu, int nb, int piece,
                     uint32_t* __restrict__ out,
                     uint8_t* __restrict__ presence) {
  extern __shared__ uint4 smem_g[];
  uint32_t* s_buf = reinterpret_cast<uint32_t*>(smem_g);  // warps x 128
  int32_t* s_row = reinterpret_cast<int32_t*>(
      s_buf + kGatherWarps * ogc::kWarpWords);             // piece
  uint8_t* s_pres = reinterpret_cast<uint8_t*>(s_row + piece);  // nb
  const int u = blockIdx.x;
  const int b = blockIdx.y;
  const int unit_edges = kRQ * s_pad;
  const int e_unit = u * unit_edges;  // padded edge index in the cloud
  const int q_end = M * S;            // real edges of the cloud
  const int32_t* idxb = idx + (int64_t)b * nu * unit_edges;
  const uint32_t* srcb = src + (int64_t)b * N * C;
  uint32_t* outb = out + (int64_t)b * q_end * C;
  for (int j = threadIdx.x; j < nb; j += kGatherThreads) s_pres[j] = 0;
  for (int p0 = 0; p0 < unit_edges; p0 += piece) {
    const int e0 = e_unit + p0;
    const int len = min(piece, unit_edges - p0);  // a multiple of 4
    const int q0 = min(out_edge(e0, s_pad, S), q_end);
    const int q1 = min(out_edge(e0 + len, s_pad, S), q_end);
    __syncthreads();  // s_pres is zeroed; the last piece is consumed
    // Each index once, four at a time where the table is 16-byte aligned
    // (then every piece is: e0 is a multiple of 4).  Indices are in [0, N)
    // by contract; the clamp keeps a bad one in bounds, as bs_prologue
    // clamps.  Every padded edge marks its block; the real ones go to
    // s_row at their output position.
    const bool wide = (reinterpret_cast<uintptr_t>(idxb) & 15) == 0;
    for (int t = threadIdx.x; t < len / 4; t += kGatherThreads) {
      int v[4];
      if (wide) {
        const int4 w = __ldcs(reinterpret_cast<const int4*>(idxb + e0) + t);
        v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = __ldcs(idxb + e0 + 4 * t + j);
      }
      int e = e0 + 4 * t;
      int m = e / s_pad;
      int s = e - m * s_pad;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = min(max(v[j], 0), N - 1);
        s_pres[i / kCB] = 1;  // every writer stores the same 1
        if (s < S && m < M) s_row[m * S + s - q0] = i;
        if (++s == s_pad) s = 0, ++m;
      }
    }
    __syncthreads();
    ogc::copy_rows<C>(outb + (int64_t)q0 * C, srcb, s_row, q1 - q0,
                      s_buf + (threadIdx.x >> 5) * ogc::kWarpWords);
  }
  __syncthreads();
  uint8_t* pres = presence + ((int64_t)b * nu + u) * nb;
  for (int j = threadIdx.x; j < nb; j += kGatherThreads) pres[j] = s_pres[j];
}

__global__ void __launch_bounds__(kScatterThreads)
    bs_scatter_kernel(const int32_t* __restrict__ idx,
                      const float* __restrict__ cot,
                      const uint8_t* __restrict__ presence, int n, int C,
                      int M, int S, int s_pad, int nu, int nb,
                      float* __restrict__ out) {
  extern __shared__ uint4 smem_s[];
  int32_t* s_idx = reinterpret_cast<int32_t*>(smem_s);  // kSub: row or -1
  int32_t* s_list = s_idx + kSub;  // kSub: (offset in the sub-tile << 7) | row
  int* s_wcnt = s_list + kSub;     // kWarps
  float* s_cot = reinterpret_cast<float*>(s_wcnt + kWarps);  // kPiece * C
  const int blk = blockIdx.x;
  const int b = blockIdx.y;
  const int base = blk * kCB;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rw = warp % kRowWarps;  // rows rw * 32 + lane of the block
  const int cg = warp / kRowWarps;  // channels cg, cg + 4, cg + 8, cg + 12
  const unsigned below = (1u << lane) - 1u;
  const int unit_edges = kRQ * s_pad;
  const int32_t* idxb = idx + (int64_t)b * nu * unit_edges;
  const float* cotb = cot + (int64_t)b * M * S * C;
  const uint8_t* pres = presence + (int64_t)b * nu * nb + blk;
  float acc[kLaneC];
#pragma unroll
  for (int i = 0; i < kLaneC; ++i) acc[i] = 0.0f;
  for (int t = 0; t < nu; ++t) {
    if (!pres[(int64_t)t * nb]) continue;  // the same for the whole CTA
    for (int s0 = 0; s0 < unit_edges; s0 += kSub) {
      const int len = min(kSub, unit_edges - s0);
      const int e_sub = t * unit_edges + s0;
      __syncthreads();  // the previous sub-tile is consumed
      for (int j = threadIdx.x; j < len; j += kScatterThreads) {
        const int e = e_sub + j;
        const int m = e / s_pad;
        const int d = min(max(idxb[e], 0), n - 1) - base;
        // Pad edges (m >= M or s >= S) address no row.
        s_idx[j] = (m < M && e - m * s_pad < S) ? d : -1;
      }
      __syncthreads();
      // Compact the sub-tile's edges addressed to this block, in ascending
      // order: warp w owns [w * kPerWarp, (w + 1) * kPerWarp).
      int cnt = 0;
      for (int r = 0; r < kPerWarp; r += 32) {
        const int j = warp * kPerWarp + r + lane;
        const bool hit = j < len && (unsigned)s_idx[j] < (unsigned)kCB;
        cnt += __popc(__ballot_sync(0xffffffffu, hit));
      }
      if (lane == 0) s_wcnt[warp] = cnt;
      __syncthreads();
      int off = 0, total = 0;
      for (int w = 0; w < kWarps; ++w) {
        off += w < warp ? s_wcnt[w] : 0;
        total += s_wcnt[w];
      }
      for (int r = 0; r < kPerWarp; r += 32) {
        const int j = warp * kPerWarp + r + lane;
        const bool hit = j < len && (unsigned)s_idx[j] < (unsigned)kCB;
        const unsigned bal = __ballot_sync(0xffffffffu, hit);
        if (hit) s_list[off + __popc(bal & below)] = (j << 7) | s_idx[j];
        off += __popc(bal);
      }
      for (int p0 = 0; p0 < total; p0 += kPiece) {
        const int plen = min(kPiece, total - p0);
        __syncthreads();  // the list is complete; the last piece consumed
        // The piece's cotangent rows, all loads in flight together.
        for (int u = threadIdx.x; u < plen * C; u += kScatterThreads) {
          const int q = u / C;
          const int e = e_sub + (s_list[p0 + q] >> 7);
          const int m = e / s_pad;
          s_cot[u] = cotb[((int64_t)m * S + (e - m * s_pad)) * C + u - q * C];
        }
        __syncthreads();
        if (cg >= C) continue;  // no channel for this warp (C < 4)
        // 32 entries at a time, one per lane.  A ballot finds the entries
        // addressed to this warp's 32 rows; five more spell out each
        // entry's row bit by bit, so every lane gets the mask of its own
        // entries and adds them in ascending order, all lanes at once.
        for (int c0 = 0; c0 < plen; c0 += 32) {
          const int jj = c0 + lane;
          const int d =
              jj < plen ? (s_list[p0 + jj] & (kCB - 1)) - rw * 32 : -1;
          const bool hit = (unsigned)d < 32u;
          const unsigned hits = __ballot_sync(0xffffffffu, hit);
          if (hits == 0) continue;
          unsigned mine = hits;
#pragma unroll
          for (int k = 0; k < 5; ++k) {
            const unsigned bit =
                __ballot_sync(0xffffffffu, hit && ((d >> k) & 1));
            mine &= ((lane >> k) & 1) ? bit : ~bit;
          }
          while (mine) {
            const int j = __ffs(mine) - 1;
            mine &= mine - 1;
            const float* row = s_cot + (c0 + j) * C;
#pragma unroll
            for (int i = 0; i < kLaneC; ++i) {
              const int c = cg + i * kChanGroups;
              if (c < C) acc[i] = __fadd_rn(acc[i], row[c]);
            }
          }
        }
      }
    }
  }
  const int r = base + rw * 32 + lane;
  if (r < n) {
    float* o = out + ((int64_t)b * n + r) * C;
#pragma unroll
    for (int i = 0; i < kLaneC; ++i) {
      const int c = cg + i * kChanGroups;
      if (c < C) o[c] = acc[i];
    }
  }
}

}  // namespace

// src (B, N, C) f32; idx (B, nu * 32 * s_pad) int32, the padded table;
// out (B, M, S, C) f32; presence (B, nu, nb) uint8, nb = ceil(N / 128),
// written whole: whether rows [32 u, 32 u + 32) of the table reach block j.
// piece (a multiple of 4) padded edges are staged at a time in smem bytes
// of dynamic shared memory, at least the kernel's need (ops/blocksparse.py::
// bs_gather_plan).  Requires N >= 1, 1 <= C <= 16, s_pad even, M <= nu *
// 32, S <= s_pad, nu * 32 * s_pad < 2^31, N * C < 2^31.  Launches on
// `stream` and returns the CUDA error (0 on success).
extern "C" int ogc_bs_gather(const void* src, const void* idx, int B, int N,
                             int C, int M, int S, int s_pad, int nu,
                             int piece, int smem, void* out, void* presence,
                             void* stream) {
  const int nb = (N + kCB - 1) / kCB;
  if (B < 1 || N < 1 || C < 1 || C > kMaxC || nu < 1 || M > nu * kRQ ||
      S > s_pad || s_pad % 2 || piece < 4 || piece % 4 ||
      (int64_t)nu * kRQ * s_pad >= ((int64_t)1 << 31) ||
      (int64_t)N * C >= ((int64_t)1 << 31) ||
      smem < (kGatherWarps * ogc::kWarpWords + piece) * 4 + nb) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(nu, B);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
#define OGC_BS_CASE(c)                                                     \
  case c: {                                                                \
    static int done[ogc::kMaxDevices];                                     \
    const cudaError_t err =                                                \
        ogc::smem_opt_in(bs_gather_kernel<c>, smem, done);                 \
    if (err != cudaSuccess) return (int)err;                               \
    bs_gather_kernel<c><<<grid, kGatherThreads, smem, st>>>(               \
        (const uint32_t*)src, (const int32_t*)idx, N, M, S, s_pad, nu, nb, \
        piece, (uint32_t*)out, (uint8_t*)presence);                        \
    break;                                                                 \
  }
    OGC_BS_CASE(1) OGC_BS_CASE(2) OGC_BS_CASE(3) OGC_BS_CASE(4)
    OGC_BS_CASE(5) OGC_BS_CASE(6) OGC_BS_CASE(7) OGC_BS_CASE(8)
    OGC_BS_CASE(9) OGC_BS_CASE(10) OGC_BS_CASE(11) OGC_BS_CASE(12)
    OGC_BS_CASE(13) OGC_BS_CASE(14) OGC_BS_CASE(15) OGC_BS_CASE(16)
#undef OGC_BS_CASE
  }
  return (int)cudaGetLastError();
}

// idx (B, nu * 32 * s_pad) int32, the padded table; cot (B, M, S, C) f32;
// presence (B, nu, nb) uint8, whether rows [32 u, 32 u + 32) of the table
// reach block j, nb = ceil(n / 128); out (B, n, C) f32, every row written
// (rows no edge addresses are 0).  Requires n >= 1, 1 <= C <= 16,
// M <= nu * 32, S <= s_pad, nu * 32 * s_pad < 2^31.
extern "C" int ogc_bs_scatter(const void* idx, const void* cot,
                              const void* presence, int B, int n, int C,
                              int M, int S, int s_pad, int nu, int nb,
                              void* out, void* stream) {
  if (B < 1 || n < 1 || C < 1 || C > kMaxC || nu < 1 || M > nu * kRQ ||
      S > s_pad || nb != (n + kCB - 1) / kCB ||
      (int64_t)nu * kRQ * s_pad >= ((int64_t)1 << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  static int done[ogc::kMaxDevices];
  const cudaError_t err =
      ogc::smem_opt_in(bs_scatter_kernel, kScatterSmem, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nb, B);
  bs_scatter_kernel<<<grid, kScatterThreads, kScatterSmem,
                      (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const float*)cot, (const uint8_t*)presence, n, C,
      M, S, s_pad, nu, nb, (float*)out);
  return (int)cudaGetLastError();
}
