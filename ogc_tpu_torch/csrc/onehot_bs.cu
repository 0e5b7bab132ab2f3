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
// Scatter design: two launches, each index read once and each cotangent
// row once, no atomics and no sort.  1. bs_partition: a block of 8 warps
// per (cloud, piece of a unit's padded edges; a piece is the whole unit up
// to kPiece edges) reads the piece's indices once, clamps them, and
// partitions its real edges stably by destination group of kGroup rows
// (ogc::stable_partition, csr.cuh: per-warp 16-bit histograms with one
// writer per counter, a scan, ranks among equal-group lanes).  It writes the piece's entries in group order
// (each a real edge's cotangent row m * S + s, shifted, with its row in the
// group in the low bits) with coalesced stores, and the offsets of its
// ng + 1 group segments, to scratch the wrapper allocates.
// 2. bs_accumulate: a block of 8 warps per (cloud, destination group) lists
// the segments of the pieces whose unit's presence (written by #9) names
// the group's block, concatenates them in piece order, which keeps
// ascending edge order, and takes the list kTile entries at a time: each
// entry is found by a binary search over the segments' starts, the tile is
// partitioned stably by row in shared memory, the listed cotangent rows are
// copied to shared memory with cp.async, a chunk in flight while the
// previous one is summed (ogc::sum_staged), and each thread adds its
// (row, channel) pairs' segments in order, the sums carried in registers
// from tile to tile.  Groups of 16 rows spread a crowded block (the
// KITTI-SF smooth tables list some rows over a thousand times) over 8
// blocks, and measured faster on the card than groups of 32; staging keeps
// such a row's chain of adds in shared memory.
// Bound on the H100: bytes, the cotangent above all (read once, in
// destination order, so at random); the indices are read once and the
// entries written and read once.  Measured on the card, the partition takes
// about what #11's csr_count does on the same rows, and the sums are set by
// the random cotangent reads (chip_smoke.py's mxu profile).

#include <cuda_runtime.h>
#include <stdint.h>

#include "csr.cuh"
#include "gather_rows.cuh"

namespace {

constexpr int kCB = 128;
constexpr int kRQ = 32;  // query rows per unit of the presence
constexpr int kMaxC = 16;
constexpr int kGatherThreads = 256;
constexpr int kGatherWarps = kGatherThreads / 32;
constexpr int kPartThreads = 256;
constexpr int kPartWarps = kPartThreads / 32;
constexpr int kAccThreads = 256;
constexpr int kAccWarps = kAccThreads / 32;
constexpr int kPiece = 8192;      // padded edges a partition block takes
constexpr int kMaxGroups = 4096;  // destination groups a cloud
constexpr int kMaxPieces = 4096;  // pieces a cloud
constexpr int kTile = 2048;       // list entries an accumulation block sorts
constexpr int kLg = 4;            // a destination group is 2^kLg rows
constexpr int kGroup = 1 << kLg;
constexpr int kMaxPairs = kGroup * kMaxC / kAccThreads;  // sums a thread
constexpr int kStageFloats = 8192;  // cotangent values staged at a time

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

// Dynamic shared memory of the two scatter kernels.
__host__ __device__ constexpr int partition_smem(int piece, int ng) {
  return piece * 12 + kPartWarps * ((ng + 1) & ~1) * 2 +
         (ng + 1 + kPartWarps) * 4;
}

__host__ __device__ constexpr int accumulate_smem(int pieces) {
  return (2 * pieces + 1) * 4 + kTile * 8 + (kGroup + 1 + kAccWarps) * 4 +
         kStageFloats * 4 + kAccWarps * kGroup * 2;
}

// Piece p of a cloud (unit p / ppu, part p % ppu) covers padded edges
// [e0, e0 + len) of the cloud's table.
__device__ __forceinline__ void piece_edges(int p, int ppu, int piece,
                                            int unit_edges, int& e0,
                                            int& len) {
  const int u = p / ppu;
  const int q0 = (p - u * ppu) * piece;
  e0 = u * unit_edges + q0;
  len = min(piece, unit_edges - q0);
}

__global__ void __launch_bounds__(kPartThreads)
    bs_partition_kernel(const int32_t* __restrict__ idx, int n, int M, int S,
                        int s_pad, int piece, int ppu, int pieces, int ng,
                        int32_t* __restrict__ ent,
                        int32_t* __restrict__ offs) {
  extern __shared__ uint4 smem_p[];
  const int ws = (ng + 1) & ~1;
  int32_t* s_i = reinterpret_cast<int32_t*>(smem_p);  // piece: row or -1
  int32_t* s_pk = s_i + piece;   // piece: the entry of a real edge
  int32_t* s_out = s_pk + piece;  // piece: the entries in group order
  uint16_t* hist = reinterpret_cast<uint16_t*>(s_out + piece);  // warps x ws
  int32_t* s_start = reinterpret_cast<int32_t*>(hist + kPartWarps * ws);
  int32_t* s_wsum = s_start + ng + 1;
  const int p = blockIdx.x, b = blockIdx.y;
  const int unit_edges = kRQ * s_pad;
  int e0, len;
  piece_edges(p, ppu, piece, unit_edges, e0, len);
  const int32_t* ib = idx + (int64_t)b * (pieces / ppu) * unit_edges;
  // Indices are in [0, n) by contract; the clamp keeps a bad one in bounds,
  // as #9 and bs_prologue clamp.  Pad edges (m >= M or s >= S) go to no
  // group.  A real edge's entry: its cotangent row m * S + s, then its row
  // in the group in the low kLg bits.
  const int low = kGroup - 1;
  for (int t = threadIdx.x; t < len; t += kPartThreads) {
    const int e = e0 + t;
    const int m = e / s_pad;
    const int s = e - m * s_pad;
    const int v = min(max(__ldcs(ib + e), 0), n - 1);
    const bool real = m < M && s < S;
    s_i[t] = real ? v : -1;
    s_pk[t] = real ? ((m * S + s) << kLg) | (v & low) : 0;
  }
  __syncthreads();
  ogc::stable_partition<kPartWarps>(
      len, ng, [&](int t) { const int v = s_i[t]; return v < 0 ? -1 : v >> kLg; },
      hist, ws, s_start, s_wsum, [&](int pos, int t) { s_out[pos] = s_pk[t]; });
  int32_t* eb = ent + ((int64_t)b * pieces + p) * piece;
  for (int j = threadIdx.x; j < s_start[ng]; j += kPartThreads) {
    eb[j] = s_out[j];
  }
  int32_t* ob = offs + ((int64_t)b * pieces + p) * (ng + 1);
  for (int j = threadIdx.x; j <= ng; j += kPartThreads) ob[j] = s_start[j];
}

__global__ void __launch_bounds__(kAccThreads)
    bs_accumulate_kernel(const float* __restrict__ cot,
                         const uint8_t* __restrict__ presence,
                         const int32_t* __restrict__ ent,
                         const int32_t* __restrict__ offs, int n, int C,
                         int M, int S, int piece, int ppu, int pieces, int nb,
                         int ng, float* __restrict__ out) {
  extern __shared__ uint4 smem_a[];
  int32_t* s_pos = reinterpret_cast<int32_t*>(smem_a);  // pieces + 1
  int32_t* s_base = s_pos + pieces + 1;                   // pieces
  int32_t* s_ent = s_base + pieces;                       // kTile
  int32_t* s_sorted = s_ent + kTile;                      // kTile
  int32_t* s_start = s_sorted + kTile;                    // kGroup + 1
  int32_t* s_wsum = s_start + kGroup + 1;                 // kAccWarps
  float* s_val = reinterpret_cast<float*>(s_wsum + kAccWarps);
  uint16_t* hist = reinterpret_cast<uint16_t*>(s_val + kStageFloats);
  const int g = blockIdx.x, b = blockIdx.y;
  const int rows = min(kGroup, n - g * kGroup);
  const int blk = g * kGroup / kCB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nu = pieces / ppu;
  // The group's segment of every piece whose unit reaches its block: its
  // start in the piece (s_base) and its place in the concatenation (s_pos,
  // an exclusive scan over the pieces in order).
  const int K = (pieces + kAccThreads - 1) / kAccThreads;
  const int p0 = min(pieces, (int)threadIdx.x * K), p1 = min(pieces, p0 + K);
  int run = 0;
  for (int p = p0; p < p1; ++p) {
    int o0 = 0, o1 = 0;
    if (presence[((int64_t)b * nu + p / ppu) * nb + blk]) {
      const int32_t* o = offs + ((int64_t)b * pieces + p) * (ng + 1) + g;
      o0 = o[0];
      o1 = o[1];
    }
    s_base[p] = o0;
    s_pos[p] = o1 - o0;
    run += o1 - o0;
  }
  const int incl = ogc::warp_inclusive_scan(run);
  if (lane == 31) s_wsum[warp] = incl;
  __syncthreads();
  int before = incl - run;
  for (int w = 0; w < warp; ++w) before += s_wsum[w];
  for (int p = p0; p < p1; ++p) {
    const int cnt = s_pos[p];
    s_pos[p] = before;
    s_base[p] -= before;
    before += cnt;
  }
  if (threadIdx.x == kAccThreads - 1) s_pos[pieces] = before;
  __syncthreads();
  const int total = s_pos[pieces];
  const int32_t* entb = ent + (int64_t)b * pieces * piece;
  const float* cotb = cot + (int64_t)b * M * S * C;
  float acc[kMaxPairs];
#pragma unroll
  for (int k = 0; k < kMaxPairs; ++k) acc[k] = 0.0f;
  for (int t0 = 0; t0 < total; t0 += kTile) {
    const int len = min(kTile, total - t0);
    __syncthreads();  // the previous tile's sums have read s_sorted
#pragma unroll 4
    for (int t = threadIdx.x; t < len; t += kAccThreads) {
      const int q = t0 + t;
      int lo = 0, hi = pieces;  // s_pos[lo] <= q < s_pos[hi]
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (s_pos[mid] <= q) lo = mid; else hi = mid;
      }
      s_ent[t] = entb[(int64_t)lo * piece + s_base[lo] + q];
    }
    __syncthreads();
    ogc::stable_partition<kAccWarps>(
        len, rows, [&](int t) { return s_ent[t] & (kGroup - 1); }, hist,
        kGroup, s_start, s_wsum,
        [&](int pos, int t) { s_sorted[pos] = s_ent[t] >> kLg; });
    ogc::sum_staged(acc, rows * C, C, len, s_start,
                    [&](int s) { return s_sorted[s]; }, cotb, s_val,
                    kStageFloats / (2 * C));
  }
  float* o = out + ((int64_t)b * n + g * kGroup) * C;
#pragma unroll
  for (int k = 0; k < kMaxPairs; ++k) {
    const int p = threadIdx.x + k * kAccThreads;
    if (p < rows * C) o[p] = acc[k];
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
// (rows no edge addresses are 0).  Each unit's 32 * s_pad padded edges go
// in ppu pieces of `piece` (the last one ragged); destinations in groups
// of 16 rows, ng = ceil(n / 16); scratch (int32) holds B * nu * ppu * piece
// entries, then B * nu * ppu * (ng + 1) offsets (ops/blocksparse.py::
// bs_scatter_plan).  Requires n >= 1 and ng <= 4096 (n <= 65536),
// 1 <= C <= 16, M <= nu * 32, S <= s_pad, 1 <= piece <= 8192,
// ppu * piece >= 32 * s_pad > (ppu - 1) * piece, nu * ppu <= 4096,
// M * S < 2^27, nu * 32 * s_pad < 2^31, B <= 65535.  Launches bs_partition
// and bs_accumulate on `stream`; returns the first CUDA error (0 on
// success).
extern "C" int ogc_bs_scatter(const void* idx, const void* cot,
                              const void* presence, int B, int n, int C,
                              int M, int S, int s_pad, int nu, int nb,
                              int piece, int ppu, void* scratch, void* out,
                              void* stream) {
  const int64_t unit_edges = (int64_t)kRQ * s_pad;
  const int64_t ng = ((int64_t)n + kGroup - 1) / kGroup;
  if (B < 1 || B > 65535 || n < 1 || C < 1 || C > kMaxC || nu < 1 ||
      M > nu * kRQ || S > s_pad || nb != (n + kCB - 1) / kCB ||
      ng > kMaxGroups || piece < 1 || piece > kPiece || ppu < 1 ||
      (int64_t)M * S > (INT32_MAX >> kLg) ||
      (int64_t)ppu * piece < unit_edges ||
      (int64_t)(ppu - 1) * piece >= unit_edges ||
      (int64_t)nu * ppu > kMaxPieces ||
      (int64_t)nu * unit_edges >= ((int64_t)1 << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const int pieces = nu * ppu;
  int32_t* ent = (int32_t*)scratch;
  int32_t* offs = ent + (int64_t)B * pieces * piece;
  const int psmem = partition_smem(piece, (int)ng);
  const int asmem = accumulate_smem(pieces);
  static int done_p[ogc::kMaxDevices], done_a[ogc::kMaxDevices];
  cudaError_t err;
  if ((err = ogc::smem_opt_in(bs_partition_kernel, psmem, done_p)) ||
      (err = ogc::smem_opt_in(bs_accumulate_kernel, asmem, done_a))) {
    return (int)err;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  bs_partition_kernel<<<dim3(pieces, B), kPartThreads, psmem, st>>>(
      (const int32_t*)idx, n, M, S, s_pad, piece, ppu, pieces, (int)ng, ent,
      offs);
  if ((err = cudaGetLastError())) return (int)err;
  bs_accumulate_kernel<<<dim3((int)ng, B), kAccThreads, asmem, st>>>(
      (const float*)cot, (const uint8_t*)presence, ent, offs, n, C, M, S,
      piece, ppu, pieces, nb, (int)ng, (float*)out);
  return (int)cudaGetLastError();
}
