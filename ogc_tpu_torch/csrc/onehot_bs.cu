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
// index 0, as the JAX package does, and computes per tile the ascending
// list of blocks it reaches (`order`, the first min(count, 32) entries
// valid), the unclamped count, and which blocks each 32 rows reach.  Pad
// edges are skipped here: the output is (B, M, S, C), the cotangent is read
// unpadded.
//
// Gather design: one CTA per (cloud, tile).  A tile of at most 32 blocks
// stages them in shared memory (32 x 128 rows x C f32; C = 11 is 176 KiB,
// wider sources go in channel slabs that fit), coalesced.  Then, 2048 edges
// at a time, the threads resolve each edge's staged row (a binary search of
// its block in the tile's ascending list) and write the output in (edge,
// channel) order, coalesced, reading shared memory.  A tile past the cap
// reads its rows straight from device memory (L2): the JAX package sends
// the whole call to the plain gather then, the port only that tile, with
// the same bits.  Bound on the H100: bytes, the output above all (B x M x S
// x C x 4; 138 MB at the KITTI-SF smooth tables), written once.
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

namespace {

constexpr int kCB = 128;
constexpr int kQT = 256;
constexpr int kCap = 32;
constexpr int kRQ = 32;  // query rows per unit of the scatter's presence
constexpr int kMaxC = 16;
constexpr int kGatherThreads = 512;
constexpr int kChunk = 2048;
constexpr int kScatterThreads = 512;
constexpr int kWarps = kScatterThreads / 32;
constexpr int kRowWarps = kCB / 32;               // 4 warps cover the rows
constexpr int kChanGroups = kWarps / kRowWarps;   // and 4 the channels
constexpr int kLaneC = kMaxC / kChanGroups;       // sums per lane
constexpr int kSub = 4096;                        // edges staged at a time
constexpr int kPerWarp = kSub / kWarps;
constexpr int kPiece = 1024;                      // hits staged at a time
constexpr int kScatterSmem = (2 * kSub + kWarps) * 4 + kPiece * kMaxC * 4;
constexpr int kSmemLimit = 232448;    // opt-in dynamic shared memory, H100
constexpr int kGatherFixed = (kCap + 2 * kChunk) * 4;

__global__ void __launch_bounds__(kGatherThreads)
    bs_gather_kernel(const float* __restrict__ src,
                     const int32_t* __restrict__ idx,
                     const int32_t* __restrict__ order,
                     const int32_t* __restrict__ nblk, int N, int C, int M,
                     int S, int s_pad, int nt, int cs,
                     float* __restrict__ out) {
  extern __shared__ uint4 smem_g[];
  int32_t* s_order = reinterpret_cast<int32_t*>(smem_g);  // kCap
  int32_t* s_row = s_order + kCap;                         // kChunk
  int32_t* s_out = s_row + kChunk;                         // kChunk
  float* s_src = reinterpret_cast<float*>(s_out + kChunk);
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int cnt = nblk[b * nt + t];
  const bool staged = cnt <= kCap;
  if (staged) {
    for (int j = threadIdx.x; j < cnt; j += kGatherThreads) {
      s_order[j] = order[((int64_t)b * nt + t) * kCap + j];
    }
  }
  const int tile_edges = kQT * s_pad;
  const int e_tile = t * tile_edges;
  const int32_t* idxb = idx + (int64_t)b * nt * tile_edges;
  const float* srcb = src + (int64_t)b * N * C;
  float* outb = out + (int64_t)b * M * S * C;
  const int width = staged ? cs : C;
  for (int c0 = 0; c0 < C; c0 += width) {
    const int w = min(width, C - c0);
    __syncthreads();  // s_order is written; the previous slab is consumed
    if (staged) {
      const int per_block = kCB * w;
      for (int u = threadIdx.x; u < cnt * per_block; u += kGatherThreads) {
        const int j = u / per_block;
        const int rem = u - j * per_block;
        const int r = rem / w;
        const int row = s_order[j] * kCB + r;
        const int c = rem - r * w;
        s_src[u] = row < N ? srcb[(int64_t)row * C + c0 + c] : 0.0f;
      }
    }
    for (int e0 = 0; e0 < tile_edges; e0 += kChunk) {
      const int len = min(kChunk, tile_edges - e0);
      __syncthreads();  // the slab is staged; the last chunk is consumed
      for (int j = threadIdx.x; j < len; j += kGatherThreads) {
        const int e = e_tile + e0 + j;  // padded edge index in the cloud
        const int m = e / s_pad;
        const int s = e - m * s_pad;
        s_out[j] = (m < M && s < S) ? m * S + s : -1;
        // Indices are in [0, N) by contract; the clamp keeps a bad one in
        // bounds (the prologue clamps the same way, so its block is listed).
        int i = min(max(idxb[e], 0), N - 1);
        if (staged) {
          const int blk = i / kCB;
          int lo = 0, hi = cnt - 1;  // lower bound: the block is listed
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (s_order[mid] < blk) {
              lo = mid + 1;
            } else {
              hi = mid;
            }
          }
          i = lo * kCB + (i - blk * kCB);
        }
        s_row[j] = i;
      }
      __syncthreads();
      for (int u = threadIdx.x; u < len * w; u += kGatherThreads) {
        const int j = u / w;
        const int c = u - j * w;
        const int o = s_out[j];
        if (o < 0) continue;
        outb[(int64_t)o * C + c0 + c] =
            staged ? s_src[s_row[j] * w + c]
                   : srcb[(int64_t)s_row[j] * C + c0 + c];
      }
    }
  }
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

// src (B, N, C) f32; idx (B, nt * 256 * s_pad) int32, the padded table;
// order (B, nt, 32) int32, each tile's blocks ascending; nblk (B, nt) int32,
// their unclamped count; out (B, M, S, C) f32.  Requires N >= 1,
// 1 <= C <= 16, M <= nt * 256, S <= s_pad, nt * 256 * s_pad < 2^31.
// Launches on `stream` and returns the CUDA error (0 on success).
extern "C" int ogc_bs_gather(const void* src, const void* idx,
                             const void* order, const void* nblk, int B,
                             int N, int C, int M, int S, int s_pad, int nt,
                             void* out, void* stream) {
  if (B < 1 || N < 1 || C < 1 || C > kMaxC || nt < 1 || M > nt * kQT ||
      S > s_pad || (int64_t)nt * kQT * s_pad >= ((int64_t)1 << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const int nb = (N + kCB - 1) / kCB;
  const int slots = nb < kCap ? nb : kCap;
  int cs = (kSmemLimit - kGatherFixed) / (slots * kCB * 4);
  cs = cs < C ? cs : C;
  const int smem = kGatherFixed + slots * kCB * cs * 4;
  // Set on every launch: the attribute is per device, and the call is cheap.
  cudaError_t err = cudaFuncSetAttribute(
      bs_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nt, B);
  bs_gather_kernel<<<grid, kGatherThreads, smem, (cudaStream_t)stream>>>(
      (const float*)src, (const int32_t*)idx, (const int32_t*)order,
      (const int32_t*)nblk, N, C, M, S, s_pad, nt, cs, (float*)out);
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
  // Set on every launch: the attribute is per device, and the call is cheap.
  const cudaError_t err = cudaFuncSetAttribute(
      bs_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kScatterSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nb, B);
  bs_scatter_kernel<<<grid, kScatterThreads, kScatterSmem,
                      (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const float*)cot, (const uint8_t*)presence, n, C,
      M, S, s_pad, nu, nb, (float*)out);
  return (int)cudaGetLastError();
}
