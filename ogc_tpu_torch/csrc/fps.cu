// Furthest point sampling on Hopper.
//
// Replaces the Pallas TPU kernel ogc_tpu/ops/pallas_kernels.py::_fps_kernel
// (entry points furthest_point_sample_pallas / fps_pallas_chunked).
//
// Contract: (B, N, 3) f32 -> (B, npoint) int32.  Greedy FPS seeded at index
// 0; each step updates min_d2 = min(min_d2, ((dx*dx + dy*dy) + dz*dz)) and
// picks the LOWEST index among the maxima of min_d2 (the reference's strict
// `>` update, pointnet2/src/sampling_gpu.cu:136-137).  The d2 expression is
// pinned with __fmul_rn/__fadd_rn so that nvcc cannot contract it into FMAs:
// the result is bit-equal to the plain PyTorch version (ops/fps.py).
//
// Bound on the H100: the npoint steps are sequential, and each is an argmax
// over the whole cloud, so the time is npoint x (the SM's issue time for
// the cloud's ~12 instructions a point, plus the latency of one argmax
// across the CTA), not bytes or FLOPs.  One CTA takes a cloud; the design
// cuts the latency of a step:
//
// * Points in registers.  Thread t owns points j = t + k * T (k < PPT),
//   with x, y, z and min_d2 in registers (the loop fully unrolled); the
//   CTA's shared copy of the cloud (12 B a point) serves only the winner's
//   coordinates.  Above 8192 points (REG_XYZ false: 16 points a thread
//   over up to 1024 threads) x, y, z are read from that copy and only
//   min_d2 stays in registers.  The instances compiled are the ones
//   ops/fps.py::fps_plan takes: 1, 4, 8 and 32 points a thread in
//   registers, 16 from shared memory.
// * A thread's argmax as a tree of log2 PPT levels, the lower k on the
//   left of each merge (a strict > keeps it on a tie).
// * A warp argmax in two redux.sync.  min_d2 >= +0, so its float bits
//   order as unsigned integers: __reduce_max_sync takes the largest bits,
//   then __reduce_min_sync the lowest index among the lanes that hold them.
//   (A ballot of the holders and a shuffle from the first, with points
//   laid out so that lane order is index order, measured slower.)
// * One barrier a step.  Each warp's winner goes into a shared array
//   double-buffered by the step's parity; after the one barrier every warp
//   reduces the <= 32 winners itself, so no second barrier broadcasts the
//   result.  A buffer is rewritten two steps later, after a barrier that
//   every reader of it has passed.
//
// Up to 14464 points a cloud stays on one SM: spreading it over a
// thread-block cluster of 2-8 CTAs (the winners exchanged through
// distributed shared memory, with a cluster barrier or with mbarrier
// arrivals a step) measured slower at every path shape up to 8192 points,
// the exchange costing more than the issue time it spreads.  Sorting the
// cloud by a Morton code so that a thread whose points' bounding box lies
// beyond its largest min_d2 can skip a step gained little at 8192 points on
// uniform clouds and nothing on scene-like ones, for ~150 more lines; it was
// not kept.  ops/fps.py::fps_plan picks the instance.
//
// Larger clouds (the outdoor paths' full-resolution scenes, up to 131072
// points) take the CLUSTER instance: a cluster of C (4..16) CTAs a cloud,
// CTA r holding the consecutive points [r * S, r * S + S) with
// S = ceil(N / C), 32 points a thread in registers in the single-CTA
// layout (points t + k * T of its slice for thread t).  Each step a CTA
// reduces its slice's winner as above, thread 0 posts (bits, index, x, y,
// z) of it in the CTA's exchange slot (double-buffered by the step's
// parity, as `red`), one cluster barrier, and then every warp reads the C
// slots through distributed shared memory and reduces them with the same
// two redux.sync: the largest bits, then the lowest index.  So the winner,
// and with it the result, is the one a single CTA would pick.  The next
// step's centre comes from the winning slot, so no CTA reads another's
// cloud.  A slot is rewritten two steps later, after the barrier that
// every reader of it has passed; a last cluster barrier keeps every CTA's
// shared memory alive until the others have read it.  Above 8 CTAs (the
// portable size) the kernel opts in to non-portable cluster sizes.  The
// cluster barrier's cost grows with C (~2.0 us a step at 8 CTAs, ~3.5 at
// 15, against ~4.8 at 8 CTAs reading x, y, z from shared memory), so
// ops/fps.py::fps_plan takes as few CTAs as hold the cloud, but 4 at
// least.

// Padding points (j >= N, or past the CTA's slice) hold min_d2 = +0 and an
// index above every real one, so they never win: a real point's value is
// >= +0 and its index lower.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gather_rows.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoIndex = 0xffffffffu;
// Dynamic shared memory a CTA may use, next to the static `red`.
constexpr int kStaticSmem = 2 * 32 * 8;
constexpr int kMaxSmem = 227 * 1024 - 1024;
// The largest cluster: twice the portable limit of 8 (above it the kernel
// opts in to non-portable cluster sizes).
constexpr int kMaxCluster = 16;
constexpr int kPortableCluster = 8;

__device__ __forceinline__ float d2_rn(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// (largest bits, lowest index among the lanes that hold them) of the warp.
__device__ __forceinline__ void warp_argmax(unsigned& bits, unsigned& idx) {
  const unsigned top = __reduce_max_sync(kFull, bits);
  idx = __reduce_min_sync(kFull, bits == top ? idx : kNoIndex);
  bits = top;
}

// Threads a CTA may have, as many as fps_plan gives the instance: 32
// points a thread in registers need up to 255 registers (<= 256 threads).
template <int PPT, bool REG_XYZ>
constexpr int max_threads() {
  return !REG_XYZ ? 1024 : PPT == 32 ? 256 : 512;
}

// CLUSTER false: one CTA a cloud (blockIdx.x), S = N.  CLUSTER true: CTA
// blockIdx.x is rank blockIdx.x % C of cloud blockIdx.x / C, holding S
// points of it.
template <int PPT, bool REG_XYZ, bool CLUSTER>
__global__ void __launch_bounds__(max_threads<PPT, REG_XYZ>())
    fps_kernel(const float* __restrict__ xyz, int N, int npoint, int S,
               int32_t* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ uint2 red[2][32];
  static_assert(sizeof(red) == kStaticSmem, "kStaticSmem");
  // The exchange slots: (bits, index, x, y, z) of the CTA's winner.
  __shared__ unsigned xch[CLUSTER ? 2 : 1][CLUSTER ? 8 : 1];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int P = T * PPT;
  int cloud = blockIdx.x, C = 1, rank = 0, base = 0, cnt = N;
  if constexpr (CLUSTER) {
    C = (int)cooperative_groups::this_cluster().num_blocks();
    rank = (int)cooperative_groups::this_cluster().block_rank();
    cloud = blockIdx.x / C;
    base = rank * S;
    cnt = min(S, N - base);
  }
  float* sx = smem;
  float* sy = sx + P;
  float* sz = sy + P;
  const float* p = xyz + (size_t)cloud * N * 3;
  for (int j = tid; j < P; j += T) {
    const bool real = j < cnt;
    sx[j] = real ? p[3 * (base + j)] : 0.0f;
    sy[j] = real ? p[3 * (base + j) + 1] : 0.0f;
    sz[j] = real ? p[3 * (base + j) + 2] : 0.0f;
  }
  __syncthreads();

  float px[REG_XYZ ? PPT : 1], py[REG_XYZ ? PPT : 1], pz[REG_XYZ ? PPT : 1];
  float pm[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    pm[k] = tid + k * T < cnt ? 1e10f : 0.0f;
    if constexpr (REG_XYZ) {
      px[k] = sx[tid + k * T];
      py[k] = sy[tid + k * T];
      pz[k] = sz[tid + k * T];
    }
  }
  int32_t* o = out + (size_t)cloud * npoint;
  if (tid == 0 && rank == 0) o[0] = 0;
  const int warps = T >> 5;

  unsigned last = 0;
  // The centre of the step: point 0 first, then the last winner.
  float xl = p[0], yl = p[1], zl = p[2];
  for (int s = 1; s < npoint; ++s) {
    if constexpr (!CLUSTER) {
      xl = sx[last];
      yl = sy[last];
      zl = sz[last];
    }
    float bv[PPT];
    int bk[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      float xk, yk, zk;
      if constexpr (REG_XYZ) {
        xk = px[k];
        yk = py[k];
        zk = pz[k];
      } else {
        xk = sx[tid + k * T];
        yk = sy[tid + k * T];
        zk = sz[tid + k * T];
      }
      pm[k] = fminf(pm[k], d2_rn(xk - xl, yk - yl, zk - zl));
      bv[k] = pm[k];
      bk[k] = k;
    }
#pragma unroll
    for (int w = 1; w < PPT; w *= 2) {
#pragma unroll
      for (int k = 0; k + w < PPT; k += 2 * w) {
        if (bv[k + w] > bv[k]) {
          bv[k] = bv[k + w];
          bk[k] = bk[k + w];
        }
      }
    }
    unsigned bits = __float_as_uint(bv[0]);
    unsigned idx = (unsigned)(tid + bk[0] * T);
    if constexpr (CLUSTER) idx = (int)idx < cnt ? base + idx : kNoIndex;
    warp_argmax(bits, idx);
    uint2* buf = red[s & 1];
    if (lane == 0) buf[warp] = make_uint2(bits, idx);
    __syncthreads();
    const uint2 e = lane < warps ? buf[lane] : make_uint2(0u, kNoIndex);
    bits = e.x;
    idx = e.y;
    warp_argmax(bits, idx);
    if constexpr (CLUSTER) {
      auto cluster = cooperative_groups::this_cluster();
      unsigned* slot = xch[s & 1];
      if (tid == 0) {
        const int l = idx == kNoIndex ? 0 : (int)idx - base;
        slot[0] = bits;
        slot[1] = idx;
        slot[2] = __float_as_uint(sx[l]);
        slot[3] = __float_as_uint(sy[l]);
        slot[4] = __float_as_uint(sz[l]);
      }
      cluster.sync();
      unsigned cb = 0u, ci = kNoIndex, cx = 0u, cy = 0u, cz = 0u;
      if (lane < C) {
        const unsigned* r = cluster.map_shared_rank(slot, lane);
        cb = r[0];
        ci = r[1];
        cx = r[2];
        cy = r[3];
        cz = r[4];
      }
      bits = cb;
      idx = ci;
      warp_argmax(bits, idx);
      const int from = __ffs(__ballot_sync(kFull, ci == idx)) - 1;
      xl = __uint_as_float(__shfl_sync(kFull, cx, from));
      yl = __uint_as_float(__shfl_sync(kFull, cy, from));
      zl = __uint_as_float(__shfl_sync(kFull, cz, from));
    }
    last = idx;
    if (tid == 0 && rank == 0) o[s] = (int32_t)idx;
  }
  if constexpr (CLUSTER) cooperative_groups::this_cluster().sync();
}

template <int PPT, bool REG_XYZ, bool CLUSTER>
int launch(const float* xyz, int B, int N, int npoint, int T, int C,
           int32_t* out, cudaStream_t stream) {
  static int done[ogc::kMaxDevices];
  auto kernel = fps_kernel<PPT, REG_XYZ, CLUSTER>;
  const int S = (N + C - 1) / C;
  if (T < 32 || T % 32 || T > max_threads<PPT, REG_XYZ>() || T * PPT < S ||
      (CLUSTER ? C < 2 || C > kMaxCluster || (C - 1) * S >= N : C != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)12 * T * PPT;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  // The opt-in counts `red` too: 48 KiB of dynamic memory plus the static
  // 512 B is already over the default.
  cudaError_t err = ogc::smem_opt_in(
      kernel, (int)smem + kStaticSmem + (CLUSTER ? 64 : 4), done);
  if (err != cudaSuccess) return (int)err;
  static int nonportable[ogc::kMaxDevices];
  if (CLUSTER && C > kPortableCluster) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess && !(dev < ogc::kMaxDevices && nonportable[dev])) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err == cudaSuccess && dev < ogc::kMaxDevices) nonportable[dev] = 1;
    }
    if (err != cudaSuccess) return (int)err;
  }
  if constexpr (!CLUSTER) {
    kernel<<<B, T, smem, stream>>>(xyz, N, npoint, S, out);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(B * C));
    cfg.blockDim = dim3((unsigned)T);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, xyz, N, npoint, S, out);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

int dispatch(const float* x, int B, int N, int npoint, int ppt, int threads,
             int reg_xyz, int32_t* o, cudaStream_t st) {
  if (!reg_xyz) {
    return ppt == 16 ? launch<16, false, false>(x, B, N, npoint, threads, 1,
                                                o, st)
                     : (int)cudaErrorInvalidValue;
  }
  switch (ppt) {
    case 1: return launch<1, true, false>(x, B, N, npoint, threads, 1, o, st);
    case 4: return launch<4, true, false>(x, B, N, npoint, threads, 1, o, st);
    case 8: return launch<8, true, false>(x, B, N, npoint, threads, 1, o, st);
    case 32:
      return launch<32, true, false>(x, B, N, npoint, threads, 1, o, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// xyz: (B, N, 3) f32 contiguous; out: (B, npoint) int32.  The instance:
// `ppt` points a thread, `threads` a CTA (a multiple of 32), `reg_xyz` 1
// for x, y, z in registers (1, 4, 8 or 32 points a thread), 0 for x, y, z
// from shared memory (16 points a thread), `cluster` CTAs a cloud (1, or a
// cluster of 4..16 CTAs with 32 points a thread in registers, each holding
// ceil(N / cluster) points, none empty).  Launches on `stream` and returns
// the launch's CUDA error (0 on success).
extern "C" int ogc_fps(const void* xyz, int B, int N, int npoint, int ppt,
                       int threads, int reg_xyz, int cluster, void* out,
                       void* stream) {
  if (B <= 0 || N <= 0 || npoint <= 0 || npoint > N) {
    return (int)cudaErrorInvalidValue;
  }
  const float* x = (const float*)xyz;
  int32_t* o = (int32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (cluster == 1) {
    return dispatch(x, B, N, npoint, ppt, threads, reg_xyz, o, st);
  }
  return reg_xyz && ppt == 32
             ? launch<32, true, true>(x, B, N, npoint, threads, cluster, o,
                                      st)
             : (int)cudaErrorInvalidValue;
}
