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
// Design: one block of 1024 threads per cloud.  x, y, z and min_d2 live in
// dynamic shared memory (16 B/point, 128 KB at N = 8192).  Each step is a
// block-wide (max value, min index) reduction: warp shuffles, then one warp
// over the per-warp winners.
//
// Bound on the H100: the npoint steps are sequential, and each one is a
// block reduction with two __syncthreads, so the kernel is bound by the
// latency of npoint block reductions, not by bytes or FLOPs.  Only B of the
// 132 SMs are busy (8 at the eval batch).  The design keeps every step's
// data in shared memory, so no step touches device memory except the one
// index it writes; splitting a cloud across a thread-block cluster to use
// more SMs per cloud is left for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float d2_rn(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Larger value wins; on equal values the lower index wins.
__device__ __forceinline__ void arg_max_merge(float& v, int& i, float ov,
                                              int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kThreads)
    fps_kernel(const float* __restrict__ xyz, int N, int npoint,
               int32_t* __restrict__ out) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + N;
  float* sz = sy + N;
  float* smin = sz + N;
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int s_last;

  const int b = blockIdx.x;
  const float* p = xyz + (size_t)b * N * 3;
  int32_t* o = out + (size_t)b * npoint;
  for (int j = threadIdx.x; j < N; j += kThreads) {
    sx[j] = p[3 * j];
    sy[j] = p[3 * j + 1];
    sz[j] = p[3 * j + 2];
    smin[j] = 1e10f;
  }
  if (threadIdx.x == 0) o[0] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int last = 0;
  for (int s = 1; s < npoint; ++s) {
    const float xl = sx[last], yl = sy[last], zl = sz[last];
    // min_d2 >= 0, so (-1, N) loses to every real candidate.
    float bv = -1.0f;
    int bi = N;
    for (int j = threadIdx.x; j < N; j += kThreads) {
      const float m = fminf(smin[j], d2_rn(sx[j] - xl, sy[j] - yl, sz[j] - zl));
      smin[j] = m;
      if (m > bv) {  // j ascends: strict > keeps this thread's lowest index
        bv = m;
        bi = j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      arg_max_merge(bv, bi, ov, oi);
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = red_v[lane];
      bi = red_i[lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        arg_max_merge(bv, bi, ov, oi);
      }
      if (lane == 0) {
        s_last = bi;
        o[s] = bi;
      }
    }
    __syncthreads();
    last = s_last;
  }
}

}  // namespace

// xyz: (B, N, 3) f32 contiguous; out: (B, npoint) int32.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int ogc_fps(const void* xyz, int B, int N, int npoint, void* out,
                       void* stream) {
  const size_t smem = (size_t)16 * N;
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fps_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)xyz, N, npoint, (int32_t*)out);
  return (int)cudaGetLastError();
}
