// Row-group pooling of grouped neighbour features on Hopper.
//
// Replaces the Pallas TPU kernel ogc_tpu/ops/pallas_pool.py::_pool_kernel
// (entry points rowgroup_pool / pool_neighbors).
//
// Contract: x (G * S, C) rows, group-major, float32 or bfloat16; scale (C)
// float32; add (1, C) or (G, C) in x's type ->
//   out[g, c] = reduce_s act(x[g * S + s, c] * scale[c] + add[g | 0, c])
// in x's type, act = ReLU or identity, reduce = max or mean.  Everything is
// float32 inside: the product and the sum are pinned with __fmul_rn /
// __fadd_rn (nvcc would contract them to an FMA), the mean is a sequential
// float32 sum in ascending s divided by S (__fdiv_rn), and the result is
// rounded once to x's type (round to nearest).  The plain version in
// ops/pool.py does the same operations in the same order, so the two are
// bit-equal in both modes and both types.
//
// Design: one thread per (group, channel), channels along threadIdx.x, so
// the 32 threads of a warp read 32 neighbouring channels of one row (one
// or two 128-byte lines) and walk the group's S rows in order.  The TPU
// kernel's blocking (G groups of 8-aligned rows per grid step, so that the
// sublane reshape is legal) is not needed: a thread reads any row.
//
// Bound on the H100: bytes -- every row is read once and every pooled row
// written once, (G * S + G) * C * size bytes over 3.35 TB/s; the
// arithmetic (2-3 operations per element) is far below the FP32 rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int64_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rowgroup_pool_kernel(const T* __restrict__ x,
                         const float* __restrict__ scale,
                         const T* __restrict__ add, int add_per_group,
                         int64_t n_groups, int S, int C, int relu, int mean,
                         T* __restrict__ out) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_groups * C) return;
  const int64_t g = t / C;
  const int c = (int)(t - g * C);
  const float k = scale[c];
  const float a = load(add, (add_per_group ? g * C : 0) + c);
  const T* row = x + g * S * C + c;
  float acc = mean ? 0.0f : -INFINITY;
  for (int s = 0; s < S; ++s) {
    float v = __fadd_rn(__fmul_rn(load(row, (int64_t)s * C), k), a);
    if (relu) v = v > 0.0f ? v : 0.0f;
    acc = mean ? __fadd_rn(acc, v) : fmaxf(acc, v);
  }
  if (mean) acc = __fdiv_rn(acc, (float)S);
  store(out, t, acc);
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, const void* add,
                   int add_per_group, int64_t n_groups, int S, int C,
                   int relu, int mean, void* out, cudaStream_t stream) {
  const int64_t n = n_groups * C;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  rowgroup_pool_kernel<T><<<blocks, kThreads, 0, stream>>>(
      (const T*)x, (const float*)scale, (const T*)add, add_per_group,
      n_groups, S, C, relu, mean, (T*)out);
  return cudaGetLastError();
}

}  // namespace

// x (n_groups * S, C) float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1),
// contiguous; scale (C) float32; add (add_per_group ? n_groups : 1, C) in
// x's type; out (n_groups, C) in x's type.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int ogc_rowgroup_pool(const void* x, int is_bf16,
                                 const void* scale, const void* add,
                                 int add_per_group, int n_groups, int S,
                                 int C, int relu, int mean, void* out,
                                 void* stream) {
  if (n_groups <= 0 || S <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(x, scale, add, add_per_group,
                                      n_groups, S, C, relu, mean, out, s);
  return (int)launch<float>(x, scale, add, add_per_group, n_groups, S, C,
                            relu, mean, out, s);
}
