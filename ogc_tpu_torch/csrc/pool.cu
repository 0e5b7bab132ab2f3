// Row-group pooling of grouped neighbour features on Hopper.
//
// Replaces the Pallas TPU kernel ogc_tpu/ops/pallas_pool.py::_pool_kernel
// (entry points rowgroup_pool / pool_neighbors).
//
// Contract: x (G * S, C) rows, group-major, float32 or bfloat16; scale (C)
// float32 or absent; add (1, C) or (G, C) in x's type, or absent ->
//   out[g, c] = reduce_s act(x[g * S + s, c] * scale[c] + add[g | 0, c])
// in x's type, act = ReLU or identity, reduce = max or mean.  Everything is
// float32 inside: the product and the sum are pinned with __fmul_rn /
// __fadd_rn (nvcc would contract them to an FMA), an absent scale is a
// product with 1.0f and an absent add a sum with +0.0f (not skipped: -0.0 +
// 0.0 is +0.0, and the JAX chain adds its zeros), the mean is a float32 sum
// in ascending s from the s = 0 value, divided by S (__fdiv_rn), and the
// result is rounded once to x's type (round to nearest).  NaN: ReLU keeps a
// NaN (v <= 0 ? +0.0 : v, so a NaN and every v > 0 pass, and -0.0 becomes
// +0.0) and the max propagates one (acc > v || acc != acc ? acc : v), as
// torch.amax and jnp.max do; fmaxf would drop it.  Equal values keep the
// later one, as torch's sequential combine does; only +-0.0 can tell them
// apart.  The plain version in ops/pool.py does the same operations in the
// same order, so the two are bit-equal in both modes and both types.
//
// Design: one thread per (group, 16-byte chunk of channels): 4 float32 or
// 8 bfloat16 channels, so a warp reads whole 128-byte lines of a row with
// one 16-byte load per lane (C = 16 float32: a warp spans 8 groups, 64
// contiguous bytes each).  S is a template constant for 4, 8, 16 and 32 (the
// flow path's sizes), so the loop over the group's rows is unrolled and a
// batch of 8 row loads per thread is in flight at once; any other S takes a
// runtime-S instance.  A chunk of C % (16 / size) channels, or a pointer
// off the 16-byte grid, takes the scalar instance (one channel per thread,
// the same code with a 1-wide chunk).  The host picks the instance
// (ops/pool.py::pool_plan) and passes it; index arithmetic is 32-bit (the
// host checks the sizes), the group's row offset 64-bit.
//
// Bound on the H100: bytes -- every row is read once and every pooled row
// written once, (G * S + G) * C * size bytes over 3.35 TB/s; the
// arithmetic (2-3 operations per element) is far below the FP32 rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "chunks.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBatch = 8;  // row loads in flight per thread

using ogc::load_chunk;
using ogc::store_chunk;

// The scale's V floats (float32 whatever x's type): one or two 16-byte
// loads, or a scalar.
template <int V>
__device__ __forceinline__ void load_scale(const float* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = p[0];
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 r = *reinterpret_cast<const float4*>(p + i);
      v[i] = r.x; v[i + 1] = r.y; v[i + 2] = r.z; v[i + 3] = r.w;
    }
  }
}

template <int V>
__device__ __forceinline__ void pool_step(float (&acc)[V],
                                          const float (&x)[V],
                                          const float (&k)[V],
                                          const float (&a)[V], bool relu,
                                          bool mean, bool first) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float v = __fadd_rn(__fmul_rn(x[i], k[i]), a[i]);
    if (relu) v = v <= 0.0f ? 0.0f : v;
    if (first)
      acc[i] = v;
    else if (mean)
      acc[i] = __fadd_rn(acc[i], v);
    else
      acc[i] = (acc[i] > v || acc[i] != acc[i]) ? acc[i] : v;
  }
}

// S_T > 0: S fixed at compile time; S_T == 0: s_rt rows per group.
template <typename T, int V, int S_T>
__global__ void __launch_bounds__(kThreads)
    rowgroup_pool_kernel(const T* __restrict__ x,
                         const float* __restrict__ scale,
                         const T* __restrict__ add, int add_per_group,
                         int n_groups, int s_rt, int C, int relu, int mean,
                         T* __restrict__ out) {
  const int S = S_T > 0 ? S_T : s_rt;
  const unsigned chunks = (unsigned)(C / V);
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= (unsigned)n_groups * chunks) return;
  const unsigned g = t / chunks;
  const int c0 = (int)(t - g * chunks) * V;
  float k[V], a[V];
  if (scale != nullptr) {
    load_scale<V>(scale + c0, k);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) k[i] = 1.0f;
  }
  if (add != nullptr) {
    load_chunk<V>(add + (add_per_group ? (size_t)g * C : 0) + c0, a);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) a[i] = 0.0f;
  }
  const T* row = x + (size_t)g * S * C + c0;
  const bool rl = relu != 0, mn = mean != 0;
  float acc[V];
  if constexpr (S_T > 0) {
    constexpr int B = S_T < kBatch ? S_T : kBatch;
#pragma unroll
    for (int s0 = 0; s0 < S_T; s0 += B) {
      float v[B][V];
#pragma unroll
      for (int j = 0; j < B; ++j) load_chunk<V>(row + (s0 + j) * C, v[j]);
#pragma unroll
      for (int j = 0; j < B; ++j) pool_step<V>(acc, v[j], k, a, rl, mn,
                                               s0 + j == 0);
    }
  } else {
    float v[V];
    load_chunk<V>(row, v);
    pool_step<V>(acc, v, k, a, rl, mn, true);
#pragma unroll 4
    for (int s = 1; s < S; ++s) {
      load_chunk<V>(row + (size_t)s * C, v);
      pool_step<V>(acc, v, k, a, rl, mn, false);
    }
  }
  if (mn) {
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = __fdiv_rn(acc[i], (float)S);
  }
  store_chunk<V>(out + (size_t)g * C + c0, acc);
}

template <typename T, int V, int S_T>
cudaError_t launch(const void* x, const void* scale, const void* add,
                   int add_per_group, int n_groups, int S, int C, int relu,
                   int mean, void* out, cudaStream_t stream) {
  const int64_t n = (int64_t)n_groups * (C / V);
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  const T* xt = (const T*)x;
  const float* sc = (const float*)scale;
  const T* ad = (const T*)add;
  T* o = (T*)out;
  void* args[] = {&xt, &sc, &ad, &add_per_group, &n_groups, &S, &C,
                  &relu, &mean, &o};
  // cudaLaunchKernel returns the launch's own error: no second call.
  return cudaLaunchKernel((const void*)rowgroup_pool_kernel<T, V, S_T>, grid,
                          dim3(kThreads), args, 0, stream);
}

template <typename T, int V>
cudaError_t launch_s(int s_t, const void* x, const void* scale,
                     const void* add, int add_per_group, int n_groups, int S,
                     int C, int relu, int mean, void* out,
                     cudaStream_t stream) {
  switch (s_t) {
    case 0:
      return launch<T, V, 0>(x, scale, add, add_per_group, n_groups, S, C,
                             relu, mean, out, stream);
    case 4:
      return launch<T, V, 4>(x, scale, add, add_per_group, n_groups, S, C,
                             relu, mean, out, stream);
    case 8:
      return launch<T, V, 8>(x, scale, add, add_per_group, n_groups, S, C,
                             relu, mean, out, stream);
    case 16:
      return launch<T, V, 16>(x, scale, add, add_per_group, n_groups, S, C,
                              relu, mean, out, stream);
    case 32:
      return launch<T, V, 32>(x, scale, add, add_per_group, n_groups, S, C,
                              relu, mean, out, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x (n_groups * S, C) float32 or bfloat16, contiguous; scale (C) float32 or
// null (1.0); add (1 or n_groups, C) in x's type or null (+0.0); out
// (n_groups, C) in x's type.  s_t: the compiled S (4, 8, 16, 32, equal to S)
// or 0 (runtime S).  flags: 1 bfloat16, 2 ReLU, 4 mean (else max), 8 a
// per-group add (n_groups rows), 16 16-byte chunks (C * size % 16 == 0 and
// every pointer 16-byte aligned; else one channel per thread).  Requires
// n_groups * C < 2^31.  Launches on `stream` and returns the launch's
// error (0 on success).
extern "C" int ogc_rowgroup_pool(const void* x, const void* scale,
                                 const void* add, int n_groups, int S, int C,
                                 int s_t, int flags, void* out,
                                 void* stream) {
  if (n_groups <= 0 || S <= 0 || C <= 0 || (s_t != 0 && s_t != S) ||
      (int64_t)n_groups * C >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  const int bf16 = flags & 1, relu = (flags >> 1) & 1,
            mean = (flags >> 2) & 1, per_group = (flags >> 3) & 1,
            vec = (flags >> 4) & 1;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    if (vec) {
      if (C % 8) return (int)cudaErrorInvalidValue;
      return (int)launch_s<__nv_bfloat16, 8>(s_t, x, scale, add, per_group,
                                             n_groups, S, C, relu, mean, out,
                                             st);
    }
    return (int)launch_s<__nv_bfloat16, 1>(s_t, x, scale, add, per_group,
                                           n_groups, S, C, relu, mean, out,
                                           st);
  }
  if (vec) {
    if (C % 4) return (int)cudaErrorInvalidValue;
    return (int)launch_s<float, 4>(s_t, x, scale, add, per_group, n_groups,
                                   S, C, relu, mean, out, st);
  }
  return (int)launch_s<float, 1>(s_t, x, scale, add, per_group, n_groups, S,
                                 C, relu, mean, out, st);
}
