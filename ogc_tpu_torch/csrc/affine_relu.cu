// FlowStep3D's eval BatchNorm + ReLU in one pass on Hopper.
//
// Replaces no TPU kernel: on the TPU, XLA fuses the eval norm's affine and
// the ReLU into the 1x1 product's epilogue; PyTorch's eager chains run them
// as separate passes over the whole (B, M, S, C) tensor.  This kernel serves
// the two chains of nn/flowstep3d.py's eval conv stacks (ops/affine_relu.py):
//
//   channel:  y = relu((((x - m) * r) * w) + b)     m, r, w, b (C)
//   rows:     y = relu(x + t[row / S])               t (rows / S, C)
//
// the first the layers that follow a 1x1 product (the SchedulableBatchNorm
// eval affine, r = rsqrt(running_var + eps) as torch computed it), the
// second the source-projected first layer's centre term.  x, out and every
// operand are float32 or bfloat16 of one type, channels-last and
// contiguous; out may be x (in place).
//
// Contract: bit-equal to the eager chain on the card.  Every operation is
// float32, pinned with __fsub_rn / __fmul_rn / __fadd_rn (no FMA
// contraction; the library builds with -fmad=false too); in bfloat16 each
// result is rounded to bfloat16 (__float2bfloat16_rn) where the chain writes
// a bfloat16 tensor, after every operation.  torch's x - m is its add kernel
// with alpha -1 (a + -1 * b), whose product is exact, so it is the rounded
// difference, NaN, infinities and signed zeros included.  ReLU is torch's
// clamp_min on the card, v != v ? v : fmaxf(v, 0.0f) in float32, the same
// instruction with the same operands.
//
// Design: bytes bound -- each element read once and written once, (2 + 1 /
// S for the rows form) * numel * size bytes over 3.35 TB/s; 5 operations
// per element are far below the FP32 rate.  Thread lanes walk the tensor as
// 16-byte chunks (4 float32 or 8 bfloat16 channels); the number of lanes is
// a multiple of the chunks a row has, so a lane keeps one chunk of channels
// for its whole walk and loads its m, r, w, b once, into registers, and a
// warp's loads are 32 consecutive chunks (512 contiguous bytes).  Each lane
// keeps unroll<V>() chunks in flight; the grid is kBlocksPerSm blocks an SM
// (or fewer for a small tensor): one wave, no tail of blocks.  A row of C %
// (16 / size) channels, or a pointer off the 16-byte grid, takes the
// scalar instance (one channel a chunk).  Rows are 32-bit (the host
// checks), offsets 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "chunks.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;
constexpr int kMaxDevices = 64;

using ogc::load_chunk;
using ogc::store_chunk;

// A float32 result as the chain's tensor of T holds it.
template <typename T>
__device__ __forceinline__ float held(float v) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    return __bfloat162float(__float2bfloat16_rn(v));
  else
    return v;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Chunks in flight per lane: 4, or 2 for 8-wide bfloat16 chunks, whose
// channel operands take twice the registers (4 blocks of 256 threads an
// SM need at most 64 registers a thread).
template <int V>
__host__ __device__ constexpr int unroll() {
  return V == 8 ? 2 : 4;
}

// clamp_min(v, 0) as torch's clamp kernel computes it on the card.
__device__ __forceinline__ float relu(float v) {
  return v != v ? v : fmaxf(v, 0.0f);
}

template <typename T, int V, bool kRows>
__global__ void __launch_bounds__(kThreads)
    affine_relu_kernel(const T* x, const T* __restrict__ m,
                       const T* __restrict__ r, const T* __restrict__ w,
                       const T* __restrict__ b, const T* __restrict__ t,
                       uint32_t rows, uint32_t S, int chunks, uint32_t lanes,
                       T* out) {
  const uint32_t lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  const int c0 = (int)(lane % (uint32_t)chunks) * V;
  const size_t C = (size_t)chunks * V;
  const uint32_t step = lanes / (uint32_t)chunks;  // rows between visits
  float pm[V], pr[V], pw[V], pb[V];
  if constexpr (!kRows) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      pm[i] = to_float(m[c0 + i]);
      pr[i] = to_float(r[c0 + i]);
      pw[i] = to_float(w[c0 + i]);
      pb[i] = to_float(b[c0 + i]);
    }
  }
  constexpr int U = unroll<V>();
  for (uint32_t row = lane / (uint32_t)chunks; row < rows; row += U * step) {
    float v[U][V], a[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const uint32_t ru = row + u * step;
      if (ru < rows) {
        load_chunk<V>(x + ru * C + c0, v[u]);
        if constexpr (kRows) load_chunk<V>(t + (ru / S) * C + c0, a[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const uint32_t ru = row + u * step;
      if (ru >= rows) continue;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float y;
        if constexpr (kRows) {
          y = held<T>(__fadd_rn(v[u][i], a[u][i]));
        } else {
          y = held<T>(__fsub_rn(v[u][i], pm[i]));
          y = held<T>(__fmul_rn(y, pr[i]));
          y = held<T>(__fmul_rn(y, pw[i]));
          y = held<T>(__fadd_rn(y, pb[i]));
        }
        v[u][i] = relu(y);
      }
      store_chunk<V>(out + ru * C + c0, v[u]);
    }
  }
}

int sm_count() {
  static int counts[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 0;
  if (counts[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      return 0;
    counts[dev] = n;
  }
  return counts[dev];
}

template <typename T, int V>
cudaError_t launch(const void* x, const void* m, const void* r,
                   const void* w, const void* b, const void* t, int rows_form,
                   uint32_t rows, uint32_t S, int C, void* out,
                   cudaStream_t stream) {
  const int sms = sm_count();
  if (sms == 0) return cudaErrorInvalidDevice;
  const int chunks = C / V;
  const int64_t n = (int64_t)rows * chunks;
  const int64_t per_block = (int64_t)kThreads * unroll<V>();
  int64_t blocks = (n + per_block - 1) / per_block;
  if (blocks > (int64_t)sms * kBlocksPerSm)
    blocks = (int64_t)sms * kBlocksPerSm;
  const int64_t least = (chunks + kThreads - 1) / kThreads;
  if (blocks < least) blocks = least;
  const uint32_t lanes =
      (uint32_t)((blocks * kThreads / chunks) * (int64_t)chunks);
  const T* xt = (const T*)x;
  const T *mt = (const T*)m, *rt = (const T*)r, *wt = (const T*)w,
          *bt = (const T*)b, *tt = (const T*)t;
  T* o = (T*)out;
  void* args[] = {&xt, &mt, &rt, &wt, &bt, &tt, &rows, &S,
                  (void*)&chunks, (void*)&lanes, &o};
  const void* fn = rows_form ? (const void*)affine_relu_kernel<T, V, true>
                             : (const void*)affine_relu_kernel<T, V, false>;
  // cudaLaunchKernel returns the launch's own error: no second call.
  return cudaLaunchKernel(fn, dim3((unsigned)blocks), dim3(kThreads), args, 0,
                          stream);
}

}  // namespace

// x (rows, C) float32 or bfloat16, contiguous; out (rows, C) of x's type,
// x itself or disjoint from it.  flags: 1 bfloat16, 2 the rows form (t
// (rows / S, C) of x's type; m, r, w, b unused and may be null), else the
// channel form (m, r, w, b (C) of x's type; t unused), 4 16-byte chunks (C
// * size % 16 == 0 and x, out and t 16-byte aligned; else one channel per
// chunk).  Requires 0 < rows < 2^31, S >= 1 dividing rows in the rows form.
// Launches on `stream` and returns the launch's error (0 on success).
extern "C" int ogc_affine_relu(const void* x, const void* m, const void* r,
                               const void* w, const void* b, const void* t,
                               long long rows, int S, int C, int flags,
                               void* out, void* stream) {
  const int bf16 = flags & 1, rows_form = (flags >> 1) & 1,
            vec = (flags >> 2) & 1;
  if (rows <= 0 || rows >= ((long long)1 << 31) || C <= 0 || S <= 0 ||
      (rows_form && rows % S))
    return (int)cudaErrorInvalidValue;
  const uint32_t n_rows = (uint32_t)rows, s = (uint32_t)S;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    if (vec) {
      if (C % 8) return (int)cudaErrorInvalidValue;
      return (int)launch<__nv_bfloat16, 8>(x, m, r, w, b, t, rows_form,
                                           n_rows, s, C, out, st);
    }
    return (int)launch<__nv_bfloat16, 1>(x, m, r, w, b, t, rows_form, n_rows,
                                         s, C, out, st);
  }
  if (vec) {
    if (C % 4) return (int)cudaErrorInvalidValue;
    return (int)launch<float, 4>(x, m, r, w, b, t, rows_form, n_rows, s, C,
                                 out, st);
  }
  return (int)launch<float, 1>(x, m, r, w, b, t, rows_form, n_rows, s, C,
                               out, st);
}
