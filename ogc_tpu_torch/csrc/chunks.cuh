// Device helpers shared by the row-group pool #12 (pool.cu) and the eval
// norm + ReLU pass (affine_relu.cu): V consecutive channels of a float32 or
// bfloat16 row moved as floats, V * sizeof(T) being 16 bytes (one vector
// load or store) or one element.  bfloat16 widens exactly and narrows with
// round to nearest even (__float2bfloat16_rn, as torch's casts on the card).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ogc {

template <int V>
__device__ __forceinline__ void load_chunk(const float* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = p[0];
  } else {
    static_assert(V == 4, "float chunk");
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
}

template <int V>
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                           float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = __bfloat162float(p[0]);
  } else {
    static_assert(V == 8, "bfloat16 chunk");
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h;
      *reinterpret_cast<uint32_t*>(&h) = w[i];
      const float2 f = __bfloat1622float2(h);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

template <int V>
__device__ __forceinline__ void store_chunk(float* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    p[0] = v[0];
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <int V>
__device__ __forceinline__ void store_chunk(__nv_bfloat16* p,
                                            const float (&v)[V]) {
  if constexpr (V == 1) {
    p[0] = __float2bfloat16_rn(v[0]);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

}  // namespace ogc
