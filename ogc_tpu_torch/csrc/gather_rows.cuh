// Device helpers shared by the row gathers #7 (onehot.cu) and #9
// (onehot_bs.cu): the row copy with the channel count fixed at compile time,
// and the opt-in to more than 48 KiB of dynamic shared memory.
//
// copy_rows moves a run of edges' source rows to a contiguous output.  A
// warp takes 128 output floats at a time: lane l loads floats l, l + 32,
// l + 64 and l + 96 of them (consecutive lanes read consecutive channels of
// a few rows, so one load instruction touches few cache lines), puts them in
// its warp's 128-word slice of shared memory, and stores floats 4l..4l+3 as
// one 16-byte streaming store.  A ragged head (until the output is 16-byte
// aligned) and tail go word by word.  Words are copied as uint32, so a -0.0
// or a NaN keeps its bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ogc {

constexpr int kWarpWords = 128;  // output words a warp moves per step
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;

// dst[f] = src[rows[f / C] * C + f % C] for f in [0, n * C), src read
// through the read-only cache.  rows (shared memory, clamped) holds n source
// rows; buf is this warp's kWarpWords words of shared memory.  Called by
// every thread of the block, with no barrier.
template <int C>
__device__ __forceinline__ void copy_rows(uint32_t* __restrict__ dst,
                                          const uint32_t* __restrict__ src,
                                          const int32_t* __restrict__ rows,
                                          int n, uint32_t* __restrict__ buf) {
  const int nw = n * C;
  int head = (int)((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) >> 2;
  head = head < nw ? head : nw;
  const int steps = (nw - head) / kWarpWords;
  const int body_end = head + steps * kWarpWords;
  const int ragged = head + nw - body_end;
  for (int t = threadIdx.x; t < ragged; t += blockDim.x) {
    const int f = t < head ? t : body_end + t - head;
    const int q = f / C;
    dst[f] = __ldg(src + rows[q] * C + f - q * C);
  }
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int k = threadIdx.x >> 5; k < steps; k += warps) {
    const int fb = head + k * kWarpWords;
    uint32_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = fb + j * 32 + lane;
      const int q = f / C;
      v[j] = __ldg(src + rows[q] * C + f - q * C);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) buf[j * 32 + lane] = v[j];
    __syncwarp();
    const uint4 w = reinterpret_cast<const uint4*>(buf)[lane];
    __stcs(reinterpret_cast<uint4*>(dst + fb) + lane, w);
    __syncwarp();
  }
}

// Let `kernel` (one instance) launch with `bytes` of dynamic shared memory.
// Only above the 48 KiB default, and once per device and size: `done`
// holds, per device, the largest size already set.
template <typename Kernel>
cudaError_t smem_opt_in(Kernel kernel, int bytes, int* done) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = bytes;
  return err;
}

}  // namespace ogc
