// Deterministic row scatter-add on Hopper: the backward of every grouping
// gather in the port.
//
// Replaces the Pallas TPU kernel ogc_tpu/ops/pallas_scatter.py::
// scatter_add_rows (its inner `kernel`; tools/bench_pallas_scatter.py holds
// a bench copy of the same body).
//
// Contract: d[b, idx[b, r], :] += g[b, r, :] over r = 0, 1, ..., R-1 in
// that order, f32, every destination row starting from 0.0f.  The TPU grid
// runs sequentially, so that order is the Pallas kernel's own; keeping it
// makes this kernel bit-equal to it and to the plain version.
//
// Design: no float atomics (their order changes from run to run).  The
// wrapper builds, with integer work only, a stable sort of the flattened
// destinations (destination-major, r-minor) and the segment offsets of each
// destination row.  Here one thread owns one (destination row, channel)
// element and sums its segment in ascending r with __fadd_rn (no FMA, no
// tree), then writes it once.  Neighbouring threads take neighbouring
// channels of the same source rows, so the gradient reads coalesce over the
// row width.
//
// Bound on the H100: bytes -- the gradient rows are read once (R x C x 4),
// the output written once, plus the 8-byte order entry per row and the
// offsets.  The per-thread loop is as long as the destination's in-degree,
// so a hub row (a point that many neighbourhoods list) is a long serial
// tail; a warp-cooperative split of long segments is the next design.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    scatter_add_rows_kernel(const float* __restrict__ g,
                            const int64_t* __restrict__ order,
                            const int64_t* __restrict__ start, int rows, int C,
                            float* __restrict__ out) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (int64_t)rows * C) return;
  const int64_t d = t / C;
  const int c = (int)(t - d * C);
  const int64_t s1 = start[d + 1];
  float acc = 0.0f;
  for (int64_t s = start[d]; s < s1; ++s) {
    acc = __fadd_rn(acc, g[order[s] * C + c]);
  }
  out[t] = acc;
}

}  // namespace

// g (B*R, C) f32; order (B*R) int64: source rows sorted by destination,
// ascending r within a destination; start (rows + 1) int64: segment offsets
// of the rows = B * n_dest destination rows; out (rows, C) f32.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int ogc_scatter_add_rows(const void* g, const void* order,
                                    const void* start, int rows, int C,
                                    void* out, void* stream) {
  const int64_t n = (int64_t)rows * C;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  scatter_add_rows_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const int64_t*)order, (const int64_t*)start, rows, C,
      (float*)out);
  return (int)cudaGetLastError();
}
