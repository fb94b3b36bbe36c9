// Census join of the upward level sweep, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel isotope_tpu/native/census_pallas.py
// (`census` -> `_build` -> pl.pallas_call of `_census_kernel`).  For
// every (request n, hop b) row of a dense level with children:
//
//   dur[p]  = max(step_base[b, p], agg[n, b, p]) * step_mask[b, p]
//   dur[p] *= (p <= fail_step[n, b])        when fail_step is given
//   dur[p] *= !err[n, b]                    when err is given
//   excl[n, b, p] = run[p] - dur[p]         (run = inclusive prefix sum)
//   busy[n, b]    = run[P - 1]
//
// What bounds it: memory.  Per row it reads P floats of agg plus the
// optional fail step (4 bytes) and error flag (1 byte), and writes P
// floats of excl and one of busy; the (B, P) base and mask tables are
// tiny and stay in L1/L2.  It does ~5 float operations per element, far
// below the card's operations-per-byte balance.
//
// Design (first, simple version): one thread per row, a sequential scan
// over the step axis in registers.  The step axis P is 1 or 2 on every
// shipped topology, so this is exact and cheap; `excl` is written as
// `run - dur` with the same formula as the reference, and every product
// and sum is rounded separately (__fmul_rn / __fadd_rn / __fsub_rn), so
// no fused multiply-add changes the rounding against the plain version.
// Rows are contiguous in memory, so for P = 1 neighbouring threads read
// neighbouring words.  A later version will coalesce the P axis across a
// warp and use 16-byte loads for wide steps.
//
// C interface, loaded with ctypes: pointers as void*, sizes as int64.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// max that propagates NaN, like torch.maximum / jnp.maximum
__device__ __forceinline__ float nan_max(float x, float y) {
  return (x > y || x != x) ? x : y;
}

__global__ void census_kernel(const float* __restrict__ base,
                              const float* __restrict__ mask,
                              const float* __restrict__ agg,
                              const int32_t* __restrict__ fail,
                              const uint8_t* __restrict__ err,
                              float* __restrict__ busy,
                              float* __restrict__ excl,
                              int64_t rows, int64_t b, int32_t p) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const int64_t hop = row % b;
  const float* a = agg + row * p;
  const float* bs = base + hop * p;
  const float* mk = mask + hop * p;
  float* e = excl + row * p;
  const int32_t fs = fail != nullptr ? fail[row] : p;
  const float keep_row = (err != nullptr && err[row] != 0) ? 0.0f : 1.0f;
  float run = 0.0f;
  for (int32_t q = 0; q < p; ++q) {
    float d = __fmul_rn(nan_max(bs[q], a[q]), mk[q]);
    if (fail != nullptr) d = __fmul_rn(d, q <= fs ? 1.0f : 0.0f);
    if (err != nullptr) d = __fmul_rn(d, keep_row);
    run = __fadd_rn(run, d);
    e[q] = __fsub_rn(run, d);
  }
  busy[row] = run;
}

}  // namespace

extern "C" int census_launch(const void* base, const void* mask,
                             const void* agg, const void* fail,
                             const void* err, void* busy, void* excl,
                             int64_t n, int64_t b, int32_t p,
                             void* stream) {
  const int64_t rows = n * b;
  if (rows <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (rows + threads - 1) / threads;
  census_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(base), static_cast<const float*>(mask),
      static_cast<const float*>(agg), static_cast<const int32_t*>(fail),
      static_cast<const uint8_t*>(err), static_cast<float*>(busy),
      static_cast<float*>(excl), rows, b, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* census_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
