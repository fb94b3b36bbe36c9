// Finite-population waits of Fortio -qps max, for Hopper (sm_90a).
//
// Replaces no Pallas TPU kernel: the JAX package leaves these waits to
// XLA (isotope_tpu/sim/engine.py, the saturated branch of the wait
// draws, from `_horner` at :5300), which fuses them into the block's
// program.  Eager PyTorch runs them as a chain of ~49 launches, 46 of
// them passes over the (N, H) float32 grid (native/satwait.py
// `saturated_wait_reference`).  This kernel is that chain fused.  For
// every request row n and hop h, with the row's table row r (`rows[n]`,
// or 0 where no rows are given):
//
//   zproj = sum_h z[n, h] * e[r, h]                           (copula)
//   x     = (z[n, h] - c[r] * e[r, h] * zproj) * scale[r, h]  (copula)
//   u     = ndtr(x): 1 + erf(x / sqrt 2) inside |x| < 1, else erfc of
//           |x| / sqrt 2 (2 - erfc above the centre), halved
//   u'    = clamp((u - p0[r, h]) / max(1 - p0[r, h], 1e-9), 0, 1 - 1e-7)
//   v     = -log1p(-u')
//   w     = Horner over coef[r, D-1 .. 0, h] in v
//   out   = u < p0[r, h] ? 0 : max(w, 0)
//
// What bounds it: the instruction rate, then bytes.  The work needs z
// read once and the wait written once, 8 B a hop-row (240 MB and 0.072
// ms at 3.35 TB/s for a 30,000 x 1,000 block).  But erfcf and erff (both
// evaluated: the lanes of a warp fall on both sides of |x| = 1), log1pf,
// an IEEE division and the Horner pass take ~170-200 SASS instructions
// an element, ~0.17 ms for 3e7 elements on 132 SMs at one warp
// instruction a cycle a scheduler (1.755 GHz).  The per-hop
// tables (D + 3 floats a hop, 56 KB a table row at D = 11) are read
// through the read-only path and stay in L1 and L2.
//
// Design: the fusion.  A group of G lanes of one warp (a power of two,
// 1 to 32, from `launch_plan` in native/satwait.py; this file takes the
// plan as given) takes a row, and blocks of 128 threads hold 128 / G
// rows.  Pass 1 reduces the row's projection e . z: each lane sums its
// elements, then a butterfly of shuffles sums the group's lanes.  Pass 2
// reads the row again (its 4 KB were just read, so they come from L1 or
// L2) and writes the wait.  Lane t of a group takes the elements j with
// (j / 4) % G == t, four at a time: one 16-byte load each where every
// pointer lies on a 16-byte boundary and H % 4 == 0, else four 4-byte
// loads in the same order.  canonical.yaml's 6 hops take two lanes a
// row, a row of 121 hops or more a whole warp: a warp a row measured
// faster than a block a row (1,000 hops: 0.243 against 0.283 ms for
// 30,000 rows, H100), as no barrier holds a block's warps together.
// The Horner pass is unrolled at the tables' own degree (11
// coefficients) and a loop at any other.  The bound of eight blocks an
// SM (at most 64 registers a thread) measured 3% faster than none.
//
// Arithmetic: every product, sum and quotient is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn: no fused multiply-add)
// and the special functions are erff, erfcf and log1pf, as in the
// chain's own ops; the clamps keep NaN as torch.clamp does.  So only the
// row sum's order differs from the chain; `saturated_wait_sequential`
// is this kernel's order in plain torch, and the kernel equals it bit
// for bit.
//
// C interface, loaded with ctypes: pointers as void*, sizes as int64 /
// int32, the launch plan as an int32 array (layout: `Plan` below).  The
// row indices must lie in [0, R): the kernel does not check them.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

struct Plan {
  int32_t group;           // threads a row
  int32_t threads;         // threads a block
  int32_t rows_per_block;
  int32_t blocks;
  int32_t aligned;         // 16-byte loads and stores
  int32_t unrolled;        // D == kDegree
};

struct Args {
  const float* z;          // (N, H)
  const int64_t* rows;     // (N,) table row of each request, or null
  const float* p0;         // (R, H)
  const float* coef;       // (R, D, H)
  const float* e;          // (R, H)
  const float* c;          // (R,)
  const float* scale;      // (R, H)
  float* out;              // (N, H)
  int64_t n;
  int32_t h;
  int32_t d;
  int32_t copula;
};

constexpr int kDegree = 11;        // sim/closed.py DEFAULT_QUANTILE_DEGREE + 1

// the chain's float32 constants: 0.5 * sqrt(2) rounded in float32, and
// the clamps' 1e-9 and 1 - 1e-7 as torch rounds them to float32
constexpr float kHalfSqrt2 = 0x1.6a09e6p-1f;
constexpr float kTailMin = 0x1.12e0bep-30f;
constexpr float kUMax = 0x1.fffffcp-1f;

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// both tails are evaluated and one is selected: a warp's lanes fall on
// both sides of |x| = 1 almost always, and without branches the four
// elements of a thread interleave
__device__ __forceinline__ float ndtr(float x) {
  const float w = __fmul_rn(x, kHalfSqrt2);
  const float a = fabsf(w);
  const float inner = __fadd_rn(1.0f, erff(w));
  const float tail = erfcf(a);
  const float y = a < kHalfSqrt2 ? inner
                  : (w > 0.0f ? __fsub_rn(2.0f, tail) : tail);
  return __fmul_rn(0.5f, y);
}

// four consecutive elements from j (those at or past h read as 0)
template <bool kAligned>
__device__ __forceinline__ void load4(const float* __restrict__ p, int j,
                                      int h, float v[4]) {
  if (kAligned) {
    const float4 q = *reinterpret_cast<const float4*>(p + j);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = j + i < h ? p[j + i] : 0.0f;
  }
}

template <bool kAligned>
__device__ __forceinline__ void ldg4(const float* __restrict__ p, int j,
                                     int h, float v[4]) {
  if (kAligned) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p + j));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = j + i < h ? __ldg(p + j + i) : 0.0f;
  }
}

template <bool kAligned>
__device__ __forceinline__ void store4(float* __restrict__ p, int j, int h,
                                       const float v[4]) {
  if (kAligned) {
    *reinterpret_cast<float4*>(p + j) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (j + i < h) p[j + i] = v[i];
    }
  }
}

// Horner over the D coefficient rows (stride h floats apart) at j..j+3
template <bool kAligned, int kD>
__device__ __forceinline__ void horner4(const float* __restrict__ coef,
                                        int d, int h, int j,
                                        const float v[4], float w[4]) {
  const int deg = kD > 0 ? kD : d;
  ldg4<kAligned>(coef + static_cast<int64_t>(deg - 1) * h, j, h, w);
  if (kD > 0) {
#pragma unroll
    for (int ci = kD - 2; ci >= 0; --ci) {
      float k4[4];
      ldg4<kAligned>(coef + static_cast<int64_t>(ci) * h, j, h, k4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[i] = __fadd_rn(__fmul_rn(w[i], v[i]), k4[i]);
      }
    }
  } else {
    for (int ci = deg - 2; ci >= 0; --ci) {
      float k4[4];
      ldg4<kAligned>(coef + static_cast<int64_t>(ci) * h, j, h, k4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[i] = __fadd_rn(__fmul_rn(w[i], v[i]), k4[i]);
      }
    }
  }
}

template <bool kAligned, int kD>
__global__ void __launch_bounds__(128, 8)
satwait_kernel(const Args a, const Plan pl) {
  const int g = pl.group;
  const int tid = threadIdx.x;
  const int t = tid % g;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * pl.rows_per_block + tid / g;
  const bool live = row < a.n;
  const int h = a.h;
  const int64_t r = live && a.rows != nullptr ? a.rows[row] : 0;
  const float* __restrict__ zr = a.z + (live ? row : 0) * h;
  const float* __restrict__ er = a.e + r * h;

  // pass 1: the row's projection e . z, in the group's fixed order
  float zproj = 0.0f;
  // this thread's chunks: j = 4 * (k * g + t) < h
  const int chunks = live ? (h - 4 * t + 4 * g - 1) / (4 * g) : 0;
  if (a.copula) {
    float acc = 0.0f;
#pragma unroll 4
    for (int k = 0; k < chunks; ++k) {
      const int j = 4 * (k * g + t);
      float zv[4], ev[4];
      load4<kAligned>(zr, j, h, zv);
      ldg4<kAligned>(er, j, h, ev);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (kAligned || j + i < h) {
          acc = __fadd_rn(acc, __fmul_rn(zv[i], ev[i]));
        }
      }
    }
    // every lane of the warp reaches the shuffles
    for (int off = g / 2; off > 0; off >>= 1) {
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    }
    zproj = acc;
  }
  if (!live) return;

  // pass 2: the wait of each element
  const float c_r = a.copula ? __ldg(a.c + r) : 0.0f;
  const float* __restrict__ p0r = a.p0 + r * h;
  const float* __restrict__ sr = a.scale + r * h;
  const float* __restrict__ cr = a.coef + r * a.d * static_cast<int64_t>(h);
  float* __restrict__ outr = a.out + row * h;
#pragma unroll 2
  for (int k = 0; k < chunks; ++k) {
    const int j = 4 * (k * g + t);
    float x[4], p0[4], u[4], v[4], w[4];
    load4<kAligned>(zr, j, h, x);
    ldg4<kAligned>(p0r, j, h, p0);
    if (a.copula) {
      float ev[4], sv[4];
      ldg4<kAligned>(er, j, h, ev);
      ldg4<kAligned>(sr, j, h, sv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = __fmul_rn(
            __fsub_rn(x[i], __fmul_rn(__fmul_rn(c_r, ev[i]), zproj)), sv[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      u[i] = ndtr(x[i]);
      const float tail = clamp_min(__fsub_rn(1.0f, p0[i]), kTailMin);
      const float uc =
          clamp(__fdiv_rn(__fsub_rn(u[i], p0[i]), tail), 0.0f, kUMax);
      v[i] = -log1pf(-uc);
    }
    horner4<kAligned, kD>(cr, a.d, h, j, v, w);
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = u[i] < p0[i] ? 0.0f : clamp_min(w[i], 0.0f);
    store4<kAligned>(outr, j, h, w);
  }
}

template <bool kAligned>
int launch(const Args& a, const Plan& pl, cudaStream_t st) {
  if (pl.unrolled) {
    satwait_kernel<kAligned, kDegree><<<pl.blocks, pl.threads, 0, st>>>(a, pl);
  } else {
    satwait_kernel<kAligned, 0><<<pl.blocks, pl.threads, 0, st>>>(a, pl);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int satwait_launch(const void* z, const void* rows,
                              const void* p0, const void* coef,
                              const void* e, const void* c,
                              const void* scale, void* out, int64_t n,
                              int32_t h, int32_t d, int32_t copula,
                              const int32_t* plan, void* stream) {
  if (n <= 0 || h <= 0) return 0;
  Plan pl;
  memcpy(&pl, plan, sizeof(Plan));
  if (pl.group > 32 || pl.threads % pl.group != 0 || d < 1 ||
      (pl.unrolled && d != kDegree)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(z),
               static_cast<const int64_t*>(rows),
               static_cast<const float*>(p0),
               static_cast<const float*>(coef),
               static_cast<const float*>(e),
               static_cast<const float*>(c),
               static_cast<const float*>(scale),
               static_cast<float*>(out),
               n, h, d, copula};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return pl.aligned ? launch<true>(a, pl, st) : launch<false>(a, pl, st);
}

extern "C" const char* satwait_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
