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
// What bounds it: bytes.  Per row it reads P floats of agg plus the
// optional fail step (4 bytes) and error flag (1 byte), and writes P
// floats of excl and one of busy; the (B, P) base and mask tables are
// read once per block.  It does ~5 float operations per element, far
// below the card's operations-per-byte balance, so the design is about
// moving those bytes at the HBM rate.
//
// Arithmetic: each row is one sequential left-to-right running sum, and
// every product and sum is rounded on its own (__fmul_rn / __fadd_rn /
// __fsub_rn), so no fused multiply-add and no reassociation changes a
// result: `busy` decides transport failures at timeout edges upstream.
// `excl` is `run - dur` as in the reference, and the max propagates NaN
// like torch.maximum.  The design below changes only how bytes move.
//
// Design.  The wrapper (native/census.py, `launch_plan`) picks one of
// two kernels and their geometry; this file takes the plan as given.
//
// - P <= 4 (`census_stream_kernel`): a plain vectorised stream, four
//   rows per thread through P float4s of agg, an int4 of fail, 4 bytes
//   of err and float4 stores of busy and excl, two such groups in
//   flight per thread (one at P = 4), on a grid-stride loop: rows this short are
//   already contiguous across a warp.  Its tables go through the
//   read-only path.
// - P > 4 (`census_tile_kernel`): a persistent grid of a few blocks per
//   SM walks tiles of R consecutive rows.  A tile is R x P contiguous
//   floats of agg, R ints of fail and R bytes of err; R is a multiple
//   of 16, so every tile starts on a 16-byte boundary and its byte
//   counts are multiples of 16.  Each tile is staged into shared memory
//   with 16-byte cp.async copies (zero-filling past the ragged end of
//   the last tile) through a 3-stage ring: while a block scans one
//   tile, the next two are in flight.  Each thread scans its rows
//   (rows tid, tid + T, ...) from shared memory, writes excl back in
//   place, and the block then stores the tile with coalesced 16-byte
//   stores.  The hop of a row is stepped from the tile's first hop, not
//   computed with a 64-bit % per row.  The (B, P) tables sit in shared
//   memory when they fit, else they are read through the read-only
//   path.
// - Both kernels are bounded to 64 registers a thread
//   (__launch_bounds__(256, 4)), which the wrapper's grid assumes.
// - Bank conflicts: thread i reading word i * P + q conflicts whenever
//   P is even.  A thread instead reads V = 4, 2 or 1 steps at a time
//   (the largest of those dividing P), and the staged row pitch is
//   padded so that pitch / V is odd: then the 8 (V = 4), 16 (V = 2) or
//   32 (V = 1) threads of one shared-memory wavefront touch distinct
//   banks.  Only V = 4 with P / 4 even needs padding (pitch P + 4), and
//   then rows are copied row by row, still 16 bytes at a time.
// - Very wide P: when 128 rows of the padded row pitch do not fit 3
//   stages in shared memory, the same kernel walks each tile in column
//   chunks of 128 steps, carrying each row's running sum in a register
//   from one chunk to the next, so the sum order stays left to right.
// - Inputs not on 16-byte boundaries (views) are staged with 4-byte
//   copies, and err is then read straight from device memory.
//
// What it does not do yet: TMA bulk copies (one thread per tile instead
// of one cp.async per 16 bytes), bulk stores, warp-specialised
// producers, and fusing the scatter-max that produces agg.
//
// C interface, loaded with ctypes: pointers as void*, sizes as int64,
// the launch plan as an int32 array (layout: `Plan` below).
//
// The ragged census (`census_ragged_kernel`, launched by
// census_ragged_launch) replaces no Pallas kernel: the JAX reference
// computes every level on its padded (hops x Pmax) grid.  It is a new
// design of the dense call site for a level whose grid is mostly
// padding, where the chain scatter-max -> scatter-min -> tile kernel ->
// child gather moved the whole (N, L, P) grid through device memory
// twice for a few real steps (star-10k's 4,641 x 38 level: 534 cells a
// real step).  See its own note below.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kStages = 3;

struct Args {
  const float* base;
  const float* mask;
  const float* agg;
  const int32_t* fail;
  const uint8_t* err;
  float* busy;
  float* excl;
  int64_t rows;  // N * B
  int32_t b;
  int32_t p;
};

// The int32 plan array of census_launch, in order.
struct Plan {
  int32_t path;         // 0: stream (P <= 4), 1: tiles
  int32_t threads;
  int32_t blocks;
  int32_t smem_bytes;   // dynamic shared memory per block
  int32_t opt_in;       // smem_bytes > 48 KB: cudaFuncSetAttribute first
  int32_t tile_rows;    // R
  int32_t chunk;        // steps per staged row (P, or 128 when wide)
  int32_t pitch;        // shared-memory words per staged row
  int32_t vec;          // V: steps per shared-memory read
  int32_t tables;       // base and mask in shared memory
  int32_t aligned;      // every pointer on a 16-byte boundary
  int32_t table_bytes;  // shared memory of the tables
  int32_t stage_bytes;  // shared memory of one ring stage
};

struct Geom {
  int32_t tile_rows, chunk, pitch, table_bytes, stage_bytes;
};

// max that propagates NaN, like torch.maximum / jnp.maximum
__device__ __forceinline__ float nan_max(float x, float y) {
  return (x > y || x != x) ? x : y;
}

// one step of a row: the same products, in the same order, as the plain
// version
__device__ __forceinline__ float step_dur(float base, float agg, float mask,
                                          bool has_fail, bool keep_step,
                                          bool has_err, float keep_row) {
  float d = __fmul_rn(nan_max(base, agg), mask);
  if (has_fail) d = __fmul_rn(d, keep_step ? 1.0f : 0.0f);
  if (has_err) d = __fmul_rn(d, keep_row);
  return d;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory; bytes past `src_bytes` are
// zero-filled and not read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// V consecutive floats of shared memory, V = 1, 2 or 4, in one access
__device__ __forceinline__ void load_vec(float (&o)[1], const float* s) {
  o[0] = *s;
}
__device__ __forceinline__ void load_vec(float (&o)[2], const float* s) {
  const float2 v = *reinterpret_cast<const float2*>(s);
  o[0] = v.x;
  o[1] = v.y;
}
__device__ __forceinline__ void load_vec(float (&o)[4], const float* s) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void store_vec(float* d, const float (&o)[1]) {
  *d = o[0];
}
__device__ __forceinline__ void store_vec(float* d, const float (&o)[2]) {
  *reinterpret_cast<float2*>(d) = make_float2(o[0], o[1]);
}
__device__ __forceinline__ void store_vec(float* d, const float (&o)[4]) {
  *reinterpret_cast<float4*>(d) = make_float4(o[0], o[1], o[2], o[3]);
}

// -- P <= 4: a plain vectorised stream -------------------------------------

// Short rows need no staging: four consecutive rows are 4 * P
// consecutive floats, read as P float4s, with an int4 of fail steps and
// 4 bytes of error flags, and written as one float4 of busy and P float4s
// of excl.  Neighbouring threads read neighbouring 16 * P bytes; each
// thread keeps two such groups in flight (one at P = 4).  The tables are read through
// the read-only path: staging them would put a round trip to device
// memory in front of the first load, which a small call pays in full.
template <int P>
struct Group {
  float x[4 * P];
  int32_t f[4];
  uint32_t e;
};

template <int P, bool VEC>
__global__ void __launch_bounds__(256, 4)
    census_stream_kernel(Args a) {
  const int32_t b = a.b;
  const bool has_fail = a.fail != nullptr;
  const bool has_err = a.err != nullptr;
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * blockDim.x;

  auto load = [&](int64_t g, Group<P>& grp) {
#pragma unroll
    for (int v = 0; v < P; ++v) {
      const float4 t = reinterpret_cast<const float4*>(a.agg)[g * P + v];
      grp.x[4 * v] = t.x;
      grp.x[4 * v + 1] = t.y;
      grp.x[4 * v + 2] = t.z;
      grp.x[4 * v + 3] = t.w;
    }
    int4 fv = make_int4(P, P, P, P);
    if (has_fail) fv = reinterpret_cast<const int4*>(a.fail)[g];
    grp.f[0] = fv.x;
    grp.f[1] = fv.y;
    grp.f[2] = fv.z;
    grp.f[3] = fv.w;
    grp.e = has_err ? reinterpret_cast<const uint32_t*>(a.err)[g] : 0u;
  };
  // rows 4g .. 4g + 3, the first at hop h
  auto finish = [&](int64_t g, Group<P>& grp, int32_t h) {
    float busy[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float keep_row =
          ((grp.e >> (8 * k)) & 0xffu) != 0 ? 0.0f : 1.0f;
      float run = 0.0f;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const float d = step_dur(__ldg(a.base + h * P + q), grp.x[k * P + q],
                                 __ldg(a.mask + h * P + q), has_fail,
                                 q <= grp.f[k], has_err, keep_row);
        run = __fadd_rn(run, d);
        grp.x[k * P + q] = __fsub_rn(run, d);
      }
      busy[k] = run;
      h = (h + 1 == b) ? 0 : h + 1;
    }
    reinterpret_cast<float4*>(a.busy)[g] =
        make_float4(busy[0], busy[1], busy[2], busy[3]);
#pragma unroll
    for (int v = 0; v < P; ++v)
      reinterpret_cast<float4*>(a.excl)[g * P + v] =
          make_float4(grp.x[4 * v], grp.x[4 * v + 1], grp.x[4 * v + 2],
                      grp.x[4 * v + 3]);
  };

  int64_t first_scalar = 0;
  if (VEC) {
    const int64_t groups = a.rows / 4;
    first_scalar = groups * 4;
    int32_t hop = static_cast<int32_t>((tid * 4) % b);
    const int32_t hop_step = static_cast<int32_t>((nthreads * 4) % b);
    // two groups in flight, but one at P = 4, where two would spill
    constexpr int kGroups = P < 4 ? 2 : 1;
    for (int64_t g = tid; g < groups; g += kGroups * nthreads) {
      const int64_t g1 = g + nthreads;
      int32_t hop1 = hop + hop_step;
      if (hop1 >= b) hop1 -= b;
      Group<P> x0, x1;
      load(g, x0);
      if (kGroups == 2 && g1 < groups) load(g1, x1);
      finish(g, x0, hop);
      if (kGroups == 2 && g1 < groups) finish(g1, x1, hop1);
      hop = hop1;
      if (kGroups == 2) {
        hop += hop_step;
        if (hop >= b) hop -= b;
      }
    }
  }
  // every row without VEC; with it, the last rows % 4
  const int64_t start = first_scalar + tid;
  if (start >= a.rows) return;
  int32_t h = static_cast<int32_t>(start % b);
  const int32_t hop_step = static_cast<int32_t>(nthreads % b);
  for (int64_t r = start; r < a.rows; r += nthreads) {
    const float keep_row = (has_err && a.err[r] != 0) ? 0.0f : 1.0f;
    const int32_t fs = has_fail ? a.fail[r] : P;
    float run = 0.0f;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const float d = step_dur(__ldg(a.base + h * P + q), a.agg[r * P + q],
                               __ldg(a.mask + h * P + q), has_fail, q <= fs,
                               has_err, keep_row);
      run = __fadd_rn(run, d);
      a.excl[r * P + q] = __fsub_rn(run, d);
    }
    a.busy[r] = run;
    h += hop_step;
    if (h >= b) h -= b;
  }
}

// -- P > 4: staged tiles through a cp.async ring --------------------------

// One unit of a block's work: rows [r0, r0 + rows) of one tile and its
// steps [c0, c0 + w).
struct Unit {
  int64_t r0;
  int32_t rows, c, c0, w;
};

__device__ __forceinline__ Unit unit_of(int64_t s, int32_t nch,
                                        const Args& a, const Geom& g) {
  Unit u;
  const int64_t j = nch == 1 ? s : s / nch;
  u.c = static_cast<int32_t>(s - j * nch);
  u.r0 = (static_cast<int64_t>(blockIdx.x) + j * gridDim.x) * g.tile_rows;
  const int64_t left = a.rows - u.r0;
  u.rows = left < g.tile_rows ? static_cast<int32_t>(left) : g.tile_rows;
  u.c0 = u.c * g.chunk;
  u.w = min(g.chunk, a.p - u.c0);
  return u;
}

template <int V, bool ALIGNED, bool TABLES>
__global__ void __launch_bounds__(256, 4)
    census_tile_kernel(Args a, Geom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int32_t T = blockDim.x;
  const int32_t tid = threadIdx.x;
  const int32_t b = a.b, p = a.p;
  const int32_t R = g.tile_rows, pitch = g.pitch;
  const int32_t nch = (p + g.chunk - 1) / g.chunk;
  const int64_t ntiles = (a.rows + R - 1) / R;
  if (blockIdx.x >= ntiles) return;
  const int64_t units =
      ((ntiles - 1 - blockIdx.x) / gridDim.x + 1) * nch;
  // the whole tile is one contiguous range in both memories
  const bool contiguous = nch == 1 && pitch == p;
  // 16-byte copies of rows: V = 4 rows start on 16-byte boundaries
  const bool rows16 = ALIGNED && V == 4;
  const bool has_fail = a.fail != nullptr;
  const bool has_err = a.err != nullptr;

  float* s_base = reinterpret_cast<float*>(smem);
  float* s_mask = s_base + static_cast<int64_t>(b) * pitch;
  unsigned char* ring = smem + g.table_bytes;
  auto s_agg = [&](int st) {
    return reinterpret_cast<float*>(ring + st * g.stage_bytes);
  };
  auto s_fail = [&](int st) {
    return reinterpret_cast<int32_t*>(ring + st * g.stage_bytes +
                                      R * pitch * 4);
  };
  auto s_err = [&](int st) {
    return ring + st * g.stage_bytes + R * pitch * 4 + R * 4;
  };

  if (TABLES) {
    for (int32_t i = tid; i < b * p; i += T) {
      const int32_t h = i / p, q = i - h * p;
      s_base[h * pitch + q] = a.base[i];
      s_mask[h * pitch + q] = a.mask[i];
    }
    // made visible by the first __syncthreads of the loop below
  }

  auto fetch = [&](int64_t s, int st) {
    const Unit u = unit_of(s, nch, a, g);
    float* dst = s_agg(st);
    const float* src = a.agg + u.r0 * p + u.c0;
    if (contiguous) {
      const int32_t nw = u.rows * p;
      if (ALIGNED) {
        for (int32_t k = tid; 4 * k < nw; k += T)
          cp_async16(dst + 4 * k, src + 4 * k, min(16, 4 * (nw - 4 * k)));
      } else {
        for (int32_t k = tid; k < nw; k += T) cp_async4(dst + k, src + k);
      }
    } else if (rows16) {
      const int32_t per_row = u.w / 4;
      for (int32_t k = tid; k < u.rows * per_row; k += T) {
        const int32_t r = k / per_row;
        const int32_t q = (k - r * per_row) * 4;
        cp_async16(dst + r * pitch + q,
                   src + static_cast<int64_t>(r) * p + q, 16);
      }
    } else {
      for (int32_t k = tid; k < u.rows * u.w; k += T) {
        const int32_t r = k / u.w;
        const int32_t q = k - r * u.w;
        cp_async4(dst + r * pitch + q, src + static_cast<int64_t>(r) * p + q);
      }
    }
    if (has_fail) {
      int32_t* fd = s_fail(st);
      const int32_t* fsrc = a.fail + u.r0;
      if (ALIGNED) {
        for (int32_t k = tid; 4 * k < u.rows; k += T)
          cp_async16(fd + 4 * k, fsrc + 4 * k,
                     min(16, 4 * (u.rows - 4 * k)));
      } else {
        for (int32_t k = tid; k < u.rows; k += T)
          cp_async4(fd + k, fsrc + k);
      }
    }
    if (ALIGNED && has_err) {
      unsigned char* ed = s_err(st);
      const uint8_t* esrc = a.err + u.r0;
      for (int32_t k = tid; 16 * k < u.rows; k += T)
        cp_async16(ed + 16 * k, esrc + 16 * k, min(16, u.rows - 16 * k));
    }
  };

  const int32_t tid_hop = tid % b;
  const int32_t T_hop = T % b;
  const int32_t grid_hop =
      static_cast<int32_t>((static_cast<int64_t>(gridDim.x) * R) % b);
  int32_t tile_hop =
      static_cast<int32_t>((static_cast<int64_t>(blockIdx.x) * R) % b);
  float carry = 0.0f;  // a row's running sum across chunks (wide P)

  auto scan = [&](const Unit& u, int st) {
    float* tile = s_agg(st);
    int32_t h = tile_hop + tid_hop;
    if (h >= b) h -= b;
    for (int32_t i = tid; i < u.rows; i += T) {
      const int64_t row = u.r0 + i;
      const int32_t fs = has_fail ? s_fail(st)[i] : p;
      bool e = false;
      if (has_err) e = (ALIGNED ? s_err(st)[i] : a.err[row]) != 0;
      const float keep_row = e ? 0.0f : 1.0f;
      float run = u.c == 0 ? 0.0f : carry;
      float* x = tile + i * pitch;
      const float* tb = TABLES ? s_base + h * pitch + u.c0
                               : a.base + static_cast<int64_t>(h) * p + u.c0;
      const float* tm = TABLES ? s_mask + h * pitch + u.c0
                               : a.mask + static_cast<int64_t>(h) * p + u.c0;
      for (int32_t q = 0; q < u.w; q += V) {
        float av[V], bv[V], mv[V];
        load_vec(av, x + q);
        if (TABLES) {
          load_vec(bv, tb + q);
          load_vec(mv, tm + q);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            bv[k] = __ldg(tb + q + k);
            mv[k] = __ldg(tm + q + k);
          }
        }
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float d = step_dur(bv[k], av[k], mv[k], has_fail,
                                   u.c0 + q + k <= fs, has_err, keep_row);
          run = __fadd_rn(run, d);
          av[k] = __fsub_rn(run, d);
        }
        store_vec(x + q, av);
      }
      carry = run;
      if (u.c == nch - 1) a.busy[row] = run;
      h += T_hop;
      if (h >= b) h -= b;
    }
  };

  auto store = [&](const Unit& u, int st) {
    const float* tile = s_agg(st);
    float* dst = a.excl + u.r0 * p + u.c0;
    if (contiguous) {
      const int32_t nw = u.rows * p;
      if (ALIGNED) {
        for (int32_t k = tid; 4 * k < nw; k += T) {
          if (4 * k + 4 <= nw) {
            reinterpret_cast<float4*>(dst)[k] =
                reinterpret_cast<const float4*>(tile)[k];
          } else {
            for (int32_t w = 4 * k; w < nw; ++w) dst[w] = tile[w];
          }
        }
      } else {
        for (int32_t k = tid; k < nw; k += T) dst[k] = tile[k];
      }
    } else if (rows16) {
      const int32_t per_row = u.w / 4;
      for (int32_t k = tid; k < u.rows * per_row; k += T) {
        const int32_t r = k / per_row;
        const int32_t q = (k - r * per_row) * 4;
        *reinterpret_cast<float4*>(dst + static_cast<int64_t>(r) * p + q) =
            *reinterpret_cast<const float4*>(tile + r * pitch + q);
      }
    } else {
      for (int32_t k = tid; k < u.rows * u.w; k += T) {
        const int32_t r = k / u.w;
        const int32_t q = k - r * u.w;
        dst[static_cast<int64_t>(r) * p + q] = tile[r * pitch + q];
      }
    }
  };

  // the ring: units 0 .. kStages - 2 in flight before the first scan
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < units) fetch(s, s);
    cp_async_commit();
  }
  for (int64_t s = 0; s < units; ++s) {
    const int st = static_cast<int>(s % kStages);
    // unit s has landed; every thread is done with unit s - 1's stage
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (s + kStages - 1 < units)
      fetch(s + kStages - 1, static_cast<int>((s + kStages - 1) % kStages));
    cp_async_commit();
    const Unit u = unit_of(s, nch, a, g);
    if (s > 0 && u.c == 0) {
      tile_hop += grid_hop;
      if (tile_hop >= b) tile_hop -= b;
    }
    scan(u, st);
    __syncthreads();
    store(u, st);
  }
}

// -- the ragged census: every step of a mostly padded level at once ----------

// For each (request n, hop h) row the kernel walks h's real steps from
// the plan's compact list (hop_ptr, then per step its index, sleep
// floor, calls and children), and for each step:
//
//   agg  = max of the step's call durations, over 0 as the dense site's
//          scatter-max (include_self) has it, or over the calls alone on
//          its uniform reshape-reduce; a NaN duration enters the max where
//          the card's scatter carries one (keep_nan, probed by the wrapper)
//          and always on the uniform path (amax propagates it)
//   fail = min(fail, q) if one of the step's calls transport-failed: with
//          steps walked in order this is the dense site's scatter-min by
//          the time any later step reads it
//   d    = step_dur(floor, agg, 1, ...), run += d, and each child of the
//          step takes run - d as its offset
//
// A padded step of the dense grid adds max(floor, 0) * 0 = +0.0 to the
// running sum (the plan admits a level only when every padded floor is
// finite), and run + 0.0 == run for every run this sum can hold (it
// starts at +0.0, so never reaches -0.0): skipping padded steps leaves
// busy, the fail step and every child's offset bit for bit as the dense
// chain computes them.
//
// What bounds it: bytes.  Per row it reads the error flag (1 byte) and
// writes busy (4) and the fail step (4); per real step it reads its
// calls' durations and transport flags and writes its children's
// offsets.  One thread per (n, h) row, hops fastest, keeps every access
// of a row coalesced.  But a step waits on a dependent chain of loads
// (its call range, its call's column, the duration), and where hops with
// steps are rare a warp of 32 neighbouring hops of one row that holds
// one long hop keeps the other lanes idle through all of its steps
// (star-10k's level 2: 68 of 4,641 hops have steps, one of them 38).  So
// where at most one hop in RAGGED_SPLIT has a step (the wrapper decides
// from the plan, `ragged_blocks`) the grid is split in two:
//
// - blocks [0, walk_blocks): one thread per (n, hop with steps), rows
//   fastest, so the 32 lanes of a warp walk the same hop's steps for 32
//   rows in lockstep: the plan's loads are one broadcast each, the warp
//   has no divergence, and its 32 duration loads are in flight at once
//   (each from its own row: strided, which is why denser levels keep the
//   coalesced walk); these long blocks are dispatched first;
// - the rest: one thread per (n, h) row, hops fastest, writing busy +0.0
//   and the fail step P of each hop without a step with coalesced stores,
//   and walking each hop with steps itself when walk_blocks is 0.
//
// The plan's tables are small and stay in L1/L2 through the read-only
// path; no (N, L, P) grid is read, written or allocated.  Each thread
// steps its indices by the grid stride instead of dividing per item.
struct RaggedArgs {
  const int32_t* hop_ptr;     // (L + 1)
  const int32_t* walk_hops;   // (W): the hops with at least one step
  const int32_t* step_q;      // (S)
  const float* step_floor;    // (S)
  const int32_t* call_ptr;    // (S + 1)
  const int32_t* call_col;    // (K)
  const int32_t* child_ptr;   // (S + 1)
  const int32_t* child_col;   // (C)
  const float* dur;           // (N, K)
  const uint8_t* transport;   // (N, K) or null
  const uint8_t* err;         // (N, L) or null
  float* busy;                // (N, L)
  int32_t* fail;              // (N, L), null when transport is
  float* off;                 // (N, C)
  int64_t n;
  int32_t l, w, k, c, p;
  int32_t uniform;            // no zero in the max (reshape-reduce path)
  int32_t keep_nan;           // the scatter's max carries a NaN
  int32_t walk_blocks;        // blocks of the first part
};

// the steps of hop h for request n
__device__ __forceinline__ void ragged_walk(const RaggedArgs& a, int64_t n,
                                            int32_t h) {
  const int64_t r = n * a.l + h;
  const bool has_fail = a.transport != nullptr;
  const bool has_err = a.err != nullptr;
  const float keep_row = (has_err && a.err[r] != 0) ? 0.0f : 1.0f;
  const float* dur = a.dur + n * a.k;
  const uint8_t* tr = has_fail ? a.transport + n * a.k : nullptr;
  float* off = a.off + n * a.c;
  int32_t fail = a.p;
  float run = 0.0f;
  const int32_t s1 = __ldg(a.hop_ptr + h + 1);
  for (int32_t s = __ldg(a.hop_ptr + h); s < s1; ++s) {
    const int32_t q = __ldg(a.step_q + s);
    int32_t j = __ldg(a.call_ptr + s);
    const int32_t j1 = __ldg(a.call_ptr + s + 1);
    float agg = 0.0f;
    if (a.uniform && j < j1) {
      const int32_t col = __ldg(a.call_col + j);
      agg = dur[col];
      if (has_fail && tr[col] != 0) fail = min(fail, q);
      ++j;
    }
    for (; j < j1; ++j) {
      const int32_t col = __ldg(a.call_col + j);
      const float x = dur[col];
      agg = (a.uniform || a.keep_nan) ? nan_max(x, agg) : fmaxf(x, agg);
      if (has_fail && tr[col] != 0) fail = min(fail, q);
    }
    const float d = step_dur(__ldg(a.step_floor + s), agg, 1.0f, has_fail,
                             q <= fail, has_err, keep_row);
    run = __fadd_rn(run, d);
    const float e = __fsub_rn(run, d);
    const int32_t c1 = __ldg(a.child_ptr + s + 1);
    for (int32_t i = __ldg(a.child_ptr + s); i < c1; ++i)
      off[__ldg(a.child_col + i)] = e;
  }
  a.busy[r] = run;
  if (has_fail) a.fail[r] = fail;
}

__global__ void __launch_bounds__(256) census_ragged_kernel(RaggedArgs a) {
  const bool walk = static_cast<int32_t>(blockIdx.x) < a.walk_blocks;
  const int64_t block = walk ? blockIdx.x : blockIdx.x - a.walk_blocks;
  const int64_t blocks = walk ? a.walk_blocks : gridDim.x - a.walk_blocks;
  const int64_t first = block * blockDim.x + threadIdx.x;
  const int64_t stride = blocks * blockDim.x;
  if (walk) {
    // item t = (hop j of walk_hops) * N + row n
    const int64_t items = a.n * a.w;
    if (first >= items) return;
    const int64_t dj = stride / a.n;
    const int64_t dn = stride - dj * a.n;
    int64_t j = first / a.n;
    int64_t n = first - j * a.n;
    for (int64_t t = first; t < items; t += stride) {
      ragged_walk(a, n, __ldg(a.walk_hops + j));
      j += dj;
      n += dn;
      if (n >= a.n) {
        n -= a.n;
        ++j;
      }
    }
    return;
  }
  // item r = row n * L + hop h: the hops without a step
  const int64_t rows = a.n * a.l;
  if (first >= rows) return;
  const int64_t dn = stride / a.l;
  const int32_t dh = static_cast<int32_t>(stride - dn * a.l);
  int64_t n = first / a.l;
  int32_t h = static_cast<int32_t>(first - n * a.l);
  const bool has_fail = a.transport != nullptr;
  for (int64_t r = first; r < rows; r += stride) {
    if (__ldg(a.hop_ptr + h) == __ldg(a.hop_ptr + h + 1)) {
      a.busy[r] = 0.0f;
      if (has_fail) a.fail[r] = a.p;
    } else if (a.walk_blocks == 0) {
      ragged_walk(a, n, h);
    }
    h += dh;
    n += dn;
    if (h >= a.l) {
      h -= a.l;
      ++n;
    }
  }
}

// -- launch -------------------------------------------------------------------

// raise the kernel's dynamic shared-memory limit to the plan's size
// once (per kernel, to the largest size asked so far)
template <typename Kernel>
int opt_in_smem(Kernel kernel, const Plan& pl, int* granted) {
  if (!pl.opt_in || pl.smem_bytes <= *granted) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  *granted = pl.smem_bytes;
  return 0;
}

template <int P>
int launch_stream(const Args& a, const Plan& pl, cudaStream_t stream) {
  if (pl.aligned)
    census_stream_kernel<P, true><<<pl.blocks, pl.threads, 0, stream>>>(a);
  else
    census_stream_kernel<P, false><<<pl.blocks, pl.threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int V, bool ALIGNED, bool TABLES>
int launch_tile(const Args& a, const Plan& pl, cudaStream_t stream) {
  static int granted = 0;
  const int e =
      opt_in_smem(census_tile_kernel<V, ALIGNED, TABLES>, pl, &granted);
  if (e != 0) return e;
  const Geom g{pl.tile_rows, pl.chunk, pl.pitch, pl.table_bytes,
               pl.stage_bytes};
  census_tile_kernel<V, ALIGNED, TABLES>
      <<<pl.blocks, pl.threads, pl.smem_bytes, stream>>>(a, g);
  return static_cast<int>(cudaGetLastError());
}

template <int V, bool ALIGNED>
int launch_tile_tables(const Args& a, const Plan& pl, cudaStream_t stream) {
  return pl.tables ? launch_tile<V, ALIGNED, true>(a, pl, stream)
                   : launch_tile<V, ALIGNED, false>(a, pl, stream);
}

template <int V>
int launch_tile_aligned(const Args& a, const Plan& pl, cudaStream_t stream) {
  return pl.aligned ? launch_tile_tables<V, true>(a, pl, stream)
                    : launch_tile_tables<V, false>(a, pl, stream);
}

}  // namespace

extern "C" int census_launch(const void* base, const void* mask,
                             const void* agg, const void* fail,
                             const void* err, void* busy, void* excl,
                             int64_t n, int64_t b, int32_t p,
                             const int32_t* plan, void* stream) {
  const int64_t rows = n * b;
  if (rows <= 0) return 0;
  Plan pl;
  memcpy(&pl, plan, sizeof(Plan));
  const Args a{static_cast<const float*>(base),
               static_cast<const float*>(mask),
               static_cast<const float*>(agg),
               static_cast<const int32_t*>(fail),
               static_cast<const uint8_t*>(err),
               static_cast<float*>(busy),
               static_cast<float*>(excl),
               rows,
               static_cast<int32_t>(b),
               p};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pl.path == 0) {
    switch (p) {
      case 1: return launch_stream<1>(a, pl, st);
      case 2: return launch_stream<2>(a, pl, st);
      case 3: return launch_stream<3>(a, pl, st);
      case 4: return launch_stream<4>(a, pl, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (pl.vec) {
    case 4: return launch_tile_aligned<4>(a, pl, st);
    case 2: return launch_tile_aligned<2>(a, pl, st);
    case 1: return launch_tile_aligned<1>(a, pl, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int census_ragged_launch(
    const void* hop_ptr, const void* walk_hops, const void* step_q,
    const void* step_floor, const void* call_ptr, const void* call_col,
    const void* child_ptr, const void* child_col, const void* dur,
    const void* transport, const void* err, void* busy, void* fail,
    void* off, int64_t n, int32_t l, int32_t w, int32_t k, int32_t c,
    int32_t p, int32_t uniform, int32_t keep_nan, int32_t walk_blocks,
    int32_t row_blocks, int32_t threads, void* stream) {
  if (n * l <= 0) return 0;
  const RaggedArgs a{static_cast<const int32_t*>(hop_ptr),
                     static_cast<const int32_t*>(walk_hops),
                     static_cast<const int32_t*>(step_q),
                     static_cast<const float*>(step_floor),
                     static_cast<const int32_t*>(call_ptr),
                     static_cast<const int32_t*>(call_col),
                     static_cast<const int32_t*>(child_ptr),
                     static_cast<const int32_t*>(child_col),
                     static_cast<const float*>(dur),
                     static_cast<const uint8_t*>(transport),
                     static_cast<const uint8_t*>(err),
                     static_cast<float*>(busy),
                     static_cast<int32_t*>(fail),
                     static_cast<float*>(off),
                     n, l, w, k, c, p, uniform, keep_nan, walk_blocks};
  census_ragged_kernel<<<walk_blocks + row_blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* census_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
