// The blame sweep of attributed runs, for Hopper (sm_90a).
//
// Replaces no Pallas TPU kernel: the JAX package leaves the sweep to XLA
// (isotope_tpu/metrics/attribution.py, `attribute_block`), which fuses
// it into the block's program.  Eager PyTorch ran it as ~400 launches a
// block: per level elementwise, gather, `scatter_reduce` and float64
// `index_add_` passes over (N, L) grids, and int64 `index_add_`s that
// add every hop-row's weight, the zeros of the hops off the critical
// path too, into the blame histograms (metrics/attribution.py `_sweep`,
// the CPU's path).  This kernel is that chain fused, for every caller of
// `attribute_block` on the card: solo runs, folded fleets (M members'
// rows, member-major), protected and mesh-shard runs.
//
// What bounds it: bytes, in principle.  The work needs each of the
// block's hop tensors read once: hop_latency and hop_wait at 4 B a
// hop-row, hop_sent and hop_error at 1 B (317 MB and 0.095 ms at 3.35
// TB/s for a 262,144 x 121 block); the few float64 logs of the
// critical-path hops (one a level a request on a tree) are the rest.  It
// reads a hop's latency and sent flag twice (as a child and as a
// parent), and writes and reads again 4 B a column a tile of 32 rows
// (~1.2 B a hop-row).  Measured, the walk's chain of dependent
// shared-memory reads, table reads and window fills sets its time (~1.1
// ms a tree121 block on an H100), not the bytes.
//
// Design.  A warp takes a tile of 32 rows, a lane a row, and walks the
// levels in order; each lane keeps its row's crit weights (0 or 1, as
// bits) of the current and the next level in shared memory, so the
// widest level sets how many warps a block holds (`launch_plan` in
// native/blame.py; this file takes the plan as given), or, where not one
// warp's fit, in a region of device memory a warp.  The tile's rows
// of the hop arrays come through windows in shared memory, filled by
// the whole warp a few hops at a time (the walk asks for the same hop on
// every lane).  For each hop it takes each call-bearing step (slot): the
// calls' durations (attempts summed in attempt order, each `sent *
// min(rtt + lat, timeout)`), the first maximum, gated by the slot's
// sleep floor; then each attempt's path weight, charged duration D (a
// float64 sum rounded once), net and timeout charges and the next
// level's weights; then the hop's wait, self and contribution.  A lane
// adds its request's charges level by level as the chain does: the
// level's children in the tables' order, then their timeouts, then its
// hops.  It sums them in float64: the residual (client latency less the
// charges) is the rounding noise of that sum, which a float32 running
// sum in this order left ~45 float32 spacings of the latency sum from
// the chain's on a 100,000-hop graph.
//
// Sums.  Each column (a field of a hop) a tile sums is a pairwise tree
// over the tile's rows, taken a column a lane from shared memory and
// stored 16 at a time into the tile's row of partials.  The columns come
// in two streams: the main one, which every tile writes, and the tail
// one (the sums weighed by the tail cut), which only a tile with a row
// past the cut writes; timeout columns only for levels with a timeout.
// A second pass sums each member's tiles by groups of `fold_group` in
// order (a tile without tail rows adds nothing to a tail column), then
// the groups in order, and adds the total into the run's accumulator:
// the float32 sums come out the same on every run.  The blame histograms
// add only where the weight is nonzero, a critical-path hop (~5 of 121
// hops a request on the tree), one int64 atomic each into the
// accumulator's bins.  Integer sums are exact in any order.
//
// Arithmetic: every float32 product, sum and difference is rounded on
// its own (__fmul_rn / __fadd_rn / __fsub_rn: no fused multiply-add), D
// adds in float64 (__dadd_rn) and rounds once, the bucket's log is a
// float64 `log`, its affine map __dsub_rn / __dmul_rn; min, max and the
// clamps keep NaN as torch's do.  `blame_sweep_sequential` is this
// kernel's order in plain torch, and the kernel equals it bit for bit.
//
// C interface, loaded with ctypes: pointers and sizes as int64 arrays,
// the constants as doubles, the launch plan as an int32 array (layouts:
// `blame_launch` and `Plan` below).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBuckets = 64;
constexpr int kFieldShift = 27;
constexpr int kHopMask = (1 << kFieldShift) - 1;

// the fields of a column (native/blame.py FIELDS): float32 sums, counts
enum Field : int {
  kWait, kSelf, kNet, kTimeout, kTailWait, kTailSelf, kTailNet,
  kTailTimeout, kResidual, kResidualAbs, kCrit, kTailCrit, kError,
  kTailCount,
};

struct Plan {
  int32_t warps;           // warps a block
  int32_t ctas;            // blocks
  int32_t tiles;           // tiles of 32 rows a member
  int32_t fold_group;      // tiles a group of the second pass
  int32_t groups;          // groups a member
  int32_t smem_bytes;      // dynamic shared memory a block
  int32_t words;           // 32-bit words of a lane's crit bits a level
  int32_t global_bits;     // the crit bits in device memory, a region a warp
};

struct Args {
  const float* lat;            // (M N, H)
  const float* wait;           // (M N, H)
  const uint8_t* sent;         // (M N, H) bool
  const uint8_t* err;          // (M N, H) bool
  const float* client;         // (M N,)
  const int32_t* level_offset; // (L + 1,)
  const int32_t* level_timeout;  // (L,)
  const int32_t* slot_ptr;     // (H + 1,)
  const int4* slots;           // (NS,) first attempt, end, sleep floor, 0
  const int4* attempts;        // (NA,) hop, rtt, timeout, flags
  const int32_t* hop_bin;      // (H,)
  const int32_t* col_map;      // (cols,)
  uint32_t* part;              // (M, tiles, cols) float32 / uint32
  int32_t* tail_tile;          // (M, tiles) 1 where the tile wrote its tail columns
  unsigned* bits;              // (ctas, warps, 2, words, 32) where global_bits
  float* accf;                 // the accumulator's float32 buffer
  unsigned long long* acci;    // its int64 buffer
  int64_t rows;                // rows a member
  int32_t members;             // M, at least 1
  int32_t hops;
  int32_t services;
  int32_t levels;
  int32_t cols;
  int32_t main_cols;           // the columns of every tile; the rest are tail columns
  int32_t tail;
  float cut;
  float root_net;
  float refused_net;
  double log_lo;
  double inv_log_r;
};

// torch.minimum / torch.maximum: NaN wins
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) || isnan(b) ? NAN : fminf(a, b);
}

__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) || isnan(b) ? NAN : fmaxf(a, b);
}

// A warp's columns of one tile.  Each lane writes its row's value of a
// column into a ring of kColSlots columns in shared memory; once kColBlock
// are pending, lane j sums column j over the tile's rows (a pairwise tree:
// ((r0 + r1) + (r2 + r3)) + ...) and the block is stored, a column a lane,
// into the tile's row of partials.
constexpr int kColSlots = 32;
constexpr int kColBlock = 16;
constexpr int kColRows = 33;   // a column's lanes, padded against bank conflicts

struct Columns {
  uint32_t* buf;           // [kColSlots][kColRows]: a column slot's lanes
  uint32_t* out;           // the tile's row of partials
  const int32_t* col_map;  // its columns' codes
  int col;                 // columns written
  int done;                // columns stored
  int lane;

  __device__ __forceinline__ void put(uint32_t v) {
    buf[(col % kColSlots) * kColRows + lane] = v;
    ++col;
  }

  // store the columns from `done` on, n <= kColBlock of them
  __device__ __forceinline__ void store(int n) {
    __syncwarp();
    if (lane < n) {
      const int j = done + lane;
      const uint32_t* c = buf + (j % kColSlots) * kColRows;
      if ((__ldg(col_map + j) >> kFieldShift) >= kCrit) {
        uint32_t s = 0u;
#pragma unroll
        for (int i = 0; i < 32; ++i) s += c[i];
        out[j] = s;
      } else {
        float v[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) v[i] = __uint_as_float(c[i]);
#pragma unroll
        for (int w = 1; w < 32; w <<= 1) {
#pragma unroll
          for (int i = 0; i < 32; i += 2 * w) v[i] = __fadd_rn(v[i], v[i + w]);
        }
        out[j] = __float_as_uint(v[0]);
      }
    }
    __syncwarp();
    done += n;
  }

  // between puts, never more than kColSlots - kColBlock columns apart
  __device__ __forceinline__ void drain() {
    if (col - done >= kColBlock) store(kColBlock);
  }

  __device__ __forceinline__ void flush() {
    while (col > done) store(min(col - done, kColBlock));
  }

  __device__ __forceinline__ void sum(float v) { put(__float_as_uint(v)); }

  __device__ __forceinline__ void count(bool b) { put(b ? 1u : 0u); }
};

// attribution.blame_bucket_index of clamp(contrib, min=0) in float64
__device__ __forceinline__ int bucket(float contrib, double log_lo,
                                      double inv_log_r) {
  const float c = isnan(contrib) ? contrib : fmaxf(contrib, 0.0f);
  double t = __dmul_rn(__dsub_rn(log(static_cast<double>(c)), log_lo),
                       inv_log_r);
  if (isnan(t)) return kBuckets - 1;
  t = fmin(fmax(t, -1.0), static_cast<double>(kBuckets - 2));
  return static_cast<int>(floor(t)) + 1;
}

constexpr int kTileRows = 32;   // a lane a row

// Windows: the tile's rows of kWin consecutive hops of the hop arrays in
// shared memory, hop-major.  The walk asks for hops in order, the same hop
// on every lane: the parents' (latency, wait, sent, error) from first to
// last, the children's (latency, sent) a step at a time.  So the warp
// fills a window's arrays together, each row's hops contiguous (the
// float32 arrays with asynchronous copies, cp.async, the bytes with
// plain loads, all in flight at once), and a lane reads its row.
constexpr int kWin = 8;
constexpr int kWinRows = kTileRows + 1;   // padded against bank conflicts

struct Rows {                  // the tile's rows
  const float* lat;
  const float* wait;
  const uint8_t* sent;
  const uint8_t* err;
  int h_all;
  int nrows;                   // rows of the tile in the block (the rest read 0)
};

// 4 bytes from src to shared dst, of which the first `bytes` are read
// and the rest are 0
__device__ __forceinline__ void copy4(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

// this lane's copies landed, and every lane's are seen
__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
}

// hops base.. of the float32 array p: element (row, i) at
// buf[i * kWinRows + row], 0 past the tile
__device__ __forceinline__ void fill_floats(float* buf, const float* p,
                                            const Rows& r, int base,
                                            int lane) {
#pragma unroll 4
  for (int q = 0; q < kWin; ++q) {
    const int e = q * 32 + lane;
    const int row = e / kWin;
    const int i = e % kWin;
    const bool in = row < r.nrows && base + i < r.h_all;
    copy4(buf + i * kWinRows + row,
          in ? p + static_cast<int64_t>(row) * r.h_all + base + i : p,
          in ? 4 : 0);
  }
}

// hops base.. of the byte array p: element (row, i) at
// buf[i * kWinRows + row], 0 past the tile (plain loads: a byte is less
// than an asynchronous copy takes)
__device__ __forceinline__ void fill_bytes(uint8_t* buf, const uint8_t* p,
                                           const Rows& r, int base,
                                           int lane) {
#pragma unroll
  for (int q = 0; q < kWin; ++q) {
    const int e = q * 32 + lane;
    const int row = e / kWin;
    const int i = e % kWin;
    buf[i * kWinRows + row] =
        row < r.nrows && base + i < r.h_all
            ? p[static_cast<int64_t>(row) * r.h_all + base + i]
            : uint8_t{0};
  }
}

struct ParentWindow {
  float* lat;                  // [kWin][kWinRows]
  float* wait;
  uint8_t* sent;               // [kWin][kWinRows]
  uint8_t* err;
  int base;                    // first hop held; -kWin none

  // hop j held; its slot of row 0 returned (the lane's row: + lane)
  __device__ __forceinline__ int need(const Rows& r, int j, int lane) {
    if (static_cast<unsigned>(j - base) >= static_cast<unsigned>(kWin)) {
      __syncwarp();
      base = j - j % kWin;
      fill_floats(lat, r.lat, r, base, lane);
      fill_floats(wait, r.wait, r, base, lane);
      fill_bytes(sent, r.sent, r, base, lane);
      fill_bytes(err, r.err, r, base, lane);
      copies_done();
    }
    return (j - base) * kWinRows;
  }
};

struct ChildWindow {
  float* lat;
  uint8_t* sent;
  int base;

  // hops lo..hi held (filled from lo where they are not)
  __device__ __forceinline__ void cover(const Rows& r, int lo, int hi,
                                        int lane) {
    if (lo < base || hi >= base + kWin) {
      __syncwarp();
      base = lo;
      fill_floats(lat, r.lat, r, base, lane);
      fill_bytes(sent, r.sent, r, base, lane);
      copies_done();
    }
  }

  __device__ __forceinline__ int need(const Rows& r, int j, int lane) {
    cover(r, j, j, lane);
    return (j - base) * kWinRows;
  }
};

// an attempt record's flags (native/blame.py FIRST_ATTEMPT, LAST_ATTEMPT)
constexpr int kFirstAttempt = 1;
constexpr int kLastAttempt = 2;

// bytes of a warp's windows (three float32, three byte arrays) and of
// its columns
constexpr int kWindowBytes =
    3 * kWin * kWinRows * 4 + ((3 * kWin * kWinRows + 3) / 4) * 4;
constexpr int kColBytes = 2 * kColSlots * kColRows * 4;   // two streams

__global__ void __launch_bounds__(256)
blame_sweep_kernel(const Args a, const Plan pl) {
  extern __shared__ unsigned smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int h_all = a.hops;
  const int nbins = a.members * a.services * kBuckets;
  const int bit_words = 2 * pl.words * 32;
  unsigned long long* hist =
      a.acci + 3LL * a.members * h_all + 2LL * a.members;
  const int smem_bits = pl.global_bits ? 0 : bit_words;
  uint32_t* colbuf =
      smem + warp * (smem_bits + (kColBytes + kWindowBytes) / 4);
  unsigned* bits =
      pl.global_bits
          ? a.bits + (static_cast<int64_t>(blockIdx.x) * pl.warps + warp) *
                         bit_words
          : colbuf;
  colbuf += smem_bits;
  float* wf = reinterpret_cast<float*>(colbuf + kColBytes / 4);
  uint8_t* wb = reinterpret_cast<uint8_t*>(wf + 3 * kWin * kWinRows);
  const int64_t total = static_cast<int64_t>(a.members) * pl.tiles;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * pl.warps + warp;
       q < total; q += static_cast<int64_t>(gridDim.x) * pl.warps) {
    const int m = static_cast<int>(q / pl.tiles);
    const int64_t first = (q % pl.tiles) * kTileRows;
    const int64_t left = a.rows - first;
    const Rows rows{a.lat + (m * a.rows + first) * h_all,
                    a.wait + (m * a.rows + first) * h_all,
                    a.sent + (m * a.rows + first) * h_all,
                    a.err + (m * a.rows + first) * h_all, h_all,
                    static_cast<int>(left < kTileRows ? left : kTileRows)};
    ParentWindow pw{wf, wf + kWin * kWinRows, wb, wb + kWin * kWinRows,
                    -kWin};
    ChildWindow cw{wf + 2 * kWin * kWinRows, wb + 2 * kWin * kWinRows,
                   -kWin};
    const int hbase = m * a.services * kBuckets;
    // the main columns, and the tail-weighted ones (written by a tile
    // with a row past the tail cut only: the others' are all 0)
    Columns st{colbuf, a.part + q * a.cols, a.col_map, 0, 0, lane};
    Columns tst{colbuf + kColSlots * kColRows,
                a.part + q * a.cols + a.main_cols, a.col_map + a.main_cols, 0,
                0, lane};
    // the lane's row: its client latency, tail weight, running sum of
    // charges and crit bits
    const bool live = lane < rows.nrows;
    const float cl = live ? a.client[m * a.rows + first + lane] : 0.0f;
    const float tw = a.tail && live && cl >= a.cut ? 1.0f : 0.0f;
    const int k_root = pw.need(rows, 0, lane) + lane;
    const bool s0 = live && pw.sent[k_root] != 0;
    const float net0 = live ? (s0 ? a.root_net : a.refused_net) : 0.0f;
    double per_req = net0;   // the request's charges, summed in float64
    unsigned* cur = bits;
    unsigned* nxt = bits + pl.words * 32;
    cur[lane] = s0 ? 1u : 0u;
    const bool tail_tile = __any_sync(kFull, tw != 0.0f);
    st.sum(net0);
    if (tail_tile) tst.sum(__fmul_rn(net0, tw));
    for (int d = 0; d < a.levels; ++d) {
      const int h0 = a.level_offset[d];
      const int h1 = a.level_offset[d + 1];
      const bool has_timeout = a.level_timeout[d] != 0;
      if (d + 1 < a.levels) {
        const int words = (a.level_offset[d + 2] - h1 + 31) >> 5;
        for (int w = 0; w < words; ++w) nxt[w * 32 + lane] = 0u;
      }
      double s_net = 0.0, s_tmo = 0.0, s_con = 0.0;
      for (int p = h0; p < h1; ++p) {
        const int lp = p - h0;
        const float wp =
            (cur[(lp >> 5) * 32 + lane] >> (lp & 31)) & 1u ? 1.0f : 0.0f;
        double dsum = 0.0;
        const int s1 = a.slot_ptr[p + 1];
        for (int s = a.slot_ptr[p]; s < s1; ++s) {
          const int4 slot = __ldg(a.slots + s);
          // the step's attempts are one run of children: held together
          cw.cover(rows, __ldg(a.attempts + slot.x).x,
                   __ldg(a.attempts + slot.y - 1).x, lane);
          // the step's max (over 0 and its calls) and its first maximum,
          // the calls numbered from 0 in call order; a NaN duration makes
          // the max NaN and leaves no winner
          float mx = 0.0f, dur = 0.0f;
          int win = -1, k = 0;
          for (int e = slot.x; e < slot.y; ++e) {
            const int4 rec = __ldg(a.attempts + e);
            const int kc = cw.need(rows, rec.x, lane) + lane;
            const float raw = __fadd_rn(__int_as_float(rec.y), cw.lat[kc]);
            const float ad = __fmul_rn(
                cw.sent[kc] ? 1.0f : 0.0f,
                has_timeout ? minimum(raw, __int_as_float(rec.z)) : raw);
            dur = rec.w & kFirstAttempt ? ad : __fadd_rn(dur, ad);
            if (!(rec.w & kLastAttempt)) continue;
            if (isnan(mx)) {
            } else if (isnan(dur)) {
              mx = dur;
              win = -1;
            } else if (dur > mx) {
              mx = dur;
              win = k;
            } else if (dur == mx && win < 0) {
              win = k;
            }
            ++k;
          }
          const bool beats = mx >= __int_as_float(slot.z);
          k = 0;
          for (int e = slot.x; e < slot.y; ++e) {
            const int4 rec = __ldg(a.attempts + e);
            const int kc = cw.need(rows, rec.x, lane) + lane;
            const float rtt = __int_as_float(rec.y);
            const float tmo = __int_as_float(rec.z);
            const float wk = __fmul_rn(wp, k == win && beats ? 1.0f : 0.0f);
            if (rec.w & kLastAttempt) ++k;
            const float sc = cw.sent[kc] ? 1.0f : 0.0f;
            const float raw = __fadd_rn(rtt, cw.lat[kc]);
            const float ad =
                __fmul_rn(sc, has_timeout ? minimum(raw, tmo) : raw);
            const float on = __fmul_rn(wk, sc);
            const bool capped = has_timeout && raw > tmo;
            dsum = __dadd_rn(dsum, static_cast<double>(__fmul_rn(on, ad)));
            const float wn =
                has_timeout ? __fmul_rn(on, capped ? 0.0f : 1.0f) : on;
            if (wn != 0.0f) {
              const int lc = rec.x - h1;
              nxt[(lc >> 5) * 32 + lane] |= 1u << (lc & 31);
            }
            float net = __fmul_rn(wn, rtt);
            float tmc = has_timeout
                            ? __fmul_rn(__fmul_rn(on, capped ? 1.0f : 0.0f), ad)
                            : 0.0f;
            s_net = __dadd_rn(s_net, static_cast<double>(net));
            s_tmo = __dadd_rn(s_tmo, static_cast<double>(tmc));
            if (!live) net = tmc = 0.0f;
            st.sum(net);
            if (has_timeout) st.sum(tmc);
            if (tail_tile) {
              tst.sum(__fmul_rn(net, tw));
              if (has_timeout) tst.sum(__fmul_rn(tmc, tw));
              tst.drain();
            }
            st.drain();
          }
        }
        const int kp = pw.need(rows, p, lane) + lane;
        const float dp = __double2float_rn(dsum);
        const float lat_p = pw.lat[kp];
        const float wait_p = pw.wait[kp];
        float hw = __fmul_rn(wp, wait_p);
        float hs = __fsub_rn(__fmul_rn(wp, __fsub_rn(lat_p, wait_p)), dp);
        const float con = __fadd_rn(hw, hs);
        s_con = __dadd_rn(s_con, static_cast<double>(con));
        const bool on_p = wp != 0.0f;
        const bool on_t = __fmul_rn(wp, tw) != 0.0f;
        if (on_p) {
          const int bin = hbase + __ldg(a.hop_bin + p) +
                          bucket(con, a.log_lo, a.inv_log_r);
          atomicAdd(hist + bin, 1ull);
          if (on_t) atomicAdd(hist + nbins + bin, 1ull);
        }
        if (!live) hw = hs = 0.0f;
        st.sum(hw);
        st.sum(hs);
        st.count(on_p);
        st.count(live && pw.sent[kp] != 0 && pw.err[kp] != 0);
        st.drain();
        if (tail_tile) {
          tst.sum(__fmul_rn(hw, tw));
          tst.sum(__fmul_rn(hs, tw));
          tst.count(on_t);
          tst.drain();
        }
      }
      per_req = __dadd_rn(per_req, s_net);
      per_req = __dadd_rn(per_req, s_tmo);
      per_req = __dadd_rn(per_req, s_con);
      unsigned* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    const float res =
        live ? __double2float_rn(__dsub_rn(static_cast<double>(cl), per_req))
             : 0.0f;
    st.sum(res);
    st.sum(fabsf(res));
    st.count(tw != 0.0f);
    st.flush();
    if (tail_tile) tst.flush();
    if (lane == 0) a.tail_tile[q] = tail_tile;
  }
}


// The second pass, for kRedCols columns of one member a block: each
// group of fold_group tiles summed in order (a thread a group and
// column), then the groups in order, and the total added to the
// accumulator (layout: metrics/attribution.py `_acc_layout`).
constexpr int kRedCols = 4;
constexpr int kRedThreads = 256;

__global__ void __launch_bounds__(kRedThreads)
blame_reduce_kernel(const Args a, const Plan pl) {
  extern __shared__ uint32_t group_sums[];    // [groups][kRedCols]
  const int m = blockIdx.y;
  const int jx = threadIdx.x % kRedCols;
  const int j = blockIdx.x * kRedCols + jx;
  const bool in = j < a.cols;
  const int code = in ? a.col_map[j] : 0;
  const bool count = (code >> kFieldShift) >= kCrit;
  // a tail column of a tile without tail rows holds nothing: it adds 0
  const int32_t* wrote =
      in && j >= a.main_cols
          ? a.tail_tile + static_cast<int64_t>(m) * pl.tiles
          : nullptr;
  for (int g = threadIdx.x / kRedCols; in && g < pl.groups;
       g += kRedThreads / kRedCols) {
    const int t0 = g * pl.fold_group;
    const int t1 = min(t0 + pl.fold_group, pl.tiles);
    const uint32_t* src =
        a.part + (static_cast<int64_t>(m) * pl.tiles + t0) * a.cols + j;
    uint32_t n = 0u;
    float s = 0.0f;
    for (int t = t0; t < t1; ++t) {
      if (wrote != nullptr && !wrote[t]) continue;
      const uint32_t v = src[static_cast<int64_t>(t - t0) * a.cols];
      if (count) {
        n += v;
      } else {
        s = __fadd_rn(s, __uint_as_float(v));
      }
    }
    group_sums[g * kRedCols + jx] = count ? n : __float_as_uint(s);
  }
  __syncthreads();
  if (threadIdx.x >= kRedCols || !in) return;
  const int f = code >> kFieldShift;
  const int64_t h = code & kHopMask;
  const int64_t mh = static_cast<int64_t>(a.members) * a.hops;
  if (count) {
    unsigned long long n = 0ull;
    for (int g = 0; g < pl.groups; ++g) n += group_sums[g * kRedCols + jx];
    const int64_t off = f == kTailCount
                            ? 3 * mh + a.members + m
                            : (f - kCrit) * mh + static_cast<int64_t>(m) * a.hops + h;
    a.acci[off] += n;
  } else {
    float s = 0.0f;
    for (int g = 0; g < pl.groups; ++g) {
      s = __fadd_rn(s, __uint_as_float(group_sums[g * kRedCols + jx]));
    }
    const int64_t off = f < kResidual
                            ? f * mh + static_cast<int64_t>(m) * a.hops + h
                            : 8 * mh + (f - kResidual) * a.members + m;
    a.accf[off] = __fadd_rn(a.accf[off], s);
  }
  if (j == 0) {
    a.acci[3 * mh + m] += static_cast<unsigned long long>(a.rows);
    const int64_t c = 8 * mh + 2 * a.members + m;
    const float cut = a.tail ? a.cut : INFINITY;
    a.accf[c] = maximum(a.accf[c], cut);
  }
}

cudaError_t sweep(const Args& a, const Plan& pl, cudaStream_t st) {
  static bool sized = false;
  if (!sized && pl.smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        blame_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        232448);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  blame_sweep_kernel<<<pl.ctas, pl.warps * 32, pl.smem_bytes, st>>>(a, pl);
  return cudaGetLastError();
}

}  // namespace

// ptr: lat, wait, sent, err, client, level_offset, level_timeout,
//      slot_ptr, slots, attempts, hop_bin, col_map, part, tail_tile, bits,
//      accf, acci
// dims: rows a member, members (at least 1), hops, services, levels,
//       cols, main_cols, tail
// consts: cut, root_net, refused_net (float32 values), log_lo, inv_log_r
extern "C" int blame_launch(const int64_t* ptr, const int64_t* dims,
                            const double* consts, const int32_t* plan,
                            void* stream) {
  Plan pl;
  memcpy(&pl, plan, sizeof(Plan));
  Args a;
  a.lat = reinterpret_cast<const float*>(ptr[0]);
  a.wait = reinterpret_cast<const float*>(ptr[1]);
  a.sent = reinterpret_cast<const uint8_t*>(ptr[2]);
  a.err = reinterpret_cast<const uint8_t*>(ptr[3]);
  a.client = reinterpret_cast<const float*>(ptr[4]);
  a.level_offset = reinterpret_cast<const int32_t*>(ptr[5]);
  a.level_timeout = reinterpret_cast<const int32_t*>(ptr[6]);
  a.slot_ptr = reinterpret_cast<const int32_t*>(ptr[7]);
  a.slots = reinterpret_cast<const int4*>(ptr[8]);
  a.attempts = reinterpret_cast<const int4*>(ptr[9]);
  a.hop_bin = reinterpret_cast<const int32_t*>(ptr[10]);
  a.col_map = reinterpret_cast<const int32_t*>(ptr[11]);
  a.part = reinterpret_cast<uint32_t*>(ptr[12]);
  a.tail_tile = reinterpret_cast<int32_t*>(ptr[13]);
  a.bits = reinterpret_cast<unsigned*>(ptr[14]);
  a.accf = reinterpret_cast<float*>(ptr[15]);
  a.acci = reinterpret_cast<unsigned long long*>(ptr[16]);
  a.rows = dims[0];
  a.members = static_cast<int32_t>(dims[1]);
  a.hops = static_cast<int32_t>(dims[2]);
  a.services = static_cast<int32_t>(dims[3]);
  a.levels = static_cast<int32_t>(dims[4]);
  a.cols = static_cast<int32_t>(dims[5]);
  a.main_cols = static_cast<int32_t>(dims[6]);
  a.tail = static_cast<int32_t>(dims[7]);
  a.cut = static_cast<float>(consts[0]);
  a.root_net = static_cast<float>(consts[1]);
  a.refused_net = static_cast<float>(consts[2]);
  a.log_lo = consts[3];
  a.inv_log_r = consts[4];
  if (a.members < 1 || a.hops < 1 || a.levels < 1 || a.cols < 1 ||
      a.main_cols < 1 || a.main_cols > a.cols ||
      pl.warps < 1 || pl.warps > 8 || pl.words < 1 || pl.ctas < 1 ||
      pl.fold_group < 1 || pl.smem_bytes > 232448 ||
      (pl.tiles > 0 && pl.groups < 1) ||
      pl.groups * kRedCols * 4 > 232448) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pl.tiles > 0) {
    const cudaError_t e = sweep(a, pl, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((a.cols + kRedCols - 1) / kRedCols, a.members);
  blame_reduce_kernel<<<grid, kRedThreads,
                        max(pl.groups, 1) * kRedCols * sizeof(uint32_t), st>>>(
      a, pl);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* blame_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
