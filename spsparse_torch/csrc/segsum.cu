// Segmented row sums for Hopper (sm_90a), behind a plain C interface.
//
// K10  sps_segsum  replaces spsparse_tpu/ops/pallas_segsum.py::_segsum_kernel
//                  y[r] = sum_{e in [rp[r], rp[r+1])} prod[e]
//
// The TPU kernel computed R row sums at a time as one masked (R, W) @ (W,)
// product on the MXU over a 1024-aligned DMA window of entries, sized by
// the caller's rows_per_block / entries_per_block. None of that is the
// function: it is the per-row sum over the entries [rp[0], rp[nrows]).
//
// Bound. Each entry's product is read once (4 bytes), row_ptr once and y
// written once: 4 nnz + 8 nrows bytes, one add per entry, so the kernel is
// bound by device memory (15.0 us at config 2c on an H100 SXM).
//
// Design: a fixed number of entries a CTA, in the manner of merge-path.
//
// * CTA c holds the entries [c * kTile, (c + 1) * kTile) of prod, warp w
//   the 512 at w * 512, lane l the groups of four at 128 g + 4 l (g < 4):
//   16-byte loads (when prod is 16-byte aligned) and reads of the row marks
//   below that are one coalesced 512-byte line a warp.
// * A row belongs to the tile that holds its last entry (an empty row to
//   the tile holding its position; the rows before the first entry to the
//   first tile, those after the last to the last). A tile reads rp[0] and
//   rp[nrows] (tiles wholly outside exit), then, in one round, its entries
//   and kWin row pointers where an even spread of the entries over the
//   rows puts its rows. An interior tile loads its entries whole; an edge
//   tile only those in [rp[0], rp[nrows]) (a group of four that reaches
//   outside, as the unaligned head, one entry at a time), so that nothing
//   outside that range is read. When the window holds the tile's rows, the
//   tile marks in shared memory the entry at which each of its non-empty
//   rows ends, with no further dependent load; otherwise (rows far from
//   the mean length) warp 0 finds the tile's first row by a 32-way search
//   of row_ptr (four rounds at 2^20 rows) and the tile reads its rows'
//   pointers in coalesced rounds. Empty rows get 0.
// * Each lane sums its group of four in order, cutting at the marks; a
//   segmented warp scan a group (the sums by shuffles, the row-end flags by
//   one ballot) carries the sums across lanes and groups in entry order,
//   and the eight warp totals in shared memory carry them across warps.
//   Every row is written whole by the lane that holds its last entry.
// * A row that began in an earlier tile (a long row spans several) is
//   completed deterministically: each tile publishes its carry (the sum of
//   its entries after its last row end; by its last warp, before the CTA's
//   barrier, when a row ends there) with a release store tagged with
//   the call's tag, and the thread that ends the row adds the carries of
//   the tiles back to the row's first, in descending order, each read with
//   an acquire load once it carries the tag. A tile publishes before it
//   waits and waits only for lower tiles, which the hardware starts first,
//   so the wait ends. No float atomics: two calls give the same bits.
//
// The sum order (in order within a group, a fixed tree across lanes,
// groups and warps, the carries last) differs from the MXU's and from a
// sequential sum; callers hold it to an rtol. The caller allocates the carry slots (one
// 64-bit word a tile, zeroed once) and passes a tag that differs from every
// earlier call's on them. sps_segsum_geometry reports the launch;
// ops/segsum.py::segsum_geometry replays it on the host.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = 4;           // 16-byte groups a lane
constexpr int kItems = 4 * kGroups;  // entries a thread
constexpr int kWarpSpan = 32 * kItems;
constexpr int kTile = kThreads * kItems;
// Row pointers a tile reads at once where its rows are expected.
constexpr int kWin = 1024;
// A wait longer than this traps, so a fault shows as a launch error and not
// as a hang.
constexpr unsigned long long kCarryTimeoutNs = 20ull * 1000 * 1000 * 1000;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// First r in [0, nrows) with rp[r + 1] > a (it exists: rp[nrows] > a), by
// warp 0: each round the 32 lanes probe 32 points of the candidate range
// and the first lane whose probe holds narrows it to ~1/32.
__device__ long long first_row_ending_after(const int* __restrict__ rp,
                                            long long nrows, long long a) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = nrows - 1;  // the answer is in [lo, hi]
  while (hi > lo) {
    const long long span = hi - lo;
    const long long p = lo + span * (lane + 1) / 32;  // lane 31 probes hi
    const bool holds = lane == 31 || __ldg(rp + p + 1) > a;
    const unsigned ball = __ballot_sync(0xffffffffu, holds);
    const int first = __ffs(ball) - 1;
    const long long p_first = __shfl_sync(0xffffffffu, p, first);
    const long long p_before =
        __shfl_sync(0xffffffffu, p, first > 0 ? first - 1 : 0);
    lo = first > 0 ? p_before + 1 : lo;
    hi = p_first;
  }
  return lo;
}

struct Seg {
  float s;  // sum since the last row end (or the tile's start)
  bool f;   // a row ended in the range
};

// (earlier) then (later): the later part's sum alone if a row ended in it.
__device__ __forceinline__ Seg combine(Seg a, Seg b) {
  return {b.f ? b.s : a.s + b.s, a.f || b.f};
}

// The tile's carry, tagged with the call, after the tile's earlier stores.
__device__ __forceinline__ void publish(unsigned long long* slot,
                                        unsigned tag, float carry) {
  const unsigned long long word =
      (unsigned long long)tag << 32 | __float_as_uint(carry);
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :
               : "l"(slot), "l"(word)
               : "memory");
}

template <bool kVector>
__global__ void __launch_bounds__(kThreads)
    segsum_kernel(const float* __restrict__ prod, const int* __restrict__ rp,
                  long long nrows,
                  long long ntiles, float* __restrict__ y,
                  unsigned long long* __restrict__ carries, unsigned tag) {
  __shared__ __align__(16) int s_row[kTile];  // the row ending here, or -1
  __shared__ int s_rp[kWin];                  // the row-pointer window
  __shared__ Seg s_warp[kWarps];
  __shared__ long long s_first, s_lead;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long c = blockIdx.x;
  const long long a = c * kTile, b = a + kTile;
  const long long E0 = __ldg(rp), E1 = __ldg(rp + nrows);
  const long long c_first = min(E0 / kTile, ntiles - 1);
  const long long c_last = E1 > E0 ? (E1 - 1) / kTile : c_first;
  if (c < c_first || c > c_last) return;
  const bool first = c == c_first, last = c == c_last;
  // Every entry of an interior tile lies in [E0, E1).
  const bool interior = a >= E0 && b <= E1;

  // rp[w, w + kWin): where the rows ending in the tile are if the entries
  // are spread evenly over the rows (kWin / 8 rows early).
  long long w = first ? 0 : (a - E0) * nrows / (E1 - E0) - kWin / 8;
  w = w < 0 ? 0 : w > nrows ? nrows : w;
#pragma unroll
  for (int q = 0; q < kWin / kThreads; ++q) {
    const long long j = w + t + q * kThreads;
    s_rp[t + q * kThreads] = j <= nrows ? __ldg(rp + j) : 0x7fffffff;
  }

  // The tile's entries, 0 outside [E0, E1), warp-striped: lane l of warp
  // w holds the groups of four at w * kWarpSpan + g * 128 + 4 l, so that
  // each load (and each read of the marks below) is one coalesced 512-byte
  // line a warp.
  const long long base = a + (long long)warp * kWarpSpan + 4 * lane;
  float v[kGroups][4];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const long long e = base + 128 * g;
    if (kVector && (interior || (e >= E0 && e + 4 <= E1))) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(prod + e));
      v[g][0] = f.x, v[g][1] = f.y, v[g][2] = f.z, v[g][3] = f.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[g][j] = interior || (e + j >= E0 && e + j < E1)
                      ? __ldg(prod + e + j)
                      : 0.f;
    }
  }
#pragma unroll
  for (int q = 0; q < kTile / 4 / kThreads; ++q)
    reinterpret_cast<int4*>(s_row)[t + q * kThreads] =
        make_int4(-1, -1, -1, -1);
  if (t == 0) s_lead = a;
  __syncthreads();

  // Mark where the tile's rows end; empty rows are 0; note where the row
  // holding entry a begins. The window holds all the tile's rows when it
  // begins at or before its first (row w - 1 ends by a) and reaches past
  // its last (row w + kWin - 2 ends after b, or the window holds
  // rp[nrows]).
  const bool from_window =
      (first ? w == 0 : s_rp[0] <= a) &&
      (last ? nrows <= w + kWin - 1 : s_rp[kWin - 1] > b);
  if (from_window) {
    // Row w + j - 1 ends at s_rp[j], for j = 1 .. kWin - 1.
#pragma unroll
    for (int q = 0; q < kWin / kThreads; ++q) {
      const int j = t + q * kThreads;
      const long long r = w + j - 1;
      if (j == 0 || r >= nrows) continue;
      const int start = s_rp[j - 1], end = s_rp[j];
      if ((first || end > a) && (last || end <= b)) {
        if (start == end)
          y[r] = 0.f;
        else
          s_row[end - 1 - a] = (int)r;
        if (start <= a && a < end) s_lead = start;
      }
    }
    __syncthreads();
  } else {
    if (warp == 0) {
      const long long r = first ? 0 : first_row_ending_after(rp, nrows, a);
      if (lane == 0) {
        s_first = r;
        if (!first) s_lead = __ldg(rp + r);  // row r holds entry a
      }
    }
    __syncthreads();
    for (long long r = s_first + t;; r += kThreads) {
      bool mine = r < nrows;
      if (mine) {
        const int end = __ldg(rp + r + 1);
        mine = last || end <= b;
        if (mine) {
          if (__ldg(rp + r) == end)
            y[r] = 0.f;
          else
            s_row[end - 1 - a] = (int)r;
        }
      }
      if (__syncthreads_or(!mine)) break;
    }
  }

  // Each group of four in order, cut at the row ends; a warp scan a group
  // carries the sums across lanes, and the carry across groups, in entry
  // order. A row that ends in a group and began before it waits (as
  // `pending`) for the sum of the warps before.
  Seg carry{0.f, false};
  int pend_row[kGroups];
  float pend_head[kGroups];
  Seg pend_before[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int4 m4 = *reinterpret_cast<const int4*>(
        s_row + warp * kWarpSpan + 128 * g + 4 * lane);
    const int rows[4] = {m4.x, m4.y, m4.z, m4.w};
    float run = 0.f;
    pend_row[g] = -1;
    pend_head[g] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      run += v[g][j];
      if (rows[j] >= 0) {
        if (pend_row[g] < 0) {
          pend_head[g] = run;
          pend_row[g] = rows[j];
        } else {
          y[rows[j]] = run;
        }
        run = 0.f;
      }
    }
    // The lanes' row-end flags as one ballot; the scan shuffles only the
    // sums: at distance d a lane adds the sum d lanes down unless a row
    // ends in its own last d lanes (the segmented combine, unchanged).
    const unsigned ends = __ballot_sync(0xffffffffu, pend_row[g] >= 0);
    float inc = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float s = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d && ((ends >> (lane - d + 1)) & ((1u << d) - 1)) == 0)
        inc = s + inc;
    }
    const float up_s = __shfl_up_sync(0xffffffffu, inc, 1);
    pend_before[g] =
        lane > 0 ? combine(carry, {up_s, (ends & ((1u << lane) - 1)) != 0})
                 : carry;
    carry = combine(carry, {__shfl_sync(0xffffffffu, inc, 31), ends != 0});
  }
  if (lane == 0) s_warp[warp] = carry;
  // The tile's carry, the sum after its last row end, is the last warp's
  // when a row ends there: published before the barrier, so that the next
  // tile waits less for it.
  const bool last_warp_ends = warp == kWarps - 1 && carry.f;
  if (last_warp_ends && lane == 0) publish(carries + c, tag, carry.s);
  __syncthreads();
  Seg before_warp{0.f, false};
  for (int u = 0; u < warp; ++u) before_warp = combine(before_warp, s_warp[u]);
  if (t == kThreads - 1 && !carry.f)
    publish(carries + c, tag, combine(before_warp, carry).s);
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    if (pend_row[g] < 0) continue;
    const Seg before = combine(before_warp, pend_before[g]);
    float total = before.s + pend_head[g];
    if (!before.f && s_lead < a) {
      // The tile's first row began in tile c0 < c: add the carries of
      // c - 1 down to c0.
      const long long c0 = s_lead / kTile;
      const unsigned long long t0 = global_ns();
      for (long long cc = c - 1; cc >= c0; --cc) {
        unsigned long long word;
        for (unsigned spins = 0;; ++spins) {
          asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                       : "=l"(word)
                       : "l"(carries + cc)
                       : "memory");
          if ((unsigned)(word >> 32) == tag) break;
          if ((spins & 1023u) == 1023u &&
              global_ns() - t0 > kCarryTimeoutNs)
            __trap();
        }
        total += __uint_as_float((unsigned)word);
      }
    }
    y[pend_row[g]] = total;
  }
}

struct Geometry {
  long long tiles;
  bool vector;
};

Geometry geometry(long long numel, long long nrows, const void* prod) {
  Geometry g;
  g.tiles = nrows == 0 ? 0 : numel > kTile ? (numel + kTile - 1) / kTile : 1;
  g.vector = (reinterpret_cast<uintptr_t>(prod) & 15) == 0;
  return g;
}

}  // namespace

extern "C" {

// K10: y (nrows, float32) = per-row sums of prod (numel float32) over
// row_ptr (nrows + 1 int32 offsets into prod, 0 <= rp[0] <= ... <=
// rp[nrows] <= numel). carries: carries_cap >= the geometry's tiles 64-bit
// words, zeroed before first use; tag: nonzero and different from every
// earlier call's on these words.
int sps_segsum(const void* prod, long long numel, const void* row_ptr,
               long long nrows, void* y, void* carries, long long carries_cap,
               unsigned tag, void* stream) {
  if (nrows < 0 || nrows > 0x7fffffffLL || numel < 0 || tag == 0)
    return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(numel, nrows, prod);
  if (g.tiles == 0) return (int)cudaSuccess;
  if (g.tiles > carries_cap || g.tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(prod);
  const int* rp = static_cast<const int*>(row_ptr);
  float* out = static_cast<float*>(y);
  unsigned long long* cw = static_cast<unsigned long long*>(carries);
  if (g.vector)
    segsum_kernel<true><<<(unsigned)g.tiles, kThreads, 0, s>>>(
        p, rp, nrows, g.tiles, out, cw, tag);
  else
    segsum_kernel<false><<<(unsigned)g.tiles, kThreads, 0, s>>>(
        p, rp, nrows, g.tiles, out, cw, tag);
  return (int)cudaGetLastError();
}

// K10's launch: out[0..4] = entries a thread, threads, CTAs (one a tile),
// entries a tile, 16-byte loads (1) or single loads (0).
int sps_segsum_geometry(long long numel, long long nrows, const void* prod,
                        void* out) {
  if (nrows < 0 || numel < 0) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(numel, nrows, prod);
  long long* o = static_cast<long long*>(out);
  o[0] = kItems;
  o[1] = kThreads;
  o[2] = g.tiles;
  o[3] = kTile;
  o[4] = g.vector;
  return (int)cudaSuccess;
}

}  // extern "C"
