// Tiled general SpMM for Hopper (sm_90a), behind a plain C interface.
//
// K6  sps_tiled_dense   replaces spsparse_tpu/ops/pallas_tiled.py::
//                       _tiled_dense_kernel
//     Y_b = sum_t blocks[b, t] . X[tc*128 : tc*128 + 128]   (tc = tcols[b, t],
//     the sentinel nbc skipped), dense 128 x 128 blocks, float32 or bfloat16.
// K7  sps_tiled_onehot  replaces spsparse_tpu/ops/pallas_tiled.py::
//                       _tiled_kernel
//     Y[b*128 + rows[b,t,e], :] += vals[b,t,e] * X[tc*128 + cols[b,t,e], :]
//     over the entries of each live tile of block row b.
//
// K6: what bounds it, and the design: tiled_dense.cuh (a cp.async ring of
// k-chunks, bfloat16 on mma.sync tensor cores, float32 on SIMT FMAs with an
// 8 x 8 register tile a thread, two CTAs per SM). The TPU kernel
// double-buffered per-tile X DMAs and skipped the DMA of padding slots;
// here the ring streams the live (slot, k-chunk) sequence of a block row
// and a padding slot reads neither block nor X; the X tiles that
// neighbouring block rows share come from the 50 MB L2. The TPU kernel's
// 32 MiB VMEM guard is gone: a block row streams through shared memory a
// k-chunk at a time, at any number of slots. X is bounds-checked, not
// padded to (nbc*128, Np).
//
// K7: what bounds it, and the design. The TPU kernel built one-hot
// matrices in VMEM and used the matrix unit to gather and scatter, with one
// X tile a live tile double-buffered into VMEM; here no one-hot is built.
// The least traffic is every slot's value of the live tiles, each entry's
// row and column, each X row that an entry names once and Y once; the 2*N
// operations an entry are far below the float32 rate, so bytes bound it. A
// design that reads X from device memory entry by entry moves an X row a
// nonzero (at bench config 3, 13.1M entries x 512 B = 6.7 GB through L2,
// 12x the X rows it names) and is bound by L2 gathers. Two kernels:
//
// * The staged kernel (onehot_kernel). Persistent CTAs of 512 threads (16
//   warps), as many as are resident, walk block rows blockIdx.x, +
//   gridDim.x, ...; a CTA owns 128 output columns of its block rows (N >
//   128: one CTA a 128-column chunk), each lane 4 neighbouring columns
//   (16-byte vectors). The live tiles are cut into units of at most 4096
//   slots (one unit a tile unless tile_cap > 4096). For each unit the CTA
//   groups the nonzero slots by output row in shared memory, stable (each
//   row's entries in entry order; value-0 slots, the padding, add nothing
//   for finite X and are dropped): when the slots come in row order, as
//   from a row-sorted matrix, that is their compaction, else a ranking by
//   seven ballots over the row bits. It builds the set of X rows they name
//   (a 128-bit mask) and copies exactly those rows, the CTA's 128 columns
//   of each, into shared memory with cp.async (zero past K and N). A ring
//   of two or three stages runs across block-row boundaries: the next
//   units' rows are in flight while one computes, and the slots of the
//   unit after are loaded into registers meanwhile.
//   Warp w owns the output rows r with r % 16 == w and keeps them, 8 rows x
//   4 columns a lane, in registers for the whole block row: no Y tile in
//   shared memory and no read-modify-write chain through it. It walks each
//   of its rows' entries, reading the named X row from shared memory as a
//   float4 a lane (four in flight), and stores its rows from registers
//   after the block row's last unit. At bench config 3 the X reads from
//   shared memory (512 bytes an entry, 4 cycles of an SM's 128 bytes a
//   cycle) set the pace of the compute phase, and the grouping about as
//   much again: the two do not overlap.
// * The warp-per-block-row kernel (onehot_small_kernel) for layouts of at
//   most 256 entries a tile (prepare_general routes a mean fill below 64
//   to K7): too few entries for a staged X row to be read more than about
//   twice. It takes a block row's slots 256 at a time.
//
// Summation order in both: every output element receives one fmaf(val, x,
// y) per nonzero entry, starting from 0, over the live tiles in slot order
// and the entries of each in entry order (the order of the first, SIMT,
// body, since deleted); so the two kernels agree bit for bit, and results
// repeat from run to run.

#include "tiled_common.cuh"
#include "tiled_dense.cuh"

namespace {

using sps_tiled::kTile;

// ---- K7: named X rows staged in shared memory, Y in registers -------------
namespace k7 {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 128;                 // output columns a CTA
constexpr int kSlots = 8;                  // slots a thread a unit
constexpr int kUnit = kThreads * kSlots;   // slots a unit
constexpr int kRows = kTile / kWarps;      // output rows a warp (registers)
constexpr int kXStage = kTile * kCols;     // floats of one X stage
constexpr long long kSmemMax = 227 * 1024;

// One stage of the ring: the named X rows of a unit, its entries grouped
// by output row (x offset col * kCols, value bits), where each row's
// entries begin (start[128] = the count), and a warp each the 128-bit
// mask of the X rows its slots name and (count, first row, last row,
// rows in order) of its nonzero slots.
struct Stage {
  float* x;
  int2* e;
  int* start;       // [kTile + 4]
  unsigned* bits;   // [kWarps][4]
  int* info;        // [4][kWarps]
};

__host__ __device__ constexpr long long stage_bytes(int ecap) {
  return ((long long)kXStage * 4 + (long long)ecap * 8 + (kTile + 4) * 4 +
          kWarps * 16 + kWarps * 16 + 15) / 16 * 16;
}
// Scratch of the row grouping, shared by the stages: a warp's count (and
// then offset) of each row, and the warps' sums of the scan.
constexpr long long kScratchBytes = (kWarps * kTile + kWarps) * 4;

__device__ __forceinline__ Stage stage_at(unsigned char* smem, int s,
                                          int ecap) {
  unsigned char* p = smem + kScratchBytes + s * stage_bytes(ecap);
  Stage st;
  st.x = reinterpret_cast<float*>(p);
  st.e = reinterpret_cast<int2*>(p + kXStage * 4);
  st.start = reinterpret_cast<int*>(p + kXStage * 4 + (long long)ecap * 8);
  st.bits = reinterpret_cast<unsigned*>(st.start + kTile + 4);
  st.info = reinterpret_cast<int*>(st.bits + kWarps * 4);
  return st;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0));
}

// A unit: slots [k*kUnit, ...) of live slot t (tile column tc) of block
// row b; b = nbr ends the CTA's sequence.
struct Unit {
  int b, t, k, tc;
};

// The layout and the CTA's walk: block rows blockIdx.x, + gridDim.x, ...;
// their live slots in slot order; a slot's units in order.
struct Layout {
  const int* tcols;
  const int* rows;
  const int* cols;
  const float* vals;
  int nbr, rt, cap, nbc, nk;   // nk: units a tile
  // The first live slot >= t of block row b (rt: none) and its column.
  __device__ int next_live(int b, int t, int* tc) const {
    for (; t < rt; ++t) {
      *tc = tcols[(long long)b * rt + t];
      if (*tc < nbc) break;
    }
    return t;
  }
  // The first unit at block row >= b of the walk; empty(b') for each
  // block row b' without a live slot that it passes.
  template <typename Empty>
  __device__ Unit from(int b, Empty empty) const {
    for (; b < nbr; b += gridDim.x) {
      int tc = 0;
      const int t = nk > 0 ? next_live(b, 0, &tc) : rt;
      if (t < rt) return {b, t, 0, tc};
      empty(b);
    }
    return {nbr, 0, 0, 0};
  }
  template <typename Empty>
  __device__ Unit next(Unit u, Empty empty) const {
    if (u.k + 1 < nk) return {u.b, u.t, u.k + 1, u.tc};
    int tc = 0;
    const int t = next_live(u.b, u.t + 1, &tc);
    if (t < rt) return {u.b, t, 0, tc};
    return from(u.b + gridDim.x, empty);
  }
};

// The slots of a unit this thread holds: warp w takes slots [w*256,
// w*256 + 256) of the unit, lane l every 32nd from l, so that the warps in
// order and the slots of each in order are the entry order.
struct Slots {
  float v[kSlots];
  int r[kSlots], c[kSlots];
};

__device__ __forceinline__ void load_slots(const Layout& L, Unit u, Slots& S,
                                           int warp, int lane) {
  const long long base = ((long long)u.b * L.rt + u.t) * L.cap;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int e = u.k * kUnit + warp * (kSlots * 32) + j * 32 + lane;
    const bool in = u.b < L.nbr && e < L.cap;
    S.v[j] = in ? __ldg(L.vals + base + e) : 0.f;
    S.r[j] = in ? __ldg(L.rows + base + e) : 0;
    S.c[j] = in ? __ldg(L.cols + base + e) : 0;
  }
}

// Group the unit's nonzero slots by output row into st (stable: each
// row's entries in entry order), record the X rows they name, and start
// the copy of those rows of tile column tc (columns n0 ... n0 + 127 of
// each). When the nonzero slots already come in row order (a layout built
// from a row-sorted matrix), the grouping is their compaction: one
// __syncthreads(). Otherwise a stable ranking by row: four.
template <bool kVec>
__device__ __forceinline__ void stage_unit(const Stage& st, int* cw,
                                           const Slots& S, int tc,
                                           const float* __restrict__ X,
                                           long long K, int N, int n0,
                                           int warp, int lane) {
  const unsigned lt = (1u << lane) - 1u;
  // The row of the nonzero slot before each lane's, in entry order (carry:
  // the last one of the previous j, or of the previous warps), -1 if none.
  const auto prev_row = [&](unsigned bal, int row, int carry) {
    const unsigned lower = bal & lt;
    const int r = __shfl_sync(0xffffffffu, row,
                              lower ? 31 - __clz(lower) : 0);
    return lower ? r : carry;
  };
  int cnt = 0, first = -1, last = -1;
  bool ordered = true;
  unsigned m[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const bool live = S.v[j] != 0.f;
    const int row = S.r[j] & (kTile - 1);
    const int c = S.c[j] & (kTile - 1);
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    const int pr = prev_row(bal, row, last);   // every lane: a shuffle
    ordered = ordered && (!live || pr <= row);
    if (bal) {
      if (first < 0) first = __shfl_sync(0xffffffffu, row, __ffs(bal) - 1);
      last = __shfl_sync(0xffffffffu, row, 31 - __clz(bal));
    }
    cnt += __popc(bal);
    const unsigned bit = live ? 1u << (c & 31) : 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) m[q] |= (c >> 5) == q ? bit : 0u;
  }
  ordered = __all_sync(0xffffffffu, ordered);
#pragma unroll
  for (int q = 0; q < 4; ++q) m[q] = __reduce_or_sync(0xffffffffu, m[q]);
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) st.bits[warp * 4 + q] = m[q];
    st.info[warp] = cnt;
    st.info[kWarps + warp] = first;
    st.info[2 * kWarps + warp] = last;
    st.info[3 * kWarps + warp] = ordered;
  }
  __syncthreads();
  // Every warp reads the summaries, lane l that of warp l, and reduces
  // them: its entries' base, the entry count, the last row of the warps
  // before it (carry), whether the unit is in row order, and the named
  // rows among its copy rows (word).
  const bool has = lane < kWarps;
  const int c = has ? st.info[lane] : 0;
  const unsigned word = __reduce_or_sync(
      0xffffffffu, has ? st.bits[lane * 4 + (warp * kRows) / 32] : 0u);
  const int total = (int)__reduce_add_sync(0xffffffffu, (unsigned)c);
  // Inclusive scans over the warps: counts, and (warp << 8 | last row) of
  // the last warp with entries.
  int incl = c, tag = c ? (lane << 8 | st.info[2 * kWarps + lane]) : -1;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int ci = __shfl_up_sync(0xffffffffu, incl, d);
    const int ct = __shfl_up_sync(0xffffffffu, tag, d);
    if (lane >= d) {
      incl += ci;
      tag = ct > tag ? ct : tag;
    }
  }
  const int before = __shfl_up_sync(0xffffffffu, tag, 1);   // warps < lane
  const int run = lane > 0 ? before : -1;
  ordered = __all_sync(
      0xffffffffu, !has || (st.info[3 * kWarps + lane] &&
                           (c == 0 || run < 0 ||
                            (run & 0xff) <= st.info[kWarps + lane])));
  const int base = __shfl_sync(0xffffffffu, incl - c, warp);
  int carry = __shfl_sync(0xffffffffu, run, warp);
  carry = carry < 0 ? -1 : carry & 0xff;
  if (ordered) {
    // Entry e starts the rows after the previous entry's, up to its own;
    // the last entry also the rows after it.
    int e0 = base;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const bool live = S.v[j] != 0.f;
      const int row = S.r[j] & (kTile - 1);
      const unsigned bal = __ballot_sync(0xffffffffu, live);
      const int pr = prev_row(bal, row, carry);
      if (live) {
        const int e = e0 + __popc(bal & lt);
        st.e[e] = make_int2((S.c[j] & (kTile - 1)) * kCols,
                            __float_as_int(S.v[j]));
        for (int r = pr + 1; r <= row; ++r) st.start[r] = e;
        if (e == total - 1)
          for (int r = row + 1; r <= kTile; ++r) st.start[r] = total;
      }
      if (bal) carry = __shfl_sync(0xffffffffu, row, 31 - __clz(bal));
      e0 += __popc(bal);
    }
    if (total == 0 && (int)threadIdx.x <= kTile) st.start[threadIdx.x] = 0;
  } else {
    int* mine = cw + warp * kTile;   // this warp's count of each row
    __syncwarp();   // every lane has read the last unit's offsets
#pragma unroll
    for (int q = 0; q < kTile / 32; ++q) mine[lane + 32 * q] = 0;
    __syncwarp();
    int pos[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const bool live = S.v[j] != 0.f;
      const int row = S.r[j] & (kTile - 1);
      // The live lanes of this lane's row (a dead lane is alone): seven
      // ballots over the row's bits.
      unsigned peers = __ballot_sync(0xffffffffu, live);
#pragma unroll
      for (int bit = 0; bit < 7; ++bit) {
        const bool on = (row >> bit) & 1;
        const unsigned bal = __ballot_sync(0xffffffffu, on);
        peers &= on ? bal : ~bal;
      }
      if (!live) peers = 1u << lane;
      const int rb = live ? mine[row] : 0;
      __syncwarp();
      if (live && (peers >> lane) == 1u) mine[row] = rb + __popc(peers);
      __syncwarp();
      pos[j] = rb + __popc(peers & lt);
    }
    __syncthreads();
    // Exclusive scan of the counts in (row, warp) order: thread i holds
    // row i / 4 of warps 4 (i % 4) ... + 3.
    int* wsum = cw + kWarps * kTile;
    const int i = threadIdx.x;
    const int srow = i / (kWarps / 4), sw = 4 * (i % (kWarps / 4));
    int c4[4], local = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      c4[q] = cw[(sw + q) * kTile + srow];
      local += c4[q];
    }
    int incl = local;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int up = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    int off = incl - local;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) off += w < warp ? wsum[w] : 0;
    if (sw == 0) st.start[srow] = off;
    if (i == kThreads - 1) st.start[kTile] = off + local;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      cw[(sw + q) * kTile + srow] = off;
      off += c4[q];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (S.v[j] != 0.f)
        st.e[mine[S.r[j] & (kTile - 1)] + pos[j]] = make_int2(
            (S.c[j] & (kTile - 1)) * kCols, __float_as_int(S.v[j]));
    }
  }
  // Warp w copies rows w*8 ... w*8 + 7, lane l columns n0 + 4l ... + 3.
  const long long x0 = (long long)tc * kTile;
  const int col = n0 + lane * 4;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = warp * kRows + r;
    if (!((word >> (row & 31)) & 1u)) continue;
    float* dst = st.x + row * kCols + lane * 4;
    const bool in = x0 + row < K;
    const float* src = X + (x0 + row) * N + col;
    if constexpr (kVec) {
      const bool ok = in && col < N;
      sps_dense::cp_async16(dst, ok ? src : X, ok);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool ok = in && col + q < N;
        cp_async4(dst + q, ok ? src + q : X, ok);
      }
    }
  }
}

__device__ __forceinline__ void fma4(float (&a)[4], float v, const float4& x) {
  a[0] = fmaf(v, x.x, a[0]);
  a[1] = fmaf(v, x.y, a[1]);
  a[2] = fmaf(v, x.z, a[2]);
  a[3] = fmaf(v, x.w, a[3]);
}

// This warp's rows of a staged unit, each row's entries in entry order,
// four X rows in flight at a time.
__device__ __forceinline__ void compute_unit(const Stage& st,
                                             float (&acc)[kRows][4],
                                             int warp, int lane) {
  const float* xs = st.x + lane * 4;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = r * kWarps + warp;
    const int end = st.start[row + 1];
    int e = st.start[row];
    for (; e + 4 <= end; e += 4) {
      int2 ent[4];
      float4 x[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) ent[q] = st.e[e + q];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        x[q] = *reinterpret_cast<const float4*>(xs + ent[q].x);
#pragma unroll
      for (int q = 0; q < 4; ++q) fma4(acc[r], __int_as_float(ent[q].y), x[q]);
    }
    for (; e < end; ++e) {
      const int2 ent = st.e[e];
      fma4(acc[r], __int_as_float(ent.y),
           *reinterpret_cast<const float4*>(xs + ent.x));
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void store_rows(float (&acc)[kRows][4], int b,
                                           float* __restrict__ Y,
                                           long long M, int N, int n0,
                                           int warp, int lane) {
  const int col = n0 + lane * 4;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long row = (long long)b * kTile + r * kWarps + warp;
    if (row < M) {
      float* y = Y + row * N + col;
      if constexpr (kVec) {
        if (col < N)
          *reinterpret_cast<float4*>(y) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (col + q < N) y[q] = acc[r][q];
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
  }
}

// Persistent CTAs over block rows blockIdx.x, + gridDim.x, ...: a ring of
// NS stages walks the units of all of them, so that the next block row's
// rows are in flight while this one finishes; a block row's Y rows are
// stored from registers after its last unit.
template <bool kVec, int NS>
__global__ void __launch_bounds__(kThreads, 1)
    onehot_kernel(Layout L, int ecap, const float* __restrict__ X,
                  long long K, int N, float* __restrict__ Y, long long M) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* cw = reinterpret_cast<int*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.y * kCols;

  float acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
  // Block rows without a live slot: zeros.
  const auto empty = [&](int b) {
    float zero[kRows][4] = {};
    store_rows<kVec>(zero, b, Y, M, N, n0, warp, lane);
  };

  Unit unit[NS];
  Slots S;
  Unit nxt = L.from(blockIdx.x, empty);
  load_slots(L, nxt, S, warp, lane);
  const auto stage_next = [&](int s) {
    unit[s] = nxt;
    if (nxt.b < L.nbr) {
      stage_unit<kVec>(stage_at(smem, s, ecap), cw, S, nxt.tc, X, K, N, n0,
                       warp, lane);
      nxt = L.next(nxt, empty);
      load_slots(L, nxt, S, warp, lane);
    }
    sps_dense::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) stage_next(s);
  for (int it = 0;; ++it) {
    const int s = it % NS;
    if (unit[s].b >= L.nbr) break;
    stage_next((it + NS - 1) % NS);   // computed at it - 1: free
    sps_dense::cp_async_wait<NS - 1>();
    __syncthreads();   // unit it's rows and entries are in place for all
    compute_unit(stage_at(smem, s, ecap), acc, warp, lane);
    if (unit[(s + 1) % NS].b != unit[s].b)   // its block row's last unit
      store_rows<kVec>(acc, unit[s].b, Y, M, N, n0, warp, lane);
    __syncthreads();   // stage s is free for the unit NS - 1 ahead
  }
}

template <bool kVec, int NS>
cudaError_t launch_ns(const Layout& L, int ecap, int nchunks,
                      const float* X, long long K, int N, float* Y,
                      long long M, cudaStream_t stream) {
  const long long smem = kScratchBytes + NS * stage_bytes(ecap);
  auto kernel = onehot_kernel<kVec, NS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, (size_t)smem);
  if (err != cudaSuccess) return err;
  // One CTA a block row up to the card's resident CTAs (over the column
  // chunks); past that each CTA walks several block rows.
  long long ctas = (long long)sms * (per_sm > 0 ? per_sm : 1);
  ctas = (ctas + nchunks - 1) / nchunks;
  const int grid = (int)(L.nbr < ctas ? L.nbr : ctas);
  kernel<<<dim3((unsigned)grid, (unsigned)nchunks), kThreads, (size_t)smem,
           stream>>>(L, ecap, X, K, N, Y, M);
  return cudaGetLastError();
}

// ---- tiles of at most kSmall entries: a warp a block row ---------------
// Such tiles hold too few entries for a staged X row to be read more than
// about twice, and the staged kernel's fixed cost a unit (its barriers,
// the ring) would set the pace. So one warp owns a block row and 128
// columns and takes its slots (all live tiles, in slot order) kSmall at a
// time, a piece: it groups the piece's nonzero slots by output row (the
// stable ranking of stage_unit, within the warp), then walks them in that
// order, reading each named X row from device memory (16-byte vectors,
// four in flight) into one row's registers. The first piece stores every
// row of the block row (zeros where it has no entry); a later piece loads
// the rows it adds to from Y and stores them back. Same summation order:
// bit for bit.
constexpr int kSmall = 256;                // entries a tile; slots a piece
constexpr int kSmallSlots = kSmall / 32;   // a lane
constexpr int kSmallWarps = 4;             // block rows a CTA

template <bool kVec>
__global__ void __launch_bounds__(kSmallWarps * 32)
    onehot_small_kernel(Layout L, const float* __restrict__ X, long long K,
                        int N, float* __restrict__ Y, long long M) {
  __shared__ int cnt_s[kSmallWarps][kTile];
  __shared__ int2 ent_s[kSmallWarps][kSmall];   // (col | row << 7, value)
  __shared__ int tc_s[kSmallWarps][kSmall];     // the entry's tile column
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kSmallWarps + warp;
  if (b >= L.nbr) return;   // whole warps only: no barrier below
  const int n0 = blockIdx.y * kCols;
  const int col = n0 + lane * 4;
  int* cnt = cnt_s[warp];
  int2* ent = ent_s[warp];
  int* etc = tc_s[warp];
  const int slots = L.rt * L.cap;   // under 2^31: see launch
  const unsigned lt = (1u << lane) - 1u;
  float acc[4];
  const auto store_row = [&](int r) {
    const long long yr = (long long)b * kTile + r;
    if (yr >= M) return;
    float* y = Y + yr * N + col;
    if constexpr (kVec) {
      if (col < N)
        *reinterpret_cast<float4*>(y) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (col + q < N) y[q] = acc[q];
    }
  };
  // A later piece's row: its sum so far, from Y (stored by this lane).
  const auto load_row = [&](int r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] = 0.f;
    const long long yr = (long long)b * kTile + r;
    if (yr >= M) return;
    const float* y = Y + yr * N + col;
    if constexpr (kVec) {
      if (col < N) {
        const float4 o = *reinterpret_cast<const float4*>(y);
        acc[0] = o.x, acc[1] = o.y, acc[2] = o.z, acc[3] = o.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (col + q < N) acc[q] = y[q];
    }
  };
  const auto x_of = [&](int e) {
    const int2 en = ent[e];
    const long long xr = (long long)etc[e] * kTile + (en.x & (kTile - 1));
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (xr < K) {
      const float* src = X + xr * N + col;
      if constexpr (kVec) {
        if (col < N) x = __ldg(reinterpret_cast<const float4*>(src));
      } else {
        if (col < N) x.x = __ldg(src);
        if (col + 1 < N) x.y = __ldg(src + 1);
        if (col + 2 < N) x.z = __ldg(src + 2);
        if (col + 3 < N) x.w = __ldg(src + 3);
      }
    }
    return x;
  };
  for (int p0 = 0; p0 == 0 || p0 < slots; p0 += kSmall) {
    const bool first = p0 == 0;
#pragma unroll
    for (int q = 0; q < kTile / 32; ++q) cnt[lane + 32 * q] = 0;
    __syncwarp();
    // Slot p0 + j*32 + lane of the block row (tile t, entry e) in order.
    float v[kSmallSlots];
    int row[kSmallSlots], cc[kSmallSlots], tcol[kSmallSlots];
    int pos[kSmallSlots];
#pragma unroll
    for (int j = 0; j < kSmallSlots; ++j) {
      const int idx = p0 + j * 32 + lane;
      const int t = idx / (L.cap > 0 ? L.cap : 1);
      const long long g = (long long)b * slots + idx;
      tcol[j] = idx < slots ? __ldg(L.tcols + (long long)b * L.rt + t)
                            : L.nbc;
      const bool in = tcol[j] < L.nbc;
      v[j] = in ? __ldg(L.vals + g) : 0.f;
      row[j] = in ? __ldg(L.rows + g) & (kTile - 1) : 0;
      cc[j] = in ? __ldg(L.cols + g) & (kTile - 1) : 0;
    }
#pragma unroll
    for (int j = 0; j < kSmallSlots; ++j) {
      const bool live = v[j] != 0.f;
      unsigned peers = __ballot_sync(0xffffffffu, live);
#pragma unroll
      for (int bit = 0; bit < 7; ++bit) {
        const bool on = (row[j] >> bit) & 1;
        const unsigned bal = __ballot_sync(0xffffffffu, on);
        peers &= on ? bal : ~bal;
      }
      if (!live) peers = 1u << lane;
      const int base = live ? cnt[row[j]] : 0;
      __syncwarp();
      if (live && (peers >> lane) == 1u) cnt[row[j]] = base + __popc(peers);
      __syncwarp();
      pos[j] = base + __popc(peers & lt);
    }
    // Row starts: an exclusive scan of the counts, rows 4 lane ... + 3.
    int c4[4], local = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      c4[q] = cnt[lane * 4 + q];
      local += c4[q];
    }
    int incl = local;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int up = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += up;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    __syncwarp();
    int off = incl - local;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      cnt[lane * 4 + q] = off;
      off += c4[q];
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kSmallSlots; ++j)
      if (v[j] != 0.f) {
        const int e = cnt[row[j]] + pos[j];
        ent[e] = make_int2(cc[j] | (row[j] << 7), __float_as_int(v[j]));
        etc[e] = tcol[j];
      }
    __syncwarp();
    // Walk the entries by row; cur: the row in acc (-1: none yet).
    int cur = -1;
    const auto open = [&](int r) {   // store cur, then start row r
      if (cur >= 0) store_row(cur);
      if (first) {   // rows between without an entry: zeros
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] = 0.f;
        for (int z = cur + 1; z < r; ++z) store_row(z);
      } else {
        load_row(r);
      }
      cur = r;
    };
    for (int e0 = 0; e0 < total; e0 += 4) {
      float4 x[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        x[q] = e0 + q < total ? x_of(e0 + q)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (e0 + q >= total) break;
        const int2 en = ent[e0 + q];
        if ((en.x >> 7) != cur) open(en.x >> 7);
        fma4(acc, __int_as_float(en.y), x[q]);
      }
    }
    if (first) {
      open(kTile);   // stores cur and zeros up to the last row
    } else if (cur >= 0) {
      store_row(cur);
    }
    __syncwarp();   // every lane has read this piece's entries
  }
}

// Tiles of at most kSmall entries: a warp a block row. Otherwise the
// staged kernel, three stages where they fit (small tiles), else two.
template <bool kVec>
cudaError_t launch(const Layout& L, int nchunks, const float* X, long long K,
                   int N, float* Y, long long M, cudaStream_t stream) {
  if (L.cap <= kSmall && (long long)L.rt * L.cap < (1LL << 31) - kSmall) {
    const long long ctas = (L.nbr + kSmallWarps - 1) / kSmallWarps;
    onehot_small_kernel<kVec><<<dim3((unsigned)ctas, (unsigned)nchunks),
                                kSmallWarps * 32, 0, stream>>>(L, X, K, N,
                                                               Y, M);
    return cudaGetLastError();
  }
  const int ecap = L.cap < kUnit ? L.cap : kUnit;
  if (kScratchBytes + 3 * stage_bytes(ecap) <= kSmemMax)
    return launch_ns<kVec, 3>(L, ecap, nchunks, X, K, N, Y, M, stream);
  return launch_ns<kVec, 2>(L, ecap, nchunks, X, K, N, Y, M, stream);
}

}  // namespace k7

}  // namespace

extern "C" {

// K6: Y (M x N, float32, row-major) = A X for the dense-block layout
// tcols (nbr, rt) int32 and blocks (nbr, rt, 128, 128); X (K x N,
// row-major) in the block type. dtype: 0 = float32, 1 = bfloat16.
int sps_tiled_dense(int dtype, const void* tcols, const void* blocks,
                    int nbr, int rt, int nbc, const void* X, long long K,
                    int N, void* Y, long long M, void* stream) {
  const sps_tiled::DenseCols cols{static_cast<const int*>(tcols), rt, nbc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return sps_dense::launch_dense_ring<float>(blocks, cols, nbr, rt, X, K,
                                               N, Y, M, s);
  if (dtype == 1)
    return sps_dense::launch_dense_ring<__nv_bfloat16>(blocks, cols, nbr, rt,
                                                       X, K, N, Y, M, s);
  return (int)cudaErrorInvalidValue;
}

// K7: Y (M x N, float32) = A X for the row-grouped entry layout tcols
// (nbr, rt) int32, rows/cols (nbr, rt, cap) int32 in-tile offsets and vals
// (nbr, rt, cap) float32; X (K x N, float32, row-major).
int sps_tiled_onehot(const void* tcols, const void* rows, const void* cols,
                     const void* vals, int nbr, int rt, int cap, int nbc,
                     const void* X, long long K, int N, void* Y, long long M,
                     void* stream) {
  if (nbr <= 0 || N <= 0 || M <= 0) return (int)cudaSuccess;
  const long long nchunks = (N + k7::kCols - 1) / k7::kCols;
  if (nchunks > 65535 || cap < 0 || rt < 0)
    return (int)cudaErrorInvalidValue;
  const k7::Layout L{static_cast<const int*>(tcols),
                     static_cast<const int*>(rows),
                     static_cast<const int*>(cols),
                     static_cast<const float*>(vals), nbr, rt, cap, nbc,
                     (cap + k7::kUnit - 1) / k7::kUnit};
  const float* x = static_cast<const float*>(X);
  float* y = static_cast<float*>(Y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = N % 4 == 0 &&
                   reinterpret_cast<std::uintptr_t>(X) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(Y) % 16 == 0;
  return (int)(vec ? k7::launch<true>(L, (int)nchunks, x, K, N, y, M, s)
                   : k7::launch<false>(L, (int)nchunks, x, K, N, y, M, s));
}

}  // extern "C"
