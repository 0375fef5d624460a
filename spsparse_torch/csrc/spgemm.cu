// Tiled SpGEMM for Hopper (sm_90a), behind a plain C interface.
//
// K8  sps_spgemm_window        replaces spsparse_tpu/ops/spgemm_window.py::
//                              _window_gemm_kernel
//     C = A B^T in band layout: band slot (i, b) is output tile
//     (i, j = i + b - W), the sum over its planned pairs p < cnt[i*NB + b]
//     of A[i, pt[q]] . B[j, pu[q]]^T with q = i*S + prefix[b] + p; operands
//     are row-grouped dense blocks (nbr, rt, 128, 128), B may be A.
// K9  sps_spgemm_pairs         replaces spsparse_tpu/ops/spgemm_tiled.py::
//                              _pairs_kernel
//     out[t] = sum over the pairs p of output tile t (pstart[t] ..
//     pstart[t+1], plan order) of A[pa[p]] . B[pb[p]] (B[pb[p]]^T when
//     transposed); flat blocks (T, 128, 128).
// K13 sps_spgemm_pairs_stream  replaces spsparse_tpu/ops/spgemm_tiled.py::
//                              _pairs_stream_kernel
//     K9's function, each output tile the sum of its pairs in plan order.
//
// All three write float32 128 x 128 tiles from float32 or bfloat16
// operands (both operands of one type).
//
// What bounds them. A pair costs 2*128^3 operations against at most two
// 64 KB (float32) operand tiles, and the operand tiles are shared between
// pairs, so dense float32 tiles are bound by the card's float32 rate: the
// JAX kernels ask for Precision.HIGHEST, true float32, which TF32 is not.
// bfloat16 on the tensor-core rate is bound by bytes: the distinct operand
// tiles once and the output tiles (K8: the whole band) once. The tiles of
// a sparse product are mostly zero (bench config 4: 76 entries in 16,384),
// and most of a warp's share of a tile product is zero on one side.
//
// The design: one cp.async ring for all three kernels (pairs_ring_kernel),
// built from K6's primitives (tiled_dense.cuh). A CTA of 256 threads keeps
// one 128 x 128 float32 output tile in registers and walks a sequence of
// output tiles; the ring's producer walks their (pair, k0) chunks as one
// stream, 3 stages of 16-byte cp.async copies, so the next pair's and the
// next tile's first chunks load while the current ones are multiplied; at
// a tile's last chunk the CTA stores and zeroes its accumulator with the
// next chunks in flight. A tile with no pairs is stored as zeros. No
// atomics and a fixed order, so results repeat from run to run. The three
// kernels differ in where a CTA's tiles and a pair's operand tiles come
// from (the Pairs policy and kPersistent):
//
// * K9: one output tile a CTA (grid n_out), balanced by the hardware's
//   scheduler, as the TPU kernel's grid had one step a tile.
// * K13: persistent CTAs, as many as are resident (two an SM), CTA g taking
//   the output tiles whose pairs begin in the g-th of gridDim.x equal parts
//   of the pair stream (two binary searches over pstart on the device; the
//   last CTA also takes trailing tiles with no pairs), as the TPU kernel
//   streamed its pairs across tile boundaries.
// * K8: K9's grid over the band slots, one slot a CTA (on an H100 at bench
//   config 4, where a third of the slots hold no pair, 1.2x faster in
//   float32 and 1.3x in bfloat16 than K13's persistent CTAs balanced by
//   pair count; tests_gpu/ring_variants.py). The slot pair prefix
//   slot_pstart (nslots + 1, built on the host
//   from the plan's cnt) gives each slot's pairs; slots with no live pair
//   (cnt 0, i past A's rows or j outside B's) count 0 there and are stored
//   as zeros: the band is returned whole and every nonzero value of it is
//   extracted. Pair p of slot t = (i, b)
//   reads A[i*rt_a + pt[q]] and B[j*rt_b + pu[q]], q = i*S + prefix[b] +
//   p - slot_pstart[t]. The TPU copied a window of G + 2W operand block
//   rows into VMEM for each super-group (megabytes at bench config 4); here
//   neighbouring slots share the operand rows through the 50 MB L2.
//
// The chunk step. bfloat16 stays bfloat16 in shared memory (64-deep chunks,
// 32 KB a stage, XOR-swizzled) and runs mma.sync m16n8k16, warp w owning
// the 64 x 32 output block at rows (w % 2) * 64, columns (w / 2) * 32: A by
// ldmatrix, B of A B by ldmatrix.trans (K6's X), B of A B^T by ldmatrix
// (its rows are the n x k operand as they are). float32 runs true float32
// SIMT FMAs in 32-deep chunks, warp w owning the 32 x 64 output block at
// rows (w % 4) * 32, columns (w / 4) * 64, an 8 x 8 register tile a lane;
// each output element takes one fmaf a k, pairs in plan order, k ascending,
// so float32 K8, K9 and K13 equal each other bit for bit (and the first,
// synchronously staged SIMT bodies, since deleted).
//
// Exact skipping of empty warp blocks. Each warp ORs the magnitude bits of
// its own A rows and its own B slice (B^T rows for A B^T, the k x n slice
// for A B) and votes: float32 before its step on a staged chunk, read from
// shared memory; bfloat16 before the mma's of each 16-deep step, from the
// fragments ldmatrix loaded (a separate read of the slices would double
// the step's shared-memory traffic). It skips the FMAs or mma's when one
// side is all zero and the other all finite (checked only then): every
// skipped term is then an exact +-0, and adding +-0 leaves a float32 sum
// unchanged, bit for bit, except for the sign of a zero sum, which only an
// underflowed product can make negative. NaN and Inf propagate as in the
// plain version. At bench config 4 about 89% of the float32 (warp block,
// chunk) units are skipped.

#include "tiled_common.cuh"
#include "tiled_dense.cuh"

namespace {

using sps_tiled::kTile;

constexpr long long kTileElems = (long long)kTile * kTile;

// --- The ring ----------------------------------------------------------------
// A stage holds the k-chunk [k0, k0 + kBK) of one pair: A's 128 x kBK chunk
// laid out as K6 stages a block (Ring<T>::a_off); for A B, B's kBK x 128
// rows laid out as K6 stages X (x_off), and for A B^T, B's 128 x kBK chunk
// laid out like A's.
using sps_dense::Ring;

template <typename T, bool kTransB>
__host__ __device__ constexpr int pair_stage_elems() {
  return kTransB ? 2 * Ring<T>::kAElems : Ring<T>::kStageElems;
}

// The 128 x kBK chunk at k0 of a 128 x 128 tile, rows at Ring<T>::a_off.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ tile,
                                          int k0, int tid) {
  using R = Ring<T>;
  constexpr int kChunks = R::kBK / R::kVec;   // 16-byte chunks a row
#pragma unroll
  for (int j = 0; j < sps_dense::kCopies; ++j) {
    const int q = tid + j * sps_dense::kThreads;
    const int row = q / kChunks, c = q % kChunks;
    sps_dense::cp_async16(dst + R::a_off(row, c),
                          tile + row * kTile + k0 + c * R::kVec, true);
  }
}

template <typename T, bool kTransB>
__device__ __forceinline__ void load_pair_chunk(T* st, const T* __restrict__ a,
                                                const T* __restrict__ b,
                                                int k0, int tid) {
  if constexpr (kTransB) {
    load_rows(st, a, k0, tid);
    load_rows(st + Ring<T>::kAElems, b, k0, tid);
  } else {
    sps_dense::load_stage<T, true>(st, a, k0, 0, b, kTile, kTile, 0, tid);
  }
}

// --- The skip test -----------------------------------------------------------
// float32: whether the calling warp may skip its step on stage st. The CTA
// reads the stage once: warps 0-3 the A rows of output row group w (32 x
// 32), warps 4-7 one half of the B slice of column group (w - 4) / 2 (A B^T:
// 32 of its 64 B rows; A B: 16 of its 32 k rows x 64 columns), 8 chunks of
// 16 bytes a lane, 8 lanes on 128 contiguous bytes. Each warp posts whether
// its part holds a nonzero and whether an Inf or a NaN (the magnitude plus
// 0x00800000 carries into bit 31 exactly then) in flags; after a barrier,
// warp w reads those of its A rows (w % 4) and its B slice (w / 4). All
// threads of the CTA must call it.
template <bool kTransB>
__device__ __forceinline__ bool warp_block_empty(const float* st,
                                                 unsigned* flags, int tid) {
  using R = Ring<float>;
  constexpr unsigned kMag = 0x7fffffffu;   // magnitude bits
  const int warp = tid / 32, lane = tid % 32;
  const float* p;
  int step;
  if (warp < 4) {
    p = st + R::a_off(warp * 32 + lane / 8, lane % 8);
    step = 4 * R::kAStride;
  } else if (kTransB) {
    p = st + R::kAElems + R::a_off((warp - 4) * 32 + lane / 8, lane % 8);
    step = 4 * R::kAStride;
  } else {
    const int h = warp - 4;
    p = st + R::kAElems +
        R::x_off((h % 2) * 16 + lane / 16, (h / 2) * 16 + lane % 16);
    step = 2 * sps_dense::kBN;
  }
  unsigned nz = 0, nf = 0;
#pragma unroll 4
  for (int j = 0; j < 8; ++j) {
    const uint4 v = *reinterpret_cast<const uint4*>(p + j * step);
    nz |= v.x | v.y | v.z | v.w;
    nf |= ((v.x & kMag) + 0x00800000u) | ((v.y & kMag) + 0x00800000u) |
          ((v.z & kMag) + 0x00800000u) | ((v.w & kMag) + 0x00800000u);
  }
  const unsigned f = __reduce_or_sync(
      0xffffffffu, ((nz & kMag) != 0 ? 1u : 0u) | ((nf >> 31) << 1));
  if (lane == 0) flags[warp] = f;
  __syncthreads();
  const unsigned fa = flags[warp % 4];
  const unsigned fb = flags[4 + 2 * (warp / 4)] | flags[5 + 2 * (warp / 4)];
  return (!(fa & 1u) && !(fb & 2u)) || (!(fb & 1u) && !(fa & 2u));
}

// bfloat16: whether a warp may skip the 16 mma's of one 16-deep step, read
// from the fragments that ldmatrix brought from the stage (its 64 A rows and
// 32 B columns over the step's 16 k): the same rule, on registers, so that
// the test adds no shared-memory traffic to the step's.
__device__ __forceinline__ bool frags_empty(const unsigned (&a)[4][4],
                                            const unsigned (&b)[4][2]) {
  constexpr unsigned kMag = 0x7fff7fffu;   // magnitude bits of two values
  auto nonfinite = [](unsigned w) {
    return (w & 0x7f80u) == 0x7f80u || (w & 0x7f800000u) == 0x7f800000u;
  };
  unsigned az = 0, bz = 0;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
    az |= a[mt][0] | a[mt][1] | a[mt][2] | a[mt][3];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) bz |= b[nt][0] | b[nt][1];
  const unsigned f = __reduce_or_sync(
      0xffffffffu,
      ((az & kMag) != 0 ? 1u : 0u) | ((bz & kMag) != 0 ? 2u : 0u));
  const bool a_nz = f & 1u, b_nz = f & 2u;
  if (a_nz && b_nz) return false;
  if (!a_nz && !b_nz) return true;
  bool bad = false;
  if (a_nz) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) bad |= nonfinite(a[mt][e]);
  } else {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      bad |= nonfinite(b[nt][0]) | nonfinite(b[nt][1]);
  }
  return !__any_sync(0xffffffffu, bad);
}

// --- The chunk steps ---------------------------------------------------------
// float32 A B^T. Lane (ly, lx) = (lane / 8, lane % 8) of warp w owns rows
// (w % 4) * 32 + ly + 4 i and columns (w / 4) * 64 + lx + 8 j. Both chunks
// are read along their rows (k), 36 floats apart: a warp reads 4 distinct A
// rows (float2, two k) and 8 distinct B rows (one k) at a time, each row in
// its own group of 4 banks, so no read conflicts.
__device__ __forceinline__ void compute_stage_nt(const float* st,
                                                 sps_dense::AccF32& acc,
                                                 int tid) {
  using R = Ring<float>;
  const int warp = tid / 32, lane = tid % 32;
  const float* As = st + ((warp % 4) * 32 + lane / 8) * R::kAStride;
  const float* Bs =
      st + R::kAElems + ((warp / 4) * 64 + lane % 8) * R::kAStride;
#pragma unroll 1
  for (int k = 0; k < R::kBK; k += 2) {
    float2 a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = *reinterpret_cast<const float2*>(As + 4 * i * R::kAStride + k);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      float x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = Bs[8 * j * R::kAStride + k + kk];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float ai = kk ? a[i].y : a[i].x;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc.v[i][j] = fmaf(ai, x[j], acc.v[i][j]);
      }
    }
  }
}

__device__ __forceinline__ void store_tile_nt(const sps_dense::AccF32& acc,
                                              float* __restrict__ out,
                                              int tid) {
  const int warp = tid / 32, lane = tid % 32;
  float* o = out + ((warp % 4) * 32 + lane / 8) * kTile + (warp / 4) * 64 +
             lane % 8;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) o[4 * i * kTile + 8 * j] = acc.v[i][j];
}

// float32 A B, in compute_stage_nt's warp blocks (so that the skip test
// sees the same slices): lane (ly, lx) owns rows (w % 4) * 32 + ly + 4 i and
// columns (w / 4) * 64 + 4 lx + (j % 4) + 32 (j / 4); A as above, and each
// staged X row (128 floats) read as two float4 a lane, 128 contiguous bytes
// over the 8 lanes of a row group.
__device__ __forceinline__ void compute_stage_nn(const float* st,
                                                 sps_dense::AccF32& acc,
                                                 int tid) {
  using R = Ring<float>;
  const int warp = tid / 32, lane = tid % 32;
  const float* As = st + ((warp % 4) * 32 + lane / 8) * R::kAStride;
  const float* Xs = st + R::kAElems + (warp / 4) * 64 + (lane % 8) * 4;
#pragma unroll 1
  for (int k = 0; k < R::kBK; k += 2) {
    float2 a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = *reinterpret_cast<const float2*>(As + 4 * i * R::kAStride + k);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const float* xr = Xs + (k + kk) * sps_dense::kBN;
      const float4 lo = *reinterpret_cast<const float4*>(xr);
      const float4 hi = *reinterpret_cast<const float4*>(xr + 32);
      const float x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float ai = kk ? a[i].y : a[i].x;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc.v[i][j] = fmaf(ai, x[j], acc.v[i][j]);
      }
    }
  }
}

__device__ __forceinline__ void store_tile_nn(const sps_dense::AccF32& acc,
                                              float* __restrict__ out,
                                              int tid) {
  const int warp = tid / 32, lane = tid % 32;
  float* o = out + ((warp % 4) * 32 + lane / 8) * kTile + (warp / 4) * 64 +
             (lane % 8) * 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = o + 4 * i * kTile;
    *reinterpret_cast<float4*>(row) =
        make_float4(acc.v[i][0], acc.v[i][1], acc.v[i][2], acc.v[i][3]);
    *reinterpret_cast<float4*>(row + 32) =
        make_float4(acc.v[i][4], acc.v[i][5], acc.v[i][6], acc.v[i][7]);
  }
}

// bfloat16 A B^T on mma.sync m16n8k16: K6's warp layout and A fragments; B's
// rows are the n x k "col" operand as they are, so they take ldmatrix
// without .trans, addressed like A (matrices: n +0 / +8, then k +0 / +8).
__device__ __forceinline__ void compute_stage_nt(const __nv_bfloat16* st,
                                                 sps_dense::AccBF16& acc,
                                                 int tid) {
  using R = Ring<__nv_bfloat16>;
  const __nv_bfloat16* As = st;
  const __nv_bfloat16* Bs = st + R::kAElems;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp % 2) * 64, wn = (warp / 2) * 32;
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lhalf = lane >> 4;
#pragma unroll
  for (int kk = 0; kk < R::kBK; kk += 16) {
    unsigned a[4][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
      sps_dense::ldmatrix_x4(a[mt], As + R::a_off(wm + mt * 16 + lrow,
                                                  kk / 8 + lhalf),
                             false);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      unsigned r[4];
      sps_dense::ldmatrix_x4(
          r, Bs + R::a_off(wn + np * 16 + lrow, kk / 8 + lhalf), false);
      b[2 * np][0] = r[0]; b[2 * np][1] = r[2];
      b[2 * np + 1][0] = r[1]; b[2 * np + 1][1] = r[3];
    }
    if (frags_empty(a, b)) continue;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        sps_dense::mma_bf16(acc.v[mt][nt], a[mt], b[nt][0], b[nt][1]);
  }
}

// bfloat16 A B: K6's step (tiled_dense.cuh, compute_stage), with the skip
// test of each 16-deep step.
__device__ __forceinline__ void compute_stage_nn(const __nv_bfloat16* st,
                                                 sps_dense::AccBF16& acc,
                                                 int tid) {
  using R = Ring<__nv_bfloat16>;
  const __nv_bfloat16* As = st;
  const __nv_bfloat16* Xs = st + R::kAElems;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp % 2) * 64, wn = (warp / 2) * 32;
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lhalf = lane >> 4;
#pragma unroll
  for (int kk = 0; kk < R::kBK; kk += 16) {
    unsigned a[4][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
      sps_dense::ldmatrix_x4(a[mt], As + R::a_off(wm + mt * 16 + lrow,
                                                  kk / 8 + lhalf),
                             false);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      unsigned r[4];
      sps_dense::ldmatrix_x4(
          r, Xs + R::x_off(kk + lrow, (wn + np * 16) / 8 + lhalf), true);
      b[2 * np][0] = r[0]; b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2]; b[2 * np + 1][1] = r[3];
    }
    if (frags_empty(a, b)) continue;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        sps_dense::mma_bf16(acc.v[mt][nt], a[mt], b[nt][0], b[nt][1]);
  }
}

// One stage's step, after the warp's skip test, and the tile store in the
// matching layout.
template <typename T, bool kTransB, typename Acc>
__device__ __forceinline__ void pair_step(const T* st, Acc& acc,
                                          unsigned* flags, int tid) {
  if constexpr (sizeof(T) == 4) {
    if (warp_block_empty<kTransB>(st, flags, tid)) return;
  }
  if constexpr (kTransB) {
    compute_stage_nt(st, acc, tid);
  } else {
    compute_stage_nn(st, acc, tid);
  }
}

template <typename T, bool kTransB, typename Acc>
__device__ __forceinline__ void pair_store(const Acc& acc, float* tile,
                                           int tid) {
  if constexpr (sizeof(T) == 4 && kTransB) {
    store_tile_nt(acc, tile, tid);
  } else if constexpr (sizeof(T) == 4) {
    store_tile_nn(acc, tile, tid);
  } else {
    sps_dense::store_tile(acc, tile, kTile, kTile, 0, 0, tid);
  }
}

// --- Where the pairs come from -----------------------------------------------
// K9, K13: pair p of the flat plan reads A[pa[p]] and B[pb[p]]; pstart
// (n_out + 1) gives each output tile's pairs.
struct FlatPairs {
  const int* pstart;
  const int* pa;
  const int* pb;
  __device__ __forceinline__ void tiles(int, int p, int& ta, int& tb) const {
    ta = pa[p];
    tb = pb[p];
  }
};

// K8: the band's slots t = i * nb + b, slot t's pairs at slot_pstart[t] ..
// slot_pstart[t + 1] of the stream, in p order; t is the CTA's one slot.
struct BandPairs {
  const int* pstart;   // slot_pstart
  const int* pt;
  const int* pu;
  const int* prefix;
  int nb, w, s, rt_a, rt_b;
  __device__ __forceinline__ void tiles(int t, int p, int& ta, int& tb) const {
    const int i = t / nb, band = t - i * nb;
    const long long q = (long long)i * s + prefix[band] + (p - pstart[t]);
    ta = i * rt_a + pt[q];
    tb = (i + band - w) * rt_b + pu[q];
  }
};

// The first tile t in [0, n_out] with pstart[t] >= target.
__device__ __forceinline__ int first_tile(const int* __restrict__ pstart,
                                          int n_out, long long target) {
  int lo = 0, hi = n_out;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (pstart[mid] < target) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// K8, K9, K13. The CTA's output tiles [t0, t1): blockIdx.x alone (K8, K9)
// or a pair-balanced range (kPersistent: K13). The producer's cursor walks
// (pair, k0) over the range in the consumer's order; the consumer stores
// each tile at its last chunk.
template <typename T, bool kTransB, bool kPersistent, typename Pairs>
__global__ void __launch_bounds__(sps_dense::kThreads, 2)
    pairs_ring_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      Pairs pairs, int n_out, float* __restrict__ out) {
  using R = Ring<T>;
  constexpr int kStage = pair_stage_elems<T, kTransB>();
  constexpr int kStages = sps_dense::kStages;
  constexpr int kChunks = kTile / R::kBK;   // chunks a pair
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned flags[8];   // float32 skip test, one word a warp
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const int* __restrict__ pstart = pairs.pstart;
  int t0, t1;
  if constexpr (kPersistent) {
    const long long n_pairs = pstart[n_out];
    const int g = blockIdx.x, ctas = gridDim.x;
    t0 = first_tile(pstart, n_out, n_pairs * g / ctas);
    t1 = g + 1 == ctas ? n_out
                       : first_tile(pstart, n_out, n_pairs * (g + 1) / ctas);
  } else {
    t0 = blockIdx.x;
    t1 = t0 + 1;
  }
  const int p0 = pstart[t0];
  const int total = (pstart[t1] - p0) * kChunks;   // chunks in the ring

  // The producer's cursor; a pair's operand tiles are looked up at its
  // first chunk.
  int p_load = p0, k_load = 0, ta = 0, tb = 0;
  auto issue = [&](int stage) {
    if (k_load == 0) pairs.tiles(t0, p_load, ta, tb);
    load_pair_chunk<T, kTransB>(smem + stage * kStage,
                                a + (long long)ta * kTileElems,
                                b + (long long)tb * kTileElems, k_load, tid);
    k_load += R::kBK;
    if (k_load == kTile) {
      k_load = 0;
      ++p_load;
    }
  };

  typename sps_dense::Acc<T>::type acc;
  acc.zero();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) issue(s);
    sps_dense::cp_async_commit();
  }
  int c = 0;
  for (int t = t0; t < t1; ++t) {
    const int c_end = (pstart[t + 1] - p0) * kChunks;
    for (; c < c_end; ++c) {
      sps_dense::cp_async_wait<kStages - 2>();
      __syncthreads();   // chunk c landed for all; stage (c - 1) % S is free
      const int next = c + kStages - 1;
      if (next < total) issue(next % kStages);
      sps_dense::cp_async_commit();
      const T* st = smem + (c % kStages) * kStage;
      pair_step<T, kTransB>(st, acc, flags, tid);
    }
    pair_store<T, kTransB>(acc, out + (long long)t * kTileElems, tid);
    acc.zero();
  }
}

// The ring over n_out output tiles: one CTA a tile, or (kPersistent) as
// many CTAs as are resident on the card at once (two an SM), at most one a
// tile.
template <typename T, bool kTransB, bool kPersistent, typename Pairs>
int launch_ring(const void* a, const void* b, Pairs pairs, int n_out,
                void* out, cudaStream_t s) {
  auto kernel = pairs_ring_kernel<T, kTransB, kPersistent, Pairs>;
  const int smem =
      sps_dense::kStages * pair_stage_elems<T, kTransB>() * (int)sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  long long grid = n_out;
  if constexpr (kPersistent) {
    int dev = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, sps_dense::kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
    if (resident < grid) grid = resident;
  }
  kernel<<<(unsigned)grid, sps_dense::kThreads, smem, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), pairs, n_out,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

template <bool kPersistent>
int dispatch_pairs(int dtype, int transpose_b, const void* a, const void* b,
                   const void* pa, const void* pb, const void* pstart,
                   int n_out, void* out, void* stream) {
  if (n_out <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FlatPairs pairs{static_cast<const int*>(pstart),
                        static_cast<const int*>(pa),
                        static_cast<const int*>(pb)};
  if (dtype == 0)
    return transpose_b
               ? launch_ring<float, true, kPersistent>(a, b, pairs, n_out,
                                                       out, s)
               : launch_ring<float, false, kPersistent>(a, b, pairs, n_out,
                                                        out, s);
  if (dtype == 1)
    return transpose_b
               ? launch_ring<__nv_bfloat16, true, kPersistent>(a, b, pairs,
                                                               n_out, out, s)
               : launch_ring<__nv_bfloat16, false, kPersistent>(
                     a, b, pairs, n_out, out, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K9: out (n_out, 128, 128) float32 from flat operand blocks a, b (T, 128,
// 128; 16-byte aligned) and the pair plan pa, pb (P,) int32 with pstart
// (n_out + 1,) int32. dtype: 0 = float32, 1 = bfloat16; transpose_b: 1 for
// A B^T. One CTA an output tile.
int sps_spgemm_pairs(int dtype, int transpose_b, const void* a,
                     const void* b, const void* pa, const void* pb,
                     const void* pstart, int n_out, void* out, void* stream) {
  return dispatch_pairs<false>(dtype, transpose_b, a, b, pa, pb, pstart,
                               n_out, out, stream);
}

// K13: K9's function and arguments, by persistent CTAs over pair-balanced
// ranges of output tiles.
int sps_spgemm_pairs_stream(int dtype, int transpose_b, const void* a,
                            const void* b, const void* pa, const void* pb,
                            const void* pstart, int n_out, void* out,
                            void* stream) {
  return dispatch_pairs<true>(dtype, transpose_b, a, b, pa, pb, pstart, n_out,
                              out, stream);
}

// K8: the band out (nslots = nbr_pad * nb, 128, 128) float32 of A B^T from
// row-grouped blocks a (nbr_a, rt_a, 128, 128) and b (nbr_b, rt_b, 128,
// 128) (b may equal a; 16-byte aligned); slot_pstart (nslots + 1,), pt/pu
// (nbr_pad * s,) and prefix (nb,) int32 from the plan; nb = 2w + 1. dtype:
// 0 = float32, 1 = bfloat16.
int sps_spgemm_window(int dtype, const void* a, const void* b,
                      const void* slot_pstart, const void* pt, const void* pu,
                      const void* prefix, int nslots, int nb, int w, int s,
                      int rt_a, int rt_b, void* out, void* stream) {
  if (nslots <= 0) return (int)cudaSuccess;
  if (nb != 2 * w + 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BandPairs pairs{static_cast<const int*>(slot_pstart),
                        static_cast<const int*>(pt),
                        static_cast<const int*>(pu),
                        static_cast<const int*>(prefix),
                        nb, w, s, rt_a, rt_b};
  if (dtype == 0)
    return launch_ring<float, true, false>(a, b, pairs, nslots, out, st);
  if (dtype == 1)
    return launch_ring<__nv_bfloat16, true, false>(a, b, pairs, nslots, out,
                                                   st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
