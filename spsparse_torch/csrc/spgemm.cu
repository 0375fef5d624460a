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
//     K9's function, each output tile the sum of its pairs in plan order,
//     by persistent CTAs that stream the pairs through a cp.async ring.
//
// All three write float32 128 x 128 tiles from float32 or bfloat16
// operands (both operands of one type).
//
// What bounds them. A pair costs 2*128^3 operations against at most two
// 64 KB (float32) operand tiles, and the operand tiles are shared between
// pairs, so float32 is bound by the card's float32 rate: the JAX kernels
// ask for Precision.HIGHEST, true float32, which TF32 is not. bfloat16 on
// the tensor-core rate is bound by bytes: the distinct operand tiles once
// and the output tiles (K8: the whole band) once. K8 and K9 run both types
// on the SIMT float32 units (bfloat16 products are exact in float32), with
// the SIMT register-blocked step (tiled_common.cuh); K13 runs bfloat16 on the
// tensor cores.
//
// K8, K9. One CTA of 256 threads owns one output tile (K9) or band slot
// (K8) and keeps the 128 x 128 accumulator in registers (8 x 8 a thread);
// it walks the tile's pairs in plan order and writes the tile once. No
// atomics and a fixed order, so results repeat from run to run. The TPU
// kernels revisited the output block across consecutive grid steps: here
// that is the loop inside the CTA. For A B^T the contraction runs along
// B's rows, like A's: both are read as rows with 16-byte loads (a warp takes
// whole 32-byte sectors) and transposed into a padded shared array, never
// with a 512-byte stride.
//
// K8: the TPU copied a window of G + 2W operand block rows into VMEM for
// each super-group (megabytes at bench config 4, beyond the 227 KB of shared
// memory). Here each CTA reads its own pair tiles; the CTAs of neighbouring
// slots (same i, consecutive b; consecutive i) read the same operand rows,
// which they share through the 50 MB L2. Band slots with no live pair (cnt
// 0, i past A's rows, j outside B's) are written as exact zeros: the band
// is returned whole and every nonzero value of it would be extracted.
//
// K13: the TPU kernel double-buffered its operand DMAs across output tiles,
// in global pair order. Here about two CTAs an SM stay resident, each
// taking a contiguous range of output tiles balanced by pair count (read
// from pstart on the device; no host schedule). Each CTA runs K6's ring
// (tiled_dense.cuh): 3 stages of 16-byte cp.async copies walking its (pair,
// k0) sequence as one stream, so the next pair's and the next tile's first
// chunks load while the current ones are multiplied; at a tile boundary the
// CTA stores and zeroes its accumulator with the next chunks in flight.
// bfloat16 stays bfloat16 in shared memory (64-deep chunks, 32 KB a stage,
// XOR-swizzled) and runs mma.sync m16n8k16: A by ldmatrix, B of A B by
// ldmatrix.trans (K6's X), B of A B^T by ldmatrix (its rows are the n x k
// operand as they are). float32 runs true float32 SIMT FMAs in 32-deep
// chunks (rows padded to 36 floats; 34 KB a stage for A B, 36 KB for
// A B^T), each output element one fmaf a k in K9's order (pairs in plan
// order, k ascending), so float32 K13 equals K9 bit for bit.

#include "tiled_common.cuh"
#include "tiled_dense.cuh"

namespace {

using sps_tiled::kAStride;
using sps_tiled::kBK;
using sps_tiled::kThreads;
using sps_tiled::kTile;
using sps_tiled::kTM;

constexpr long long kTileElems = (long long)kTile * kTile;
constexpr int kTN = kTile / 16;  // accumulator columns a thread

__device__ __forceinline__ void widen8(const uint4& raw, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float2 f = __bfloat1622float2(h[c]);
    v[2 * c] = f.x;
    v[2 * c + 1] = f.y;
  }
}

// S[k][r] = tile[r*128 + k0 + k] for r < 128, k < 16: each thread loads 16
// bytes of one row and stores them transposed.
__device__ __forceinline__ void stage_rows(const float* __restrict__ tile,
                                           int k0, float (*S)[kAStride]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int idx = threadIdx.x + j * kThreads;
    const int r = idx >> 2, q = (idx & 3) * 4;
    const float4 v =
        __ldg(reinterpret_cast<const float4*>(tile + r * kTile + k0 + q));
    S[q][r] = v.x;
    S[q + 1][r] = v.y;
    S[q + 2][r] = v.z;
    S[q + 3][r] = v.w;
  }
}

__device__ __forceinline__ void stage_rows(
    const __nv_bfloat16* __restrict__ tile, int k0, float (*S)[kAStride]) {
  const int r = threadIdx.x >> 1, q = (threadIdx.x & 1) * 8;
  float v[8];
  widen8(__ldg(reinterpret_cast<const uint4*>(tile + r * kTile + k0 + q)),
         v);
#pragma unroll
  for (int c = 0; c < 8; ++c) S[q + c][r] = v[c];
}

// S[k][n] = tile[(k0 + k)*128 + n]: whole rows of the tile, as they are.
__device__ __forceinline__ void stage_cols(const float* __restrict__ tile,
                                           int k0, float (*S)[kAStride]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int idx = threadIdx.x + j * kThreads;
    const int k = idx >> 5, n = (idx & 31) * 4;
    *reinterpret_cast<float4*>(&S[k][n]) =
        __ldg(reinterpret_cast<const float4*>(tile + (k0 + k) * kTile + n));
  }
}

__device__ __forceinline__ void stage_cols(
    const __nv_bfloat16* __restrict__ tile, int k0, float (*S)[kAStride]) {
  const int k = threadIdx.x >> 4, n = (threadIdx.x & 15) * 8;
  float v[8];
  widen8(__ldg(reinterpret_cast<const uint4*>(tile + (k0 + k) * kTile + n)),
         v);
  *reinterpret_cast<float4*>(&S[k][n]) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(&S[k][n + 4]) =
      make_float4(v[4], v[5], v[6], v[7]);
}

// acc += a . b (b^T when kTransB), k ascending, through shared memory.
template <typename T, bool kTransB>
__device__ __forceinline__ void add_pair(const T* __restrict__ a,
                                         const T* __restrict__ b,
                                         float (*As)[kAStride],
                                         float (*Bs)[kAStride], int tx,
                                         int ty, float (&acc)[kTM][kTN]) {
  for (int k0 = 0; k0 < kTile; k0 += kBK) {
    stage_rows(a, k0, As);
    if constexpr (kTransB) {
      stage_rows(b, k0, Bs);
    } else {
      stage_cols(b, k0, Bs);
    }
    __syncthreads();
    sps_tiled::fma_chunk<kTile, kAStride>(As, Bs, tx, ty, acc);
    __syncthreads();
  }
}

__device__ __forceinline__ void zero(float (&acc)[kTM][kTN]) {
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
}

// The CTA's tile in K6's register layout (out_col<128>), 16 bytes a store.
__device__ __forceinline__ void store_tile(float* __restrict__ out,
                                           const float (&acc)[kTM][kTN],
                                           int tx, int ty) {
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    float* row = out + (ty * kTM + i) * kTile + tx * 4;
#pragma unroll
    for (int g = 0; g < 2; ++g)
      *reinterpret_cast<float4*>(row + g * 64) =
          make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                      acc[i][4 * g + 3]);
  }
}

// K9: one CTA per output tile t.
template <typename T, bool kTransB>
__global__ void __launch_bounds__(kThreads)
    pairs_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 const int* __restrict__ pa, const int* __restrict__ pb,
                 const int* __restrict__ pstart, float* __restrict__ out) {
  __shared__ __align__(16) float As[kBK][kAStride];
  __shared__ __align__(16) float Bs[kBK][kAStride];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int t = blockIdx.x;
  float acc[kTM][kTN];
  zero(acc);
  for (int p = pstart[t]; p < pstart[t + 1]; ++p)
    add_pair<T, kTransB>(a + pa[p] * kTileElems, b + pb[p] * kTileElems, As,
                         Bs, tx, ty, acc);
  store_tile(out + t * kTileElems, acc, tx, ty);
}

// K8: one CTA per band slot, slots in (i, b) order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    window_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const int* __restrict__ cnt, const int* __restrict__ pt,
                  const int* __restrict__ pu, const int* __restrict__ prefix,
                  int nb, int w, int s, int nbr_a, int nbr_b, int rt_a,
                  int rt_b, float* __restrict__ out) {
  __shared__ __align__(16) float As[kBK][kAStride];
  __shared__ __align__(16) float Bs[kBK][kAStride];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int slot = blockIdx.x;
  const int i = slot / nb, band = slot % nb, j = i + band - w;
  const int n = (i < nbr_a && j >= 0 && j < nbr_b) ? cnt[slot] : 0;
  const long long q0 = (long long)i * s + prefix[band];
  float acc[kTM][kTN];
  zero(acc);
  for (int p = 0; p < n; ++p)
    add_pair<T, true>(a + ((long long)i * rt_a + pt[q0 + p]) * kTileElems,
                      b + ((long long)j * rt_b + pu[q0 + p]) * kTileElems, As,
                      Bs, tx, ty, acc);
  store_tile(out + slot * kTileElems, acc, tx, ty);
}

// --- K13 --------------------------------------------------------------------
// A persistent ring over the pair stream, built from K6's primitives
// (tiled_dense.cuh: Ring<T>, load_stage, cp.async, compute_stage, ldmatrix,
// mma.sync, store_tile). A stage holds the k-chunk [k0, k0 + kBK) of one
// pair: A's 128 x kBK chunk laid out as K6 stages a block (Ring<T>::a_off);
// for A B, B's kBK x 128 rows laid out as K6 stages X (x_off), and for
// A B^T, B's 128 x kBK chunk laid out like A's.
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

// float32 A B^T: K6's 8 x 8 register tile a thread, in another warp
// layout. Warp w owns rows (w % 4) * 32 .. + 31 and columns (w / 4) * 64 ..
// + 63; lane (ly, lx) = (lane / 8, lane % 8) owns rows ly + 4 i and columns
// lx + 8 j of them. Both chunks are read along their rows (k), 36 floats
// apart: a warp reads 4 distinct A rows (float2, two k) and 8 distinct B
// rows (one k) at a time, each row in its own group of 4 banks, so no read
// conflicts; each output element takes one fmaf a k, k ascending (K9's
// order).
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
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        sps_dense::mma_bf16(acc.v[mt][nt], a[mt], b[nt][0], b[nt][1]);
  }
}

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

// K13: persistent CTAs. CTA g takes the output tiles [t0, t1) whose pairs
// begin in the g-th of gridDim.x equal parts of the pair stream (the last
// CTA also takes trailing tiles with no pairs), so the parts differ by less
// than one tile's pairs. The ring walks the CTA's (pair, k0) sequence in
// plan order across tile boundaries; at a tile's last chunk the CTA stores
// and zeroes its accumulator while the next tile's chunks are in flight. A
// tile with no pairs is stored as zeros.
template <typename T, bool kTransB>
__global__ void __launch_bounds__(sps_dense::kThreads, 2)
    pairs_ring_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      const int* __restrict__ pa,
                      const int* __restrict__ pb,
                      const int* __restrict__ pstart, int n_out,
                      float* __restrict__ out) {
  using R = Ring<T>;
  constexpr int kStage = pair_stage_elems<T, kTransB>();
  constexpr int kStages = sps_dense::kStages;
  constexpr int kChunks = kTile / R::kBK;   // chunks a pair
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const long long n_pairs = pstart[n_out];
  const int g = blockIdx.x, ctas = gridDim.x;
  const int t0 = first_tile(pstart, n_out, n_pairs * g / ctas);
  const int t1 = g + 1 == ctas
                     ? n_out
                     : first_tile(pstart, n_out, n_pairs * (g + 1) / ctas);
  const int p0 = pstart[t0];
  const int total = (pstart[t1] - p0) * kChunks;   // chunks in the ring

  // The producer's cursor over (pair, k0), in the consumer's order.
  int p_load = p0, k_load = 0;
  auto issue = [&](int stage) {
    load_pair_chunk<T, kTransB>(smem + stage * kStage,
                                a + pa[p_load] * kTileElems,
                                b + pb[p_load] * kTileElems, k_load, tid);
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
      if constexpr (kTransB) {
        compute_stage_nt(st, acc, tid);
      } else {
        sps_dense::compute_stage(st, acc, tid);
      }
    }
    float* tile = out + t * kTileElems;
    if constexpr (kTransB && sizeof(T) == 4) {
      store_tile_nt(acc, tile, tid);
    } else {
      sps_dense::store_tile(acc, tile, kTile, kTile, 0, 0, tid);
    }
    acc.zero();
  }
}

// K13 over n_out tiles: as many CTAs as are resident on the card at once
// (two an SM), at most one a tile.
template <typename T, bool kTransB>
int launch_pairs_ring(const T* a, const T* b, const int* pa, const int* pb,
                      const int* pstart, int n_out, float* out,
                      cudaStream_t s) {
  auto kernel = pairs_ring_kernel<T, kTransB>;
  const int smem =
      sps_dense::kStages * pair_stage_elems<T, kTransB>() * (int)sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, sps_dense::kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const int grid = (int)(n_out < resident ? n_out : resident);
  kernel<<<grid, sps_dense::kThreads, smem, s>>>(a, b, pa, pb, pstart, n_out,
                                                 out);
  return (int)cudaGetLastError();
}

template <typename T, bool kTransB>
int launch_pairs(bool stream_kernel, const void* a, const void* b,
                 const void* pa, const void* pb, const void* pstart,
                 int n_out, void* out, cudaStream_t s) {
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  const int* PA = static_cast<const int*>(pa);
  const int* PB = static_cast<const int*>(pb);
  const int* PS = static_cast<const int*>(pstart);
  float* O = static_cast<float*>(out);
  if (stream_kernel)
    return launch_pairs_ring<T, kTransB>(A, B, PA, PB, PS, n_out, O, s);
  pairs_kernel<T, kTransB><<<n_out, kThreads, 0, s>>>(A, B, PA, PB, PS, O);
  return (int)cudaGetLastError();
}

int dispatch_pairs(bool stream_kernel, int dtype, int transpose_b,
                   const void* a, const void* b, const void* pa,
                   const void* pb, const void* pstart, int n_out, void* out,
                   void* stream) {
  if (n_out <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return transpose_b
               ? launch_pairs<float, true>(stream_kernel, a, b, pa, pb,
                                           pstart, n_out, out, s)
               : launch_pairs<float, false>(stream_kernel, a, b, pa, pb,
                                            pstart, n_out, out, s);
  if (dtype == 1)
    return transpose_b
               ? launch_pairs<__nv_bfloat16, true>(stream_kernel, a, b, pa,
                                                   pb, pstart, n_out, out, s)
               : launch_pairs<__nv_bfloat16, false>(stream_kernel, a, b, pa,
                                                    pb, pstart, n_out, out,
                                                    s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K9: out (n_out, 128, 128) float32 from flat operand blocks a, b (T, 128,
// 128) and the pair plan pa, pb (P,) int32 with pstart (n_out + 1,) int32.
// dtype: 0 = float32, 1 = bfloat16; transpose_b: 1 for A B^T.
int sps_spgemm_pairs(int dtype, int transpose_b, const void* a,
                     const void* b, const void* pa, const void* pb,
                     const void* pstart, int n_out, void* out, void* stream) {
  return dispatch_pairs(false, dtype, transpose_b, a, b, pa, pb, pstart,
                        n_out, out, stream);
}

// K13: K9's function and arguments; persistent CTAs stream the operand
// chunks through a cp.async ring (the operands must be 16-byte aligned).
int sps_spgemm_pairs_stream(int dtype, int transpose_b, const void* a,
                            const void* b, const void* pa, const void* pb,
                            const void* pstart, int n_out, void* out,
                            void* stream) {
  return dispatch_pairs(true, dtype, transpose_b, a, b, pa, pb, pstart,
                        n_out, out, stream);
}

// K8: the band out (nslots = nbr_pad * nb, 128, 128) float32 of A B^T from
// row-grouped blocks a (nbr_a, rt_a, 128, 128) and b (nbr_b, rt_b, 128,
// 128) (b may equal a); cnt (nslots,), pt/pu (nbr_pad * s,) and prefix
// (nb,) int32 from the plan; nb = 2w + 1. dtype: 0 = float32, 1 = bfloat16.
int sps_spgemm_window(int dtype, const void* a, const void* b,
                      const void* cnt, const void* pt, const void* pu,
                      const void* prefix, int nslots, int nb, int w, int s,
                      int nbr_a, int nbr_b, int rt_a, int rt_b, void* out,
                      void* stream) {
  if (nslots <= 0) return (int)cudaSuccess;
  if (nb != 2 * w + 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* C = static_cast<const int*>(cnt);
  const int* PT = static_cast<const int*>(pt);
  const int* PU = static_cast<const int*>(pu);
  const int* PF = static_cast<const int*>(prefix);
  float* O = static_cast<float*>(out);
  if (dtype == 0) {
    window_kernel<float><<<nslots, kThreads, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), C, PT,
        PU, PF, nb, w, s, nbr_a, nbr_b, rt_a, rt_b, O);
  } else if (dtype == 1) {
    window_kernel<__nv_bfloat16><<<nslots, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), C, PT, PU, PF, nb, w, s, nbr_a,
        nbr_b, rt_a, rt_b, O);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
