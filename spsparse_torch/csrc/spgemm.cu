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
//     K9's function over the same grid, with the operand chunks of the next
//     step copied by cp.async while the current one is multiplied.
//
// All three write float32 128 x 128 tiles from float32 or bfloat16
// operands (both operands of one type).
//
// What bounds them. A pair costs 2*128^3 operations against at most two
// 64 KB (float32) operand tiles, and the operand tiles are shared between
// pairs, so float32 is bound by the card's float32 rate: the JAX kernels
// ask for Precision.HIGHEST, true float32, which TF32 is not. bfloat16 on
// the tensor-core rate would be bound by bytes: the distinct operand tiles
// once and the output tiles (K8: the whole band) once. These first kernels
// run both types on the SIMT float32 units (bfloat16 products are exact in
// float32), with K6's register-blocked body (tiled_common.cuh).
//
// Design. One CTA of 256 threads owns one output tile (K9, K13) or band
// slot (K8) and keeps the 128 x 128 accumulator in registers (8 x 8 a
// thread); it walks the tile's pairs in plan order and writes the tile
// once. No atomics and a fixed order, so results repeat from run to run;
// K9 and K13 sum in the same order. The TPU kernels revisited the output
// block across consecutive grid steps: here that is the loop inside the
// CTA.
//
// For A B^T the contraction runs along B's rows, like A's: both are read as
// rows with 16-byte loads (a warp takes whole 32-byte sectors) and
// transposed into a padded shared array, never with a 512-byte stride.
//
// K8: the TPU copied a window of G + 2W operand block rows into VMEM for
// each super-group (megabytes at bench config 4, beyond the 227 KB of shared
// memory). Here each CTA reads its own pair tiles; the CTAs of neighbouring
// slots (same i, consecutive b; consecutive i) read the same operand rows,
// which they share through the 50 MB L2. Band slots with no live pair (cnt
// 0, i past A's rows, j outside B's) are written as exact zeros: the band
// is returned whole and every nonzero value of it would be extracted.
//
// K13: the TPU kernel double-buffered its operand DMAs across pairs. Here
// a step is one 16-deep k-chunk of one pair; the chunks of step s + 1 (the
// next chunk, or the first of the next pair) are copied with cp.async, 16
// bytes a thread, into the second of two shared stages while step s is
// multiplied. The stages hold the raw operand rows (bfloat16 stays
// bfloat16 and is widened at use): 40 KB for float32 A B^T.

#include <cstdint>

#include "tiled_common.cuh"

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
// A raw stage holds an A chunk (and a B^T chunk) as 128 rows of 16 values,
// rows kRawRow elements apart (80 bytes float32, 48 bytes bfloat16): 16-byte
// aligned for cp.async, and 16 neighbouring rows fall in distinct banks. A B
// chunk of A B is 16 rows of 128 values.
template <typename T>
constexpr int kRawRow = sizeof(T) == 4 ? 20 : 24;
template <typename T>
constexpr int kVec = 16 / sizeof(T);  // elements a 16-byte copy

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

// Copy the k-chunk [k0, k0 + 16) of tiles a and b into a raw stage.
template <typename T, bool kTransB>
__device__ __forceinline__ void copy_chunk(const T* __restrict__ a,
                                           const T* __restrict__ b, int k0,
                                           T* sa, T* sb) {
  constexpr int V = kVec<T>, R = kRawRow<T>;
  for (int idx = threadIdx.x; idx < kTile * kBK / V; idx += kThreads) {
    const int r = idx / (kBK / V), c = (idx % (kBK / V)) * V;
    cp_async16(sa + r * R + c, a + r * kTile + k0 + c);
    if constexpr (kTransB) cp_async16(sb + r * R + c, b + r * kTile + k0 + c);
  }
  if constexpr (!kTransB) {
    for (int idx = threadIdx.x; idx < kBK * kTile / V; idx += kThreads) {
      const int k = idx / (kTile / V), n = (idx % (kTile / V)) * V;
      cp_async16(sb + k * kTile + n, b + (k0 + k) * kTile + n);
    }
  }
}

// Output column of a thread's j-th accumulator in K13: K6's layout for A B
// (16-byte reads along the staged B rows); tx + 16 j for A B^T, so that the
// threads of a read phase take neighbouring padded rows, in distinct banks.
template <bool kTransB>
__device__ __forceinline__ int stream_col(int tx, int j) {
  if constexpr (kTransB) {
    return tx + 16 * j;
  } else {
    return sps_tiled::out_col<kTile>(tx, j);
  }
}

// acc += one raw k-chunk, 4 k at a time, k ascending (K9's order).
template <typename T, bool kTransB>
__device__ __forceinline__ void fma_raw_chunk(const T* sa, const T* sb,
                                              int tx, int ty,
                                              float (&acc)[kTM][kTN]) {
  constexpr int R = kRawRow<T>;
#pragma unroll
  for (int kq = 0; kq < kBK; kq += 4) {
    float av[kTM][4], bv[4][kTN];
#pragma unroll
    for (int r = 0; r < kTM; ++r) load4(sa + (ty * kTM + r) * R + kq, av[r]);
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      float v[4];
      if constexpr (kTransB) {
        load4(sb + stream_col<true>(tx, j) * R + kq, v);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) bv[kk][j] = v[kk];
      } else if (j % 4 == 0) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          load4(sb + (kq + kk) * kTile + stream_col<false>(tx, j), v);
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[kk][j + c] = v[c];
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < kTM; ++r)
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          acc[r][j] = fmaf(av[r][kk], bv[kk][j], acc[r][j]);
  }
}

// K13: one CTA per output tile t; step s is k-chunk s % 8 of pair s / 8.
template <typename T, bool kTransB>
__global__ void __launch_bounds__(kThreads)
    pairs_stream_kernel(const T* __restrict__ a, const T* __restrict__ b,
                        const int* __restrict__ pa,
                        const int* __restrict__ pb,
                        const int* __restrict__ pstart,
                        float* __restrict__ out) {
  constexpr int kA = kTile * kRawRow<T>;
  constexpr int kB = kTransB ? kA : kBK * kTile;
  constexpr int kChunks = kTile / kBK;
  __shared__ __align__(16) T sa[2][kA];
  __shared__ __align__(16) T sb[2][kB];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int t = blockIdx.x;
  const int p0 = pstart[t];
  const int steps = (pstart[t + 1] - p0) * kChunks;
  float acc[kTM][kTN];
  zero(acc);
  auto issue = [&](int step) {
    const int p = p0 + step / kChunks, st = step & 1;
    copy_chunk<T, kTransB>(a + pa[p] * kTileElems, b + pb[p] * kTileElems,
                           (step % kChunks) * kBK, sa[st], sb[st]);
  };
  if (steps > 0) issue(0);
  cp_async_commit();
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) issue(step + 1);
    cp_async_commit();
    cp_async_wait_prior();  // this step's copies have landed
    __syncthreads();
    fma_raw_chunk<T, kTransB>(sa[step & 1], sb[step & 1], tx, ty, acc);
    __syncthreads();  // the stage is read before step + 2 refills it
  }
  float* tile = out + t * kTileElems;
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      tile[(ty * kTM + i) * kTile + stream_col<kTransB>(tx, j)] = acc[i][j];
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
  if (stream_kernel) {
    pairs_stream_kernel<T, kTransB><<<n_out, kThreads, 0, s>>>(A, B, PA, PB,
                                                               PS, O);
  } else {
    pairs_kernel<T, kTransB><<<n_out, kThreads, 0, s>>>(A, B, PA, PB, PS, O);
  }
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

// K13: K9's function and arguments; operand chunks double-buffered by
// cp.async (the operands must be 16-byte aligned).
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
