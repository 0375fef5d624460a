// K6's body for Hopper: a pipelined dense-tile SpMM (tiled.cu,
// sps_tiled_dense), with bfloat16 blocks on the tensor cores. K5
// (tiled_window.cu) runs the same body; the SpGEMM pair kernel K13
// (spgemm.cu) builds on its ring, stage loads and tile products.
//
//   Y[b*128 + i, n] = sum_t sum_k blocks[b, t, i, k] * X[tc*128 + k, n]
//
// over the live slots t of block row b (tc = cols(b, t), negative on
// padding: K6's DenseCols reads tcols with the sentinel nbc, K5's WindowCols
// the super-row window table; tiled_common.cuh), float32 out and float32 accumulation, for float32 or
// bfloat16 blocks with X in the block's type. Padding slots read nothing,
// rows of X past K read 0, and Y rows >= M and columns >= N are never
// written.
//
// What bounds it. A live block costs 2*128*128*N operations against its
// 64 KB (float32) or 32 KB (bfloat16) of block bytes. At N = 128 float32
// blocks are bound by the card's float32 rate (true float32: never TF32,
// the JAX kernel's Precision.HIGHEST), and bfloat16 blocks, on the
// tensor-core rate, by memory.
//
// The design. One CTA of 256 threads (8 warps) owns one block row and 128
// output columns, with the 128 x 128 float32 output tile in registers, and
// two CTAs fit an SM (__launch_bounds__(256, 2): at most 128 registers a
// thread; about 100 KB of shared memory each).
//
// * A ring of kStages k-chunk stages in dynamic shared memory, filled by
//   16-byte cp.async copies: chunk c + 2 is in flight while chunk c is
//   multiplied, and one __syncthreads() a chunk both publishes chunk c and
//   frees the stage that chunk c + 2 overwrites. The ring walks (live slot
//   t, k0) as one sequence, so the next tile's first chunks load during the
//   current tile's last products. Chunks are 32 deep in float32 (A 128 x 32
//   with rows padded to 36 floats, X 32 x 128: 34 KB a stage) and 64 deep
//   in bfloat16 (A 128 x 64, X 64 x 128: 32 KB a stage).
// * bfloat16 stays bfloat16 in shared memory and runs on the tensor cores:
//   mma.sync m16n8k16 (bf16 x bf16 -> f32), A fed by ldmatrix and X, which
//   is row-major k x n, by ldmatrix.trans. Both tiles store 16-byte chunks
//   XOR-swizzled by the row (chunk c of row r at c ^ (r & 7)), so the 8 row
//   addresses of every ldmatrix phase fall in 8 distinct bank groups. Warp
//   w owns the 64 x 32 output slice at rows (w % 2) * 64, columns (w / 2) *
//   32: 4 x 4 mma tiles, 64 float32 accumulators a thread. mma.sync, not
//   wgmma: at bench config 3 the bytes take 0.160 ms and the 34.4 GFLOP
//   0.035 ms at the tensor-core peak, so a fraction of that rate does not
//   set the pace.
// * float32 runs SIMT FMAs on the same ring: each thread keeps an 8 x 8
//   register tile, rows ty + 16 i (interleaved, so that the two row groups
//   of a warp read A from different banks) and columns (j / 4) * 64 + tx *
//   4 + j % 4 (two conflict-free float4 reads of a staged X row); A is read
//   two k at a time (float2).
// * X is copied with 16-byte cp.async (zero-filled past K and N) when N is
//   a multiple of the 16-byte vector and X is 16-byte aligned; otherwise the
//   X stage is filled element by element (plain loads, bounds-checked).
//   Blocks must be 16-byte aligned (the wrapper checks).
// * A thin X (N <= 32) keeps PR 3's SIMT body with 32 output columns a CTA
//   (tiled_common.cuh, dense_tiles_kernel<T, 32>) in both types: a 128 x 32
//   tile leaves the tensor-core warps a quarter of the work per staged
//   block.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tiled_common.cuh"

namespace sps_dense {

using sps_tiled::kTile;

constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kBN = 128;        // output columns a CTA
constexpr int kCopies = 4;      // 16-byte copies a thread, per tile, a stage

template <typename T>
struct Ring;

// float32: k-chunks of 32; A rows padded to 36 floats (16-byte aligned rows,
// 8 chunks of 4 floats); X rows of 128 floats (32 chunks).
template <>
struct Ring<float> {
  using Bits = unsigned int;
  static constexpr int kBK = 32;
  static constexpr int kVec = 4;
  static constexpr int kAStride = kBK + 4;
  static constexpr int kAElems = kTile * kAStride;
  static constexpr int kStageElems = kAElems + kBK * kBN;
  __device__ static int a_off(int row, int c) {
    return row * kAStride + c * kVec;
  }
  __device__ static int x_off(int k, int c) { return k * kBN + c * kVec; }
};

// bfloat16: k-chunks of 64; A rows of 64 (8 chunks of 8), X rows of 128 (16
// chunks of 8); chunk c of row r stored at c ^ (r & 7).
template <>
struct Ring<__nv_bfloat16> {
  using Bits = unsigned short;
  static constexpr int kBK = 64;
  static constexpr int kVec = 8;
  static constexpr int kAStride = kBK;
  static constexpr int kAElems = kTile * kAStride;
  static constexpr int kStageElems = kAElems + kBK * kBN;
  __device__ static int a_off(int row, int c) {
    return row * kAStride + ((c ^ (row & 7)) * kVec);
  }
  __device__ static int x_off(int k, int c) {
    return k * kBN + ((c ^ (k & 7)) * kVec);
  }
};

template <typename T>
constexpr int stage_bytes() {
  return Ring<T>::kStageElems * (int)sizeof(T);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int src_bytes = valid ? 16 : 0;   // 0: zero-fill, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Fill one stage: the k-chunk [k0, k0 + kBK) of the 128 x 128 block blk and
// of the X rows xrow0 + k0 ... at columns n0 ... n0 + 127.
template <typename T, bool kAlignedX>
__device__ __forceinline__ void load_stage(T* st, const T* __restrict__ blk,
                                           int k0, long long xrow0,
                                           const T* __restrict__ X,
                                           long long K, int N, int n0,
                                           int tid) {
  using R = Ring<T>;
  constexpr int kAChunks = R::kBK / R::kVec;   // 8 a row
  constexpr int kXChunks = kBN / R::kVec;      // 32 or 16 a row
  T* As = st;
  T* Xs = st + R::kAElems;
#pragma unroll
  for (int j = 0; j < kCopies; ++j) {
    const int q = tid + j * kThreads;
    const int row = q / kAChunks, c = q % kAChunks;
    cp_async16(As + R::a_off(row, c), blk + row * kTile + k0 + c * R::kVec,
               true);
  }
#pragma unroll
  for (int j = 0; j < kCopies; ++j) {
    const int q = tid + j * kThreads;
    const int k = q / kXChunks, c = q % kXChunks;
    const long long xr = xrow0 + k0 + k;
    const int col = n0 + c * R::kVec;
    T* dst = Xs + R::x_off(k, c);
    if constexpr (kAlignedX) {
      const bool ok = xr < K && col < N;
      cp_async16(dst, ok ? X + xr * N + col : X, ok);
    } else {
      using B = typename R::Bits;
      const B* xb = reinterpret_cast<const B*>(X) + xr * N;
      alignas(16) B v[R::kVec];
#pragma unroll
      for (int e = 0; e < R::kVec; ++e)
        v[e] = (xr < K && col + e < N) ? xb[col + e] : B(0);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

// ---- float32: SIMT FMAs, an 8 x 8 register tile a thread ------------------
struct AccF32 {
  float v[8][8];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) v[i][j] = 0.f;
  }
};

__device__ __forceinline__ void compute_stage(const float* st, AccF32& acc,
                                              int tid) {
  using R = Ring<float>;
  const float* As = st;
  const float* Xs = st + R::kAElems;
  const int tx = tid % 16, ty = tid / 16;
  // One k pair an iteration, not unrolled: x is loaded a k at a time, so
  // the 64 accumulators, a[8] and x[8] fit 128 registers with no spill.
#pragma unroll 1
  for (int k = 0; k < R::kBK; k += 2) {
    float2 a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = *reinterpret_cast<const float2*>(
          As + (ty + 16 * i) * R::kAStride + k);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const float* xr = Xs + (k + kk) * kBN + tx * 4;
      const float4 lo = *reinterpret_cast<const float4*>(xr);
      const float4 hi = *reinterpret_cast<const float4*>(xr + 64);
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

__device__ __forceinline__ void store_tile(const AccF32& acc, float* Y,
                                           long long M, int N, int b, int n0,
                                           int tid) {
  const int tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = (long long)b * kTile + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + (j / 4) * 64 + tx * 4 + j % 4;
      if (c < N) Y[row * N + c] = acc.v[i][j];
    }
  }
}

// ---- bfloat16: mma.sync on the tensor cores --------------------------------
struct AccBF16 {
  float v[4][4][4];   // [m tile][n tile][fragment]
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[i][j][e] = 0.f;
  }
};

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p,
                                            bool trans) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  if (trans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(s));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void compute_stage(const __nv_bfloat16* st,
                                              AccBF16& acc, int tid) {
  using R = Ring<__nv_bfloat16>;
  const __nv_bfloat16* As = st;
  const __nv_bfloat16* Xs = st + R::kAElems;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp % 2) * 64, wn = (warp / 2) * 32;
  // ldmatrix x4: lanes 8j .. 8j + 7 address the rows of matrix j.
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lhalf = lane >> 4;
#pragma unroll
  for (int kk = 0; kk < R::kBK; kk += 16) {
    unsigned a[4][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      // matrices: rows +0 / +8 (j & 1), k +0 / +8 (j >> 1)
      const int row = wm + mt * 16 + lrow;
      ldmatrix_x4(a[mt], As + R::a_off(row, kk / 8 + lhalf), false);
    }
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      // matrices: k +0 / +8 (j & 1), n +0 / +8 (j >> 1), transposed
      const int krow = kk + lrow;
      const int c = (wn + np * 16) / 8 + lhalf;
      unsigned r[4];
      ldmatrix_x4(r, Xs + R::x_off(krow, c), true);
      b[2 * np][0] = r[0]; b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2]; b[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_bf16(acc.v[mt][nt], a[mt], b[nt][0], b[nt][1]);
  }
}

__device__ __forceinline__ void store_tile(const AccBF16& acc, float* Y,
                                           long long M, int N, int b, int n0,
                                           int tid) {
  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp % 2) * 64, wn = (warp / 2) * 32;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = (long long)b * kTile + wm + mt * 16 + g + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n0 + wn + nt * 8 + 2 * q + e;
          if (c < N) Y[row * N + c] = acc.v[mt][nt][2 * h + e];
        }
    }
}

template <typename T>
struct Acc;
template <>
struct Acc<float> {
  using type = AccF32;
};
template <>
struct Acc<__nv_bfloat16> {
  using type = AccBF16;
};

template <typename T, typename Cols, bool kAlignedX>
__global__ void __launch_bounds__(kThreads, 2)
    dense_ring_kernel(const T* __restrict__ blocks, Cols cols, int rt,
                      int nchunks,
                      const T* __restrict__ X, long long K, int N,
                      float* __restrict__ Y, long long M) {
  using R = Ring<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int b = blockIdx.x / nchunks;
  const int n0 = (blockIdx.x % nchunks) * kBN;
  const int tid = threadIdx.x;

  int n_live = 0;
  for (int t0 = 0; t0 < rt; t0 += kThreads)
    n_live += __syncthreads_count(t0 + tid < rt && cols(b, t0 + tid) >= 0);
  const int total = n_live * (kTile / R::kBK);   // chunks in the ring

  // The producer's cursor over (live slot, k0), in the consumer's order.
  int t_load = -1, k_load = kTile;
  auto advance = [&]() {
    k_load += R::kBK;
    if (k_load >= kTile) {
      k_load = 0;
      do {
        ++t_load;
      } while (t_load < rt && cols(b, t_load) < 0);
    }
  };
  auto issue = [&](int stage) {
    const T* blk = blocks + ((long long)b * rt + t_load) * kTile * kTile;
    load_stage<T, kAlignedX>(smem + stage * R::kStageElems, blk, k_load,
                             (long long)cols(b, t_load) * kTile, X, K, N, n0,
                             tid);
  };

  typename Acc<T>::type acc;
  acc.zero();

  advance();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) {
      issue(s);
      advance();
    }
    cp_async_commit();
  }
  for (int c = 0; c < total; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // chunk c landed for all; stage (c - 1) % S is free
    const int next = c + kStages - 1;
    if (next < total) {
      issue(next % kStages);
      advance();
    }
    cp_async_commit();
    compute_stage(smem + (c % kStages) * R::kStageElems, acc, tid);
  }
  store_tile(acc, Y, M, N, b, n0, tid);
}

template <typename T, typename Cols, bool kAlignedX>
cudaError_t launch_ring(const T* blocks, Cols cols, int rt,
                        long long nchunks, long long grid, const T* X,
                        long long K, int N, float* Y, long long M,
                        cudaStream_t stream) {
  auto kernel = dense_ring_kernel<T, Cols, kAlignedX>;
  const int smem = kStages * stage_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(blocks, cols, rt,
                                                     (int)nchunks, X, K, N,
                                                     Y, M);
  return cudaGetLastError();
}

// K6 (DenseCols) or K5 (WindowCols) over nbr block rows. N <= 32 takes the
// SIMT body of tiled_common.cuh (BN = 32); wider X the ring, 128 columns a
// CTA. Returns cudaGetLastError() after the launch.
template <typename T, typename Cols>
int launch_dense_ring(const void* blocks, Cols cols, int nbr, int rt,
                      const void* X, long long K, int N, void* Y,
                      long long M, cudaStream_t stream) {
  if (nbr <= 0 || N <= 0 || M <= 0) return (int)cudaSuccess;
  if (N <= 32)
    return sps_tiled::launch_dense_tiles<T>(blocks, cols, nbr, rt, X, K, N, Y,
                                            M, stream);
  if (reinterpret_cast<std::uintptr_t>(blocks) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long nchunks = (N + kBN - 1) / kBN;
  const long long grid = (long long)nbr * nchunks;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const T* blk = static_cast<const T*>(blocks);
  const T* x = static_cast<const T*>(X);
  float* y = static_cast<float*>(Y);
  const bool aligned = N % Ring<T>::kVec == 0 &&
                       reinterpret_cast<std::uintptr_t>(X) % 16 == 0;
  return (int)(aligned ? launch_ring<T, Cols, true>(blk, cols, rt, nchunks,
                                                    grid, x, K, N, y, M,
                                                    stream)
                       : launch_ring<T, Cols, false>(blk, cols, rt, nchunks,
                                                     grid, x, K, N, y, M,
                                                     stream));
}

}  // namespace sps_dense
