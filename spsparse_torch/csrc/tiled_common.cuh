// Shared body of the dense-block tiled SpMM kernels K5 (tiled_window.cu)
// and K6 (tiled.cu).
//
// The operand is a sparse pattern of dense 128 x 128 blocks grouped by
// block row: blocks (nbr, rt, 128, 128) row-major, slot t of block row b
// holding the block at tile column cols(b, t), or padding when cols(b, t)
// is negative. K6 reads the tile column from tcols (nbr, rt) with the
// sentinel nbc; K5 from a super-row window table (WindowCols). The product
//
//   Y[b*128 + i, n] = sum_t sum_k blocks[b, t, i, k] * X[tc*128 + k, n]
//
// is float32 out and float32 accumulation, for float32 or bfloat16 blocks
// with X in the block's type.
//
// One CTA of 256 threads owns one block row and a chunk of BN output
// columns (BN = 128, or 32 for a thin X), and keeps the 128 x BN output
// tile in registers: each thread holds 8 rows x BN/16 columns. For every
// live slot it stages the block and the X tile in k-chunks of 16 in shared
// memory, as float32, and runs plain FMAs over them (for float32 blocks
// that is true float32, never TF32; bfloat16 products are exact in float32,
// so the bfloat16 path matches a bfloat16 x bfloat16 -> float32 product up
// to summation order). Padding slots read neither the block nor X. Rows of
// X beyond K and columns beyond N read zero and are never written, so X is
// not padded.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sps_tiled {

constexpr int kTile = 128;     // TILE of the layout
constexpr int kBK = 16;        // k-chunk staged in shared memory
constexpr int kThreads = 256;  // 16 column groups x 16 row groups
constexpr int kTM = 8;         // output rows per thread
constexpr int kAStride = kTile + 4;  // padded row of the staged A chunk

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// K6: tile columns from tcols (nbr, rt); the sentinel nbc marks padding.
struct DenseCols {
  const int* tcols;
  int rt;
  int nbc;
  __device__ __forceinline__ int operator()(int b, int t) const {
    const int tc = tcols[(long long)b * rt + t];
    return tc < nbc ? tc : -1;
  }
};

// K5: tile column = wstart[b / group] + offs[b*rt + t]; offs -1 = padding.
struct WindowCols {
  const int* wstart;
  const int* offs;
  int rt;
  int group;
  __device__ __forceinline__ int operator()(int b, int t) const {
    const int o = offs[(long long)b * rt + t];
    return o >= 0 ? wstart[b / group] + o : -1;
  }
};

// Output column of a thread's j-th accumulator: groups of 4 neighbouring
// columns 64 apart for BN = 128 (conflict-free float4 reads of the staged
// X), 2 neighbouring columns for BN = 32.
template <int BN>
__device__ __forceinline__ int out_col(int tx, int j) {
  if constexpr (BN / 16 >= 4) {
    return (j / 4) * 64 + tx * 4 + (j % 4);
  } else {
    return tx * (BN / 16) + j;
  }
}

template <typename T, int BN, typename Cols>
__global__ void __launch_bounds__(kThreads)
    dense_tiles_kernel(const T* __restrict__ blocks, Cols cols, int rt,
                       int nchunks, const T* __restrict__ X, long long K,
                       int N, float* __restrict__ Y, long long M) {
  constexpr int TN = BN / 16;
  __shared__ __align__(16) float As[kBK][kAStride];
  __shared__ __align__(16) float Xs[kBK][BN];

  const int b = blockIdx.x / nchunks;
  const int n0 = (blockIdx.x % nchunks) * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[kTM][TN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < rt; ++t) {
    const int tc = cols(b, t);
    if (tc < 0) continue;  // padding slot: no block, no X tile
    const T* blk = blocks + ((long long)b * rt + t) * kTile * kTile;
    const long long xrow0 = (long long)tc * kTile;
    for (int k0 = 0; k0 < kTile; k0 += kBK) {
#pragma unroll
      for (int j = 0; j < kTile * kBK / kThreads; ++j) {
        const int idx = tid + j * kThreads;
        const int i = idx / kBK, k = idx % kBK;
        As[k][i] = to_f32(blk[i * kTile + k0 + k]);
      }
#pragma unroll
      for (int j = 0; j < kBK * BN / kThreads; ++j) {
        const int idx = tid + j * kThreads;
        const int k = idx / BN, n = idx % BN;
        const long long xr = xrow0 + k0 + k;
        const int xc = n0 + n;
        Xs[k][n] = (xr < K && xc < N) ? to_f32(X[xr * N + xc]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        float a[kTM], x[TN];
        const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * kTM]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[k][ty * kTM + 4]);
        a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
        a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
        if constexpr (TN >= 4) {
#pragma unroll
          for (int g = 0; g < TN / 4; ++g) {
            const float4 xv = *reinterpret_cast<const float4*>(
                &Xs[k][out_col<BN>(tx, 4 * g)]);
            x[4 * g] = xv.x; x[4 * g + 1] = xv.y;
            x[4 * g + 2] = xv.z; x[4 * g + 3] = xv.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < TN; ++j) x[j] = Xs[k][out_col<BN>(tx, j)];
        }
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], x[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long row = (long long)b * kTile + ty * kTM + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + out_col<BN>(tx, j);
      if (c < N) Y[row * N + c] = acc[i][j];
    }
  }
}

// Launch over nbr block rows: BN = 32 for N <= 32, else 128. Returns
// cudaGetLastError() after the launch.
template <typename T, typename Cols>
int launch_dense_tiles(const void* blocks, Cols cols, int nbr, int rt,
                       const void* X, long long K, int N, void* Y,
                       long long M, cudaStream_t stream) {
  if (nbr <= 0 || N <= 0 || M <= 0) return (int)cudaSuccess;
  const int bn = N <= 32 ? 32 : 128;
  const long long nchunks = (N + bn - 1) / bn;
  const long long grid = (long long)nbr * nchunks;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const T* blk = static_cast<const T*>(blocks);
  const T* x = static_cast<const T*>(X);
  float* y = static_cast<float*>(Y);
  if (bn == 32) {
    dense_tiles_kernel<T, 32, Cols><<<(unsigned)grid, kThreads, 0, stream>>>(
        blk, cols, rt, (int)nchunks, x, K, N, y, M);
  } else {
    dense_tiles_kernel<T, 128, Cols><<<(unsigned)grid, kThreads, 0, stream>>>(
        blk, cols, rt, (int)nchunks, x, K, N, y, M);
  }
  return (int)cudaGetLastError();
}

}  // namespace sps_tiled
