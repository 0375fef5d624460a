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
// K6: what bounds it, and the design. Each live block costs 2*128*128*N
// operations against 64 KB (float32) or 32 KB (bfloat16) of block bytes, so
// at N = 128 float32 blocks are bound by the card's float32 rate (the
// tensor cores are not used: the JAX kernel's HIGHEST precision asks for
// true float32, which TF32 is not) and bfloat16 blocks, on the tensor-core
// rate, by memory. This first kernel runs both on the SIMT float32 units:
// a register-blocked tile product (tiled_common.cuh) with no TPU DMA
// machinery. The TPU kernel double-buffered per-tile X DMAs and skipped the
// DMA of padding slots; here a padding slot reads neither block nor X, and
// the X tiles that neighbouring block rows share come from the 50 MB L2.
// The TPU kernel's 32 MiB VMEM guard is gone: a block row streams through
// shared memory 16 columns of k at a time, at any number of slots. X is
// bounds-checked, not padded to (nbc*128, Np).
//
// K7: what bounds it, and the design. The TPU kernel built one-hot
// matrices in VMEM and used the matrix unit to gather and scatter; here no
// one-hot is built. One CTA of 64 threads owns one block row and 64 output
// columns, with the 128 x 64 float32 Y tile in shared memory; each thread
// owns one output column. For each live tile the CTA stages the entries
// (row, column, value) 256 at a time in shared memory, dropping value-0
// slots (the padding, at offset (0,0), which adds nothing for finite X),
// and then every thread walks them in order doing
//     Ysh[row_e][n] += val_e * X[tc*128 + col_e][n].
// X reads are coalesced across the threads (one X row, neighbouring
// columns); no atomics, and a fixed order, so results repeat from run to
// run. The least traffic is the live tiles' payload (12 bytes a slot), the
// X tile of each live tile and Y once; the 2*N operations per entry are
// far below the float32 rate, so the kernel is bound by memory and, in this
// first form, by the latency of the X reads (four in flight per thread).

#include "tiled_common.cuh"

namespace {

using sps_tiled::kTile;

constexpr int kOneHotCols = 64;  // output columns (= threads) per CTA
constexpr int kChunk = 256;      // entries staged per step
constexpr int kPerThread = kChunk / kOneHotCols;

__global__ void __launch_bounds__(kOneHotCols)
    onehot_kernel(const int* __restrict__ tcols, const int* __restrict__ rows,
                  const int* __restrict__ cols,
                  const float* __restrict__ vals, int rt, int cap, int nbc,
                  int nchunks, const float* __restrict__ X, long long K,
                  int N, float* __restrict__ Y, long long M) {
  __shared__ float Ysh[kTile][kOneHotCols];
  __shared__ int er[kChunk];
  __shared__ int ec[kChunk];
  __shared__ float ev[kChunk];
  __shared__ int warp_count[kOneHotCols / 32];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int b = blockIdx.x / nchunks;
  const int n = (blockIdx.x % nchunks) * kOneHotCols + tid;
  const bool col_ok = n < N;

  for (int i = 0; i < kTile; ++i) Ysh[i][tid] = 0.f;

  for (int t = 0; t < rt; ++t) {
    const int tc = tcols[(long long)b * rt + t];
    if (tc >= nbc) continue;  // padding slot: no payload, no X tile
    const long long base = ((long long)b * rt + t) * cap;
    const float* xt = X + (long long)tc * kTile * N;
    const long long xrows = K - (long long)tc * kTile;  // rows of X in tile
    for (int e0 = 0; e0 < cap; e0 += kChunk) {
      // Stage this thread's kPerThread neighbouring entries, keep the
      // nonzero ones, and compact them in entry order.
      int r[kPerThread], c[kPerThread];
      float v[kPerThread];
      int cnt = 0;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int e = e0 + tid * kPerThread + j;
        v[j] = e < cap ? vals[base + e] : 0.f;
        r[j] = v[j] != 0.f ? rows[base + e] : 0;
        c[j] = v[j] != 0.f ? cols[base + e] : 0;
        cnt += v[j] != 0.f;
      }
      int incl = cnt;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const int up = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += up;
      }
      __syncthreads();  // the previous chunk has been consumed
      if (lane == 31) warp_count[warp] = incl;
      __syncthreads();
      int pos = incl - cnt;
      for (int w = 0; w < warp; ++w) pos += warp_count[w];
      int total = 0;
#pragma unroll
      for (int w = 0; w < kOneHotCols / 32; ++w) total += warp_count[w];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        if (v[j] != 0.f) {
          er[pos] = r[j];
          ec[pos] = c[j];
          ev[pos] = v[j];
          ++pos;
        }
      }
      __syncthreads();
      if (!col_ok) continue;
      int e = 0;
      for (; e + 4 <= total; e += 4) {
        float x[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cc = ec[e + j];
          x[j] = cc < xrows ? __ldg(xt + (long long)cc * N + n) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* y = &Ysh[er[e + j]][tid];
          *y = fmaf(ev[e + j], x[j], *y);
        }
      }
      for (; e < total; ++e) {
        const int cc = ec[e];
        const float x = cc < xrows ? __ldg(xt + (long long)cc * N + n) : 0.f;
        float* y = &Ysh[er[e]][tid];
        *y = fmaf(ev[e], x, *y);
      }
    }
  }
  if (!col_ok) return;
  for (int i = 0; i < kTile; ++i) {
    const long long row = (long long)b * kTile + i;
    if (row < M) Y[row * N + n] = Ysh[i][tid];
  }
}

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
    return sps_tiled::launch_dense_tiles<float>(blocks, cols, nbr, rt, X, K,
                                                N, Y, M, s);
  if (dtype == 1)
    return sps_tiled::launch_dense_tiles<__nv_bfloat16>(blocks, cols, nbr,
                                                        rt, X, K, N, Y, M, s);
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
  const long long nchunks = (N + kOneHotCols - 1) / kOneHotCols;
  const long long grid = (long long)nbr * nchunks;
  if (grid > 0x7fffffffLL || cap < 0) return (int)cudaErrorInvalidValue;
  onehot_kernel<<<(unsigned)grid, kOneHotCols, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tcols), static_cast<const int*>(rows),
      static_cast<const int*>(cols), static_cast<const float*>(vals), rt, cap,
      nbc, (int)nchunks, static_cast<const float*>(X), K, N,
      static_cast<float*>(Y), M);
  return (int)cudaGetLastError();
}

}  // extern "C"
