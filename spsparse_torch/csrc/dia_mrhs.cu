// Multi-RHS banded (DIA) SpMM for Hopper (sm_90a), behind a plain C
// interface.
//
// K3  sps_dia_mrhs   replaces spsparse_tpu/ops/pallas_dia_mrhs.py::_mrhs_kernel
//                    Y[r, i] = sum_k data[k, i] * X[r, i + off_k],  r < R <= 8
//
// What bounds it. The point of the kernel is that the diagonals, the largest
// stream, are read once for all R right-hand sides. The least traffic is
// nnz * sizeof(data) bytes of diagonals plus R*m*4 of X and R*n*4 of Y:
// 2 flops per data element per right-hand side is far below the card's
// operations-per-byte balance, so the kernel is bound by device memory
// bandwidth (3.35 TB/s on an H100 SXM).
//
// Design. The TPU kernel rode X on the 8 sublanes, pre-gathered halo strips
// per block and assembled the overlapped window in VMEM. None of that is
// needed here. The operand keeps K1's row-per-diagonal layout (K, n) and X is
// (R, m) row-contiguous. One thread computes one row i for all R right-hand
// sides: it loads data[k, i] once per diagonal and applies it to R
// accumulators held in registers (R is a template parameter, 1..8). At each
// diagonal the 32 threads of a warp read 32 neighbouring elements of the
// diagonal and of each row of X, so every load is coalesced; neighbouring
// diagonals re-read the same lines of X from L1/L2, so X costs about one pass
// from memory. Columns outside [0, m) contribute nothing and are not read,
// so no padded copy of X is built (the TPU's padded entry and its zero-copy
// entry are one entry here). f32 or bf16 data, f32 X, Y and accumulation.

#include "dia_common.cuh"

namespace {

using sps::DiaOffsets;
using sps::kThreads;
using sps::to_f32;

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    dia_mrhs_kernel(const T* __restrict__ data, long long ld, long long n,
                    long long m, const DiaOffsets offs,
                    const float* __restrict__ X, long long ldx,
                    float* __restrict__ Y, long long ldy) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  for (int k = 0; k < offs.k; ++k) {
    const long long j = i + offs.off[k];
    if (j >= 0 && j < m) {
      const float d = to_f32(data[k * ld + i]);
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r] = fmaf(d, __ldg(X + r * ldx + j), acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) Y[r * ldy + i] = acc[r];
}

template <typename T, int R>
void launch_r(const void* data, long long ld, long long n, long long m,
              const DiaOffsets& offs, const float* X, long long ldx, float* Y,
              long long ldy, cudaStream_t stream) {
  dia_mrhs_kernel<T, R><<<sps::grid_for(n), kThreads, 0, stream>>>(
      static_cast<const T*>(data), ld, n, m, offs, X, ldx, Y, ldy);
}

template <typename T>
bool launch_t(int R, const void* data, long long ld, long long n, long long m,
              const DiaOffsets& offs, const float* X, long long ldx, float* Y,
              long long ldy, cudaStream_t stream) {
  switch (R) {
    case 1: launch_r<T, 1>(data, ld, n, m, offs, X, ldx, Y, ldy, stream); break;
    case 2: launch_r<T, 2>(data, ld, n, m, offs, X, ldx, Y, ldy, stream); break;
    case 3: launch_r<T, 3>(data, ld, n, m, offs, X, ldx, Y, ldy, stream); break;
    case 4: launch_r<T, 4>(data, ld, n, m, offs, X, ldx, Y, ldy, stream); break;
    case 5: launch_r<T, 5>(data, ld, n, m, offs, X, ldx, Y, ldy, stream); break;
    case 6: launch_r<T, 6>(data, ld, n, m, offs, X, ldx, Y, ldy, stream); break;
    case 7: launch_r<T, 7>(data, ld, n, m, offs, X, ldx, Y, ldy, stream); break;
    case 8: launch_r<T, 8>(data, ld, n, m, offs, X, ldx, Y, ldy, stream); break;
    default: return false;
  }
  return true;
}

}  // namespace

extern "C" {

// K3: Y (R x n, row stride ldy) = (A X^T)^T for A (n x m) in DIA form and
// X (R x m, row stride ldx), 1 <= R <= 8. dtype: 0 = float32 data,
// 1 = bfloat16 data. offsets is a host array of K int32 values.
int sps_dia_mrhs(int dtype, const void* data, long long ld, long long n,
                 long long m, int K, const void* offsets, int R,
                 const void* X, long long ldx, void* Y, long long ldy,
                 void* stream) {
  DiaOffsets offs;
  if (!sps::make_offsets(K, offsets, &offs) || R < 1 || R > 8)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const float* x = static_cast<const float*>(X);
  float* y = static_cast<float*>(Y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok;
  if (dtype == 0) {
    ok = launch_t<float>(R, data, ld, n, m, offs, x, ldx, y, ldy, s);
  } else if (dtype == 1) {
    ok = launch_t<__nv_bfloat16>(R, data, ld, n, m, offs, x, ldx, y, ldy, s);
  } else {
    ok = false;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
