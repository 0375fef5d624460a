// Banded (DIA) SpMV kernels for Hopper (sm_90a), behind a plain C interface.
//
// K1  sps_dia_spmv   replaces spsparse_tpu/ops/pallas_dia.py::_dia_stream_kernel
//                    y[i] = scale * sum_k data[k, i] * x[i + off_k]
// K2  sps_dia_chain  replaces spsparse_tpu/ops/pallas_dia_chain.py::_chain_kernel
//                    y = (scale * A)^T x, T scaled SpMVs with ping-pong iterates
//
// Layout. The operand is row-per-diagonal: data is (K, ld) with row k holding
// A[i, i + off_k] at column i. One thread computes one row; at each diagonal
// the 32 threads of a warp read 32 neighbouring elements of data and of x,
// so every load is coalesced and no shared memory or gather is needed. The
// TPU kernel re-blocked the data into (nblocks, K*block) tiles for its DMA
// engine; that layout has no use here.
//
// Bound. Each SpMV reads nnz * sizeof(data) bytes of diagonals and writes
// 4*n bytes of y; x (4*n bytes) is read K times, but neighbouring rows reuse
// the same lines, so it costs about one pass from memory: the stream is
// nnz * sizeof(data) + 8*n bytes, and the kernel is bound by device memory
// bandwidth, not by arithmetic (2 flops per 4 or 2 bytes). Columns outside
// [0, m) contribute nothing and their data is not read. Accumulation is f32
// for both f32 and bf16 data.
//
// Chain. The TPU kernel kept the iterate in VMEM across iterations inside one
// launch. Here sps_dia_chain issues T launches of the same kernel on the
// caller's stream, swapping two device buffers the caller allocated; at
// n = 2^20 the 4 MB iterate stays in the 50 MB L2 between launches, and the
// host never synchronises inside the chain. A persistent kernel with a
// grid-wide barrier, or a CUDA Graph of the T launches, would remove the
// per-launch gaps; that is later work. The TPU kernel's |offset| <= 128 limit
// came from its fixed VMEM halo and does not apply: columns are bounds-checked.
//
// Offsets travel in the kernel-parameter struct (at most SPS_MAX_DIAGS;
// dia_common.cuh). Every entry point returns cudaGetLastError() after its
// launches.

#include "dia_common.cuh"

namespace {

using sps::DiaOffsets;
using sps::kThreads;
using sps::make_offsets;
using sps::to_f32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dia_spmv_kernel(const T* __restrict__ data, long long ld, long long n,
                    long long m, const DiaOffsets offs,
                    const float* __restrict__ x, float* __restrict__ y,
                    float scale) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int k = 0; k < offs.k; ++k) {
    const long long j = i + offs.off[k];
    if (j >= 0 && j < m) acc += to_f32(data[k * ld + i]) * __ldg(x + j);
  }
  y[i] = acc * scale;
}

// dtype: 0 = float32 data, 1 = bfloat16 data.
cudaError_t launch(int dtype, const void* data, long long ld, long long n,
                   long long m, const DiaOffsets& offs, const float* x,
                   float* y, float scale, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  const unsigned grid = sps::grid_for(n);
  if (dtype == 0) {
    dia_spmv_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(data), ld, n, m, offs, x, y, scale);
  } else if (dtype == 1) {
    dia_spmv_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(data), ld, n, m, offs, x, y, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int sps_dia_max_diags() { return SPS_MAX_DIAGS; }

// K1: y (n) = scale * A x, A (n x m) in DIA form; offsets is a host array of
// K int32 values.
int sps_dia_spmv(int dtype, const void* data, long long ld, long long n,
                 long long m, int K, const void* offsets, const void* x,
                 void* y, float scale, void* stream) {
  DiaOffsets offs;
  if (!make_offsets(K, offsets, &offs)) return (int)cudaErrorInvalidValue;
  return (int)launch(dtype, data, ld, n, m, offs,
                     static_cast<const float*>(x), static_cast<float*>(y),
                     scale, static_cast<cudaStream_t>(stream));
}

// K2: iters scaled SpMVs of a square A (n x n). The input is buf_a; the
// result is in buf_a when iters is even and in buf_b when it is odd.
int sps_dia_chain(int dtype, const void* data, long long ld, long long n,
                  int K, const void* offsets, void* buf_a, void* buf_b,
                  int iters, float scale, void* stream) {
  DiaOffsets offs;
  if (!make_offsets(K, offsets, &offs) || iters < 0)
    return (int)cudaErrorInvalidValue;
  float* a = static_cast<float*>(buf_a);
  float* b = static_cast<float*>(buf_b);
  for (int t = 0; t < iters; ++t) {
    const cudaError_t err =
        launch(dtype, data, ld, n, n, offs, t % 2 == 0 ? a : b,
               t % 2 == 0 ? b : a, scale, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
