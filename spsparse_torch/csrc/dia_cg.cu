// Conjugate gradients on a banded (DIA) operator for Hopper (sm_90a), behind
// a plain C interface.
//
// K4  sps_dia_cg   replaces spsparse_tpu/ops/pallas_cg.py::_cg_kernel
//                  iters CG iterations on (A + shift I) x = b, A square DIA
//
// The iteration is the TPU kernel's, step for step:
//   x = 0, r = p = b, rs = b.b, beta = 0; then each iteration
//   p = r + beta p;  Ap = (A + shift I) p;  pap = p.Ap;
//   alpha = rs / (pap == 0 ? 1 : pap);  x += alpha p;  r -= alpha Ap;
//   rsnew = r.r;  beta = rsnew / (rs == 0 ? 1 : rs);  rs = rsnew.
// Both guards are kept, so b = 0 gives x = 0 and rs = 0 with no NaN.
//
// What bounds it. Per iteration the diagonals must be read once
// (nnz * sizeof(data) bytes); p, r and Ap are intermediates and x and b are
// read or written once per solve. The work is 2 flops per diagonal element,
// so the least time is set by device memory bandwidth.
//
// Design. The TPU kernel ran one grid step that walked all row blocks in
// order, kept p, r and Ap in VMEM and the scalars in SMEM. On Hopper blocks
// run in no order, every iteration has two global reductions (p.Ap and r.r),
// and p must be complete across the grid before the SpMV reads neighbouring
// rows. This first version issues all iterations from one C call on the
// caller's stream, two launches an iteration, with no host synchronisation:
//   pass A: p_out = r + beta p_in and Ap = (A + shift I) p_out, the p-update
//           fused into the SpMV (a neighbour's p_out[j] is recomputed from
//           r[j] and p_in[j] with the same fma, so it is bitwise the value
//           row j stores; p ping-pongs between two buffers), plus the
//           block's partial of p.Ap;
//   pass B: x += alpha p; r -= alpha Ap, plus the block's partial of r.r.
// The scalars (rs, alpha, beta) live in a device array. Each pass ends with
// the last-block-done pattern: every block writes its partial, fences and
// takes a ticket; the block that takes the last ticket sums the partials in
// a fixed order and updates the scalars. The result is the same from run to
// run (no float atomics). The caller allocates every buffer; the kernels
// allocate nothing. A persistent kernel with a grid-wide barrier or a CUDA
// Graph of the launches would remove the per-launch gaps (later work).
//
// The TPU kernel's VMEM_BUDGET guard and its |offset| <= 128 limit came
// from VMEM and its fixed halo; neither applies here (columns are
// bounds-checked and the vectors live in device memory).

#include "dia_common.cuh"

namespace {

using sps::DiaOffsets;
using sps::kThreads;
using sps::to_f32;

enum { kRS = 0, kAlpha = 1, kBeta = 2 };

// Sum over the block; the result is valid in thread 0. The leading barrier
// makes the shared scratch safe to reuse between calls.
__device__ __forceinline__ float block_sum(float v, float* smem) {
  __syncthreads();
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (kThreads >> 5) ? smem[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// Stores the block's partial and reports, to every thread of the block,
// whether this block arrived last (then all partials are visible).
__device__ __forceinline__ bool arrive(float total, float* partial,
                                       unsigned* counter) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = total;
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  return last;
}

// Sum of all blocks' partials in a fixed order; valid in thread 0.
__device__ __forceinline__ float sum_partials(const float* partial,
                                              float* smem) {
  float v = 0.f;
  for (unsigned q = threadIdx.x; q < gridDim.x; q += blockDim.x)
    v += __ldcg(partial + q);
  return block_sum(v, smem);
}

__global__ void __launch_bounds__(kThreads)
    cg_init(long long n, const float* __restrict__ b, float* __restrict__ x,
            float* __restrict__ r, float* __restrict__ p, float* partial,
            unsigned* counter, float* scal) {
  __shared__ float smem[kThreads / 32];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.f;
  if (i < n) {
    const float bi = b[i];
    x[i] = 0.f;
    r[i] = bi;
    p[i] = 0.f;
    v = bi * bi;
  }
  const float total = block_sum(v, smem);
  if (arrive(total, partial, counter)) {
    const float rs = sum_partials(partial, smem);
    if (threadIdx.x == 0) {
      scal[kRS] = rs;
      scal[kAlpha] = 0.f;
      scal[kBeta] = 0.f;
      *counter = 0u;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cg_pass_a(const T* __restrict__ data, long long ld, long long n,
              const DiaOffsets offs, float shift, const float* __restrict__ r,
              const float* __restrict__ p_in, float* __restrict__ p_out,
              float* __restrict__ ap, float* partial, unsigned* counter,
              float* scal) {
  __shared__ float smem[kThreads / 32];
  const float beta = scal[kBeta];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.f;
  if (i < n) {
    const float pi = fmaf(beta, p_in[i], r[i]);
    float acc = 0.f;
    for (int k = 0; k < offs.k; ++k) {
      const long long j = i + offs.off[k];
      if (j >= 0 && j < n) {
        const float pj = fmaf(beta, __ldg(p_in + j), __ldg(r + j));
        acc = fmaf(to_f32(data[k * ld + i]), pj, acc);
      }
    }
    acc = fmaf(shift, pi, acc);
    p_out[i] = pi;
    ap[i] = acc;
    v = pi * acc;
  }
  const float total = block_sum(v, smem);
  if (arrive(total, partial, counter)) {
    const float pap = sum_partials(partial, smem);
    if (threadIdx.x == 0) {
      scal[kAlpha] = scal[kRS] / (pap == 0.f ? 1.f : pap);
      *counter = 0u;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    cg_pass_b(long long n, float* __restrict__ x, float* __restrict__ r,
              const float* __restrict__ p, const float* __restrict__ ap,
              float* partial, unsigned* counter, float* scal) {
  __shared__ float smem[kThreads / 32];
  const float alpha = scal[kAlpha];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.f;
  if (i < n) {
    x[i] = fmaf(alpha, p[i], x[i]);
    const float rn = fmaf(-alpha, ap[i], r[i]);
    r[i] = rn;
    v = rn * rn;
  }
  const float total = block_sum(v, smem);
  if (arrive(total, partial, counter)) {
    const float rsnew = sum_partials(partial, smem);
    if (threadIdx.x == 0) {
      const float rs = scal[kRS];
      scal[kBeta] = rsnew / (rs == 0.f ? 1.f : rs);
      scal[kRS] = rsnew;
      *counter = 0u;
    }
  }
}

template <typename T>
cudaError_t run(const void* data, long long ld, long long n,
                const DiaOffsets& offs, float shift, const float* b, float* x,
                float* r, float* p_a, float* p_b, float* ap, float* partial,
                unsigned* counter, float* scal, int iters,
                cudaStream_t stream) {
  const unsigned grid = sps::grid_for(n);
  const T* d = static_cast<const T*>(data);
  cg_init<<<grid, kThreads, 0, stream>>>(n, b, x, r, p_a, partial, counter,
                                         scal);
  cudaError_t err = cudaGetLastError();
  for (int t = 0; t < iters && err == cudaSuccess; ++t) {
    float* p_in = t % 2 == 0 ? p_a : p_b;
    float* p_out = t % 2 == 0 ? p_b : p_a;
    cg_pass_a<T><<<grid, kThreads, 0, stream>>>(
        d, ld, n, offs, shift, r, p_in, p_out, ap, partial, counter, scal);
    cg_pass_b<<<grid, kThreads, 0, stream>>>(n, x, r, p_out, ap, partial,
                                              counter, scal);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

extern "C" {

// K4: iters CG iterations on (A + shift I) x = b for a square A (n x n) in
// DIA form. dtype: 0 = float32 data, 1 = bfloat16 data. b, x, r, p_a, p_b
// and ap hold n floats; partial holds nparts >= ceil(n / 256) floats (one
// per block of a launch);
// counter is one unsigned int that must be 0 on entry (it is 0 again on
// exit); scal holds 3 floats and ends as (rs, alpha, beta).
int sps_dia_cg(int dtype, const void* data, long long ld, long long n, int K,
               const void* offsets, float shift, const void* b, void* x,
               void* r, void* p_a, void* p_b, void* ap, void* partial,
               long long nparts, void* counter, void* scal, int iters,
               void* stream) {
  DiaOffsets offs;
  if (!sps::make_offsets(K, offsets, &offs) || iters < 0 || n <= 0 ||
      nparts < (long long)sps::grid_for(n))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bb = static_cast<const float*>(b);
  float* xx = static_cast<float*>(x);
  float* rr = static_cast<float*>(r);
  float* pa = static_cast<float*>(p_a);
  float* pb = static_cast<float*>(p_b);
  float* aa = static_cast<float*>(ap);
  float* pp = static_cast<float*>(partial);
  unsigned* cc = static_cast<unsigned*>(counter);
  float* sc = static_cast<float*>(scal);
  cudaError_t err;
  if (dtype == 0) {
    err = run<float>(data, ld, n, offs, shift, bb, xx, rr, pa, pb, aa, pp, cc,
                     sc, iters, s);
  } else if (dtype == 1) {
    err = run<__nv_bfloat16>(data, ld, n, offs, shift, bb, xx, rr, pa, pb, aa,
                             pp, cc, sc, iters, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
