// Banded (DIA) SpMV kernels for Hopper (sm_90a), behind a plain C interface.
//
// K1  sps_dia_spmv   replaces spsparse_tpu/ops/pallas_dia.py::_dia_stream_kernel
//                    y[i] = scale * sum_k data[k, i] * x[i + off_k]
// K2  sps_dia_chain  replaces spsparse_tpu/ops/pallas_dia_chain.py::_chain_kernel
//                    y = (scale * A)^T x, T scaled SpMVs with ping-pong iterates
//
// Layout. The operand is row-per-diagonal: data is (K, ld) with row k holding
// A[i, i + off_k] at column i. The TPU kernel re-blocked the data into
// (nblocks, K*block) tiles for its DMA engine; that layout has no use here.
//
// Bound. Each SpMV reads nnz * sizeof(data) bytes of diagonals, x once and
// writes y once: nnz * sizeof(data) + 8*n bytes for 2 flops per slot, so the
// kernel is bound by device memory. At config 2 (2^20 rows, 11 diagonals)
// that is 16.3 us in f32 and 9.4 us in bf16 at 3.35 TB/s.
//
// Design. A thread owns V consecutive rows, V = 4 in f32 and 8 in bf16, so
// that it reads each diagonal's slice with one 16-byte load (float4, or a
// uint4 of eight bf16) and stores y with 16-byte stores; diagonals are
// loaded in batches of kBatch before they are used, so that each thread has
// kBatch * 16 bytes in flight, and x is read per diagonal with __ldg, from
// L1 (a CTA's x window, its rows plus the offsets' span, is reused by all
// its diagonals) or L2. Staging the window in shared memory first lost to
// this at every span measured on an H100, 0.6-3.6 us a call in f32 (PERF.md
// §6). A CTA of kThreads threads owns kThreads * V rows.
//
// A CTA whose columns r0 + min_off .. r1 - 1 + max_off all lie in [0, m)
// tests no bounds; edge CTAs test each (row, diagonal) and, like the plain
// version, add nothing for a column outside [0, m) (its data is not used).
// The 16-byte path needs ld % V == 0, n % V == 0 and 16-byte aligned data
// and y; otherwise the same kernel loads and stores one element at a time
// (the scalar path). Each row sums its diagonals in ascending k with f32
// fused multiply-adds, the order of the first (one row a thread) body, so
// that its bits are the first body's and every call gives the same bits.
//
// sps_dia_spmv_geometry reports the launch (rows a thread, threads, CTAs,
// the 16-byte flag); ops/dia_stream.py::dia_spmv_geometry replays it on the
// host.
//
// Chain. The TPU kernel kept the iterate in VMEM across iterations inside one
// launch. Here sps_dia_chain issues T launches of the same kernel on the
// caller's stream, swapping two device buffers the caller allocated; at
// n = 2^20 the 4 MB iterate stays in the 50 MB L2 between launches, and the
// host never synchronises inside the chain. The TPU kernel's |offset| <= 128
// limit came from its fixed VMEM halo and does not apply.
//
// Offsets travel in the kernel-parameter struct (at most SPS_MAX_DIAGS;
// dia_common.cuh). Every entry point returns cudaGetLastError() after its
// launches.

#include <algorithm>
#include <cstdint>

#include "dia_common.cuh"

namespace {

using sps::DiaOffsets;
using sps::kThreads;
using sps::make_offsets;

// Diagonals a thread loads before it uses them.
constexpr int kBatch = 4;

template <typename T>
struct Rows;
template <>
struct Rows<float> {
  static constexpr int V = 4;
};
template <>
struct Rows<__nv_bfloat16> {
  static constexpr int V = 8;
};

struct Geometry {
  int rows;  // rows a thread
  long long ctas;
  bool vector;  // 16-byte loads of data, stores of y
  int min_off, max_off;
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// y_aligned: every y the launch writes is 16-byte aligned.
Geometry geometry(int dtype, long long ld, long long n, const DiaOffsets& offs,
                  const void* data, bool y_aligned) {
  Geometry g{};
  g.rows = dtype == 0 ? Rows<float>::V : Rows<__nv_bfloat16>::V;
  const long long tile = (long long)kThreads * g.rows;
  g.ctas = (n + tile - 1) / tile;
  g.vector = ld % g.rows == 0 && n % g.rows == 0 && aligned16(data) &&
             y_aligned;
  for (int k = 0; k < offs.k; ++k) {
    g.min_off = k ? std::min(g.min_off, offs.off[k]) : offs.off[k];
    g.max_off = k ? std::max(g.max_off, offs.off[k]) : offs.off[k];
  }
  return g;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// A thread's V values of one diagonal, raw: V * sizeof(T) / 16 16-byte
// loads (kVector), or one load an element.
template <typename T, int V, bool kVector>
struct Slice;

template <int V, bool kVector>
struct Slice<float, V, kVector> {
  float v[V];
  __device__ __forceinline__ void load(const float* p, long long left) {
    if (kVector) {
#pragma unroll
      for (int i = 0; i < V; i += 4) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(p + i));
        v[i] = f.x, v[i + 1] = f.y, v[i + 2] = f.z, v[i + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = i < left ? __ldg(p + i) : 0.f;
    }
  }
  __device__ __forceinline__ float get(int i) const { return v[i]; }
};

template <int V, bool kVector>
struct Slice<__nv_bfloat16, V, kVector> {
  uint32_t w[V / 2];  // two bf16 a word, the lower first
  __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                       long long left) {
    if (kVector) {
#pragma unroll
      for (int i = 0; i < V / 2; i += 4) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(p + 2 * i));
        w[i] = u.x, w[i + 1] = u.y, w[i + 2] = u.z, w[i + 3] = u.w;
      }
    } else {
      const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
      for (int i = 0; i < V / 2; ++i) {
        const uint32_t lo = 2 * i < left ? __ldg(h + 2 * i) : 0u;
        const uint32_t hi = 2 * i + 1 < left ? __ldg(h + 2 * i + 1) : 0u;
        w[i] = lo | hi << 16;
      }
    }
  }
  __device__ __forceinline__ float get(int i) const {
    return i & 1 ? bf16_hi(w[i >> 1]) : bf16_lo(w[i >> 1]);
  }
};

template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
    dia_spmv_kernel(const T* __restrict__ data, long long ld, long long n,
                    long long m, const DiaOffsets offs, int min_off,
                    int max_off, const float* __restrict__ x,
                    float* __restrict__ y, float scale) {
  constexpr int V = Rows<T>::V;
  constexpr long long kTile = (long long)kThreads * V;
  const long long r0 = (long long)blockIdx.x * kTile;
  const long long r1 = r0 + kTile < n ? r0 + kTile : n;
  const long long row = r0 + (long long)threadIdx.x * V;
  if (row >= n) return;
  const bool interior = r0 + min_off >= 0 && r1 - 1 + max_off < m;
  const long long left = n - row;
  const int K = offs.k;
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kBatch) {
    Slice<T, V, kVector> d[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (k0 + b < K) d[b].load(data + (long long)(k0 + b) * ld + row, left);
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (k0 + b >= K) break;
      const int off = offs.off[k0 + b];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const long long j = row + v + off;
        if (interior || (j >= 0 && j < m))
          acc[v] = fmaf(d[b].get(v), __ldg(x + j), acc[v]);
      }
    }
  }
  if (kVector) {
#pragma unroll
    for (int v = 0; v < V; v += 4)
      *reinterpret_cast<float4*>(y + row + v) =
          make_float4(acc[v] * scale, acc[v + 1] * scale, acc[v + 2] * scale,
                      acc[v + 3] * scale);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (v < left) y[row + v] = acc[v] * scale;
  }
}

template <typename T>
cudaError_t launch_typed(const Geometry& g, const void* data, long long ld,
                         long long n, long long m, const DiaOffsets& offs,
                         const float* x, float* y, float scale,
                         cudaStream_t stream) {
  const T* d = static_cast<const T*>(data);
  if (g.vector)
    dia_spmv_kernel<T, true><<<(unsigned)g.ctas, kThreads, 0, stream>>>(
        d, ld, n, m, offs, g.min_off, g.max_off, x, y, scale);
  else
    dia_spmv_kernel<T, false><<<(unsigned)g.ctas, kThreads, 0, stream>>>(
        d, ld, n, m, offs, g.min_off, g.max_off, x, y, scale);
  return cudaGetLastError();
}

// dtype: 0 = float32 data, 1 = bfloat16 data.
cudaError_t launch(int dtype, const Geometry& g, const void* data,
                   long long ld, long long n, long long m,
                   const DiaOffsets& offs, const float* x, float* y,
                   float scale, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  if (g.ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_typed<float>(g, data, ld, n, m, offs, x, y, scale, stream);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(g, data, ld, n, m, offs, x, y, scale,
                                       stream);
  return cudaErrorInvalidValue;
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
  if (!make_offsets(K, offsets, &offs) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(dtype, ld, n, offs, data, aligned16(y));
  return (int)launch(dtype, g, data, ld, n, m, offs,
                     static_cast<const float*>(x), static_cast<float*>(y),
                     scale, static_cast<cudaStream_t>(stream));
}

// K1's launch for these arguments: out[0..3] = rows a thread, threads,
// CTAs, 16-byte path (1) or scalar (0).
int sps_dia_spmv_geometry(int dtype, long long ld, long long n, int K,
                          const void* offsets, const void* data,
                          const void* y, void* out) {
  DiaOffsets offs;
  if (!make_offsets(K, offsets, &offs) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(dtype, ld, n, offs, data, aligned16(y));
  long long* o = static_cast<long long*>(out);
  o[0] = g.rows;
  o[1] = kThreads;
  o[2] = g.ctas;
  o[3] = g.vector;
  return (int)cudaSuccess;
}

// K2: iters scaled SpMVs of a square A (n x n). The input is buf_a; the
// result is in buf_a when iters is even and in buf_b when it is odd.
int sps_dia_chain(int dtype, const void* data, long long ld, long long n,
                  int K, const void* offsets, void* buf_a, void* buf_b,
                  int iters, float scale, void* stream) {
  DiaOffsets offs;
  if (!make_offsets(K, offsets, &offs) || iters < 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  float* a = static_cast<float*>(buf_a);
  float* b = static_cast<float*>(buf_b);
  const Geometry g =
      geometry(dtype, ld, n, offs, data, aligned16(a) && aligned16(b));
  for (int t = 0; t < iters; ++t) {
    const cudaError_t err =
        launch(dtype, g, data, ld, n, n, offs, t % 2 == 0 ? a : b,
               t % 2 == 0 ? b : a, scale, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
