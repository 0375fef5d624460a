// Shuffle-layout gather products for Hopper (sm_90a), behind a plain C
// interface.
//
// K11  sps_shuffle_gather  replaces spsparse_tpu/ops/spmv_shuffle.py::
//                          _gather_kernel, fused with the static shuffle that
//                          follows it there (spmv_shuffle.py:240-255)
//     out[s] = vals[s] * x[cols[s]]   for each ELL slot s with cols[s] >= 0
//     out[s] = 0                      for each filler slot (cols[s] < 0)
//
// The TPU has no fast gather, so the JAX package gathers x inside 8-row
// slabs of x.reshape(-1, 128) (a lane gather Mosaic lowers), writes the
// products in column-block order, and then sorts (dest, p) with the filler
// slots' zeros appended to bring them into ELL-slot order. dest is unique,
// padding slots carry sentinels >= n_slots, and the fillers cover exactly
// the ELL slots no entry takes; so the first n_slots elements of that sort
// are "p written to slot dest, every other slot 0".
//
// Hopper has a fast gather, so the layout is kept in slot order instead
// (prepare_shuffle_spmv's ell_cols / ell_vals: each slot's global column,
// -1 on fillers, and its value): one coalesced pass writes the slot grid in
// order. Each thread takes 4 consecutive slots: one 16-byte load of
// columns (two for int64 columns), one of values, 4 gathers of x, one
// 16-byte store. A filler writes an exact 0 and never computes 0 * x, so an
// inf in x cannot reach it. Every slot is written once, so the output needs
// no memset (tested against a NaN-filled allocation); each product is one
// float32 multiply, so the grid is bit for bit the plain version's sort
// pipeline. A tail of n_slots % 4 slots runs one slot a thread.
//
// Bound. The layout is read once (4 or 8 bytes of column and 4 of value a
// slot), each slot written once (4 bytes), x gathered once a slot from the
// 50 MB L2 (its 4 MB at bench config 2c stay there: the layout streams
// through with the evict-first hint, __ldcs / __stcs): device memory
// bandwidth, one multiply a slot.
//
// PR 5's design, kept as the timing yardstick of this one (chip_smoke.py
// times both in one run; nothing in the port calls it):
// sps_shuffle_gather_scatter stores each gather slot's product straight to
// its ELL slot dest[t] and writes the fillers' zeros, over the column-block
// ordered gather batches (octet, idx, vals, dest, filler_dest).
//
// The entry points return cudaGetLastError() after their launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlab = 8 * 128;   // gather slots of one batch

__device__ __forceinline__ void load_cols4(const int* cols, long long q,
                                           long long (&c)[4]) {
  const int4 v = __ldcs(reinterpret_cast<const int4*>(cols) + q);
  c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
}

__device__ __forceinline__ void load_cols4(const long long* cols,
                                           long long q, long long (&c)[4]) {
  const longlong2* p = reinterpret_cast<const longlong2*>(cols) + 2 * q;
  const longlong2 a = __ldcs(p), b = __ldcs(p + 1);
  c[0] = a.x; c[1] = a.y; c[2] = b.x; c[3] = b.y;
}

__device__ __forceinline__ float slot_product(long long c, float v,
                                              const float* __restrict__ x,
                                              long long ncols) {
  return (c < 0 || c >= ncols) ? 0.f : __fmul_rn(v, __ldg(x + c));
}

template <typename C>
__global__ void __launch_bounds__(kThreads)
    slot_gather_kernel(const C* __restrict__ cols,
                       const float* __restrict__ vals,
                       const float* __restrict__ x, long long ncols,
                       long long n_slots, float* __restrict__ out) {
  const long long n4 = n_slots / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long q = t0; q < n4; q += stride) {
    long long c[4];
    load_cols4(cols, q, c);
    const float4 v = __ldcs(reinterpret_cast<const float4*>(vals) + q);
    float4 o;
    o.x = slot_product(c[0], v.x, x, ncols);
    o.y = slot_product(c[1], v.y, x, ncols);
    o.z = slot_product(c[2], v.z, x, ncols);
    o.w = slot_product(c[3], v.w, x, ncols);
    __stcs(reinterpret_cast<float4*>(out) + q, o);
  }
  for (long long s = 4 * n4 + t0; s < n_slots; s += stride)
    out[s] = slot_product((long long)cols[s], vals[s], x, ncols);
}

template <typename C>
cudaError_t launch(const void* cols, const void* vals, const void* x,
                   long long ncols, long long n_slots, void* out,
                   cudaStream_t stream) {
  if (n_slots == 0) return cudaSuccess;
  long long blocks = (n_slots / 4 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;   // grid-stride beyond
  slot_gather_kernel<C><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const C*>(cols), static_cast<const float*>(vals),
      static_cast<const float*>(x), ncols, n_slots, static_cast<float*>(out));
  return cudaGetLastError();
}

// PR 5's scatter design (the yardstick above).
template <typename D>
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(const int* __restrict__ octet, const int* __restrict__ idx,
                   const float* __restrict__ vals, const D* __restrict__ dest,
                   const D* __restrict__ filler, long long n_gather,
                   long long n_filler, const float* __restrict__ x,
                   long long ncols, long long n_slots,
                   float* __restrict__ out) {
  const long long total = n_gather + n_filler;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    if (t < n_gather) {
      const long long d = (long long)__ldg(dest + t);
      if (d < 0 || d >= n_slots) continue;   // a padding slot: dropped
      const long long b = t / kSlab;
      const int s = (int)((t / 128) % 8);
      const long long col =
          ((long long)__ldg(octet + b) * 8 + s) * 128 + __ldg(idx + t);
      const float g = col < ncols ? __ldg(x + col) : 0.f;
      out[d] = __fmul_rn(__ldg(vals + t), g);
    } else {
      const long long f = (long long)__ldg(filler + (t - n_gather));
      if (f >= 0 && f < n_slots) out[f] = 0.f;
    }
  }
}

template <typename D>
cudaError_t launch_scatter(const void* octet, const void* idx,
                           const void* vals, const void* dest,
                           const void* filler, long long n_gather,
                           long long n_filler, const void* x, long long ncols,
                           long long n_slots, void* out,
                           cudaStream_t stream) {
  const long long total = n_gather + n_filler;
  if (total == 0) return cudaSuccess;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  scatter_kernel<D><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const int*>(octet), static_cast<const int*>(idx),
      static_cast<const float*>(vals), static_cast<const D*>(dest),
      static_cast<const D*>(filler), n_gather, n_filler,
      static_cast<const float*>(x), ncols, n_slots,
      static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K11: out (n_slots, float32) = the ELL slot grid of the shuffle layout.
// cols (n_slots,) int32 (cols64 = 0) or int64 (cols64 = 1), -1 on fillers;
// vals (n_slots,) float32; x (ncols,) float32. cols, vals and out 16-byte
// aligned.
int sps_shuffle_gather(int cols64, const void* cols, const void* vals,
                       const void* x, long long ncols, long long n_slots,
                       void* out, void* stream) {
  if (n_slots < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cols64 == 0)
    return (int)launch<int>(cols, vals, x, ncols, n_slots, out, s);
  if (cols64 == 1)
    return (int)launch<long long>(cols, vals, x, ncols, n_slots, out, s);
  return (int)cudaErrorInvalidValue;
}

// PR 5's K11 (timing yardstick): octet (B,) int32; idx (B*1024,) int32;
// vals (B*1024,) float32; dest (B*1024,) and filler (n_filler,) int32
// (dest64 = 0) or int64 (dest64 = 1); x (ncols,) float32.
int sps_shuffle_gather_scatter(int dest64, const void* octet, const void* idx,
                               const void* vals, const void* dest,
                               const void* filler, long long n_batches,
                               long long n_filler, const void* x,
                               long long ncols, long long n_slots, void* out,
                               void* stream) {
  if (n_batches < 0 || n_filler < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_gather = n_batches * kSlab;
  if (dest64 == 0)
    return (int)launch_scatter<int>(octet, idx, vals, dest, filler, n_gather,
                                    n_filler, x, ncols, n_slots, out, s);
  if (dest64 == 1)
    return (int)launch_scatter<long long>(octet, idx, vals, dest, filler,
                                          n_gather, n_filler, x, ncols,
                                          n_slots, out, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
