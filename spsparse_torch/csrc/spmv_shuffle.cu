// Shuffle-layout gather products for Hopper (sm_90a), behind a plain C
// interface.
//
// K11  sps_shuffle_gather  replaces spsparse_tpu/ops/spmv_shuffle.py::
//                          _gather_kernel, fused with the static shuffle that
//                          follows it there (spmv_shuffle.py:240-255)
//     p[b, s, l]   = vals[b, s, l] * x[(8 * octet[b] + s) * 128 + idx[b, s, l]]
//     out[dest[t]] = p[t]     for each gather slot t with dest[t] < n_slots
//     out[f]       = 0        for each f in filler_dest
//
// The TPU has no fast gather, so the JAX package gathers x inside 8-row
// slabs of x.reshape(-1, 128) (a lane gather Mosaic lowers), writes the
// products in column-block order, and then sorts (dest, p) with the filler
// slots' zeros appended to bring them into ELL-slot order. dest is unique,
// padding slots carry sentinels >= n_slots, and the fillers cover exactly
// the ELL slots no entry takes; so the first n_slots elements of that sort
// are "p written to slot dest, every other slot 0". On Hopper a scattered
// 4-byte store is cheap: each thread computes one product and stores it
// straight to its ELL slot, and the threads past the gather slots write the
// fillers' zeros. The sort is gone, and every slot of `out` is written
// exactly once, so the output needs no memset (tested against a NaN-filled
// allocation). Each product is one float32 multiply, so the slot grid is
// bit for bit the plain version's sort pipeline.
//
// Bound. The layout is read once (idx, vals, dest: 12 or 16 bytes a gather
// slot; octet; the fillers' 4 or 8 bytes), x once (its 4 MB at bench
// config 2c stay in the 50 MB L2, so the gathers hit L2), and each ELL slot
// written once: device memory bandwidth, one multiply a slot. The stores
// to `out` scatter within each row's 16 slots; neighbouring rows' slots sit
// in the same lines, so L2 merges most of them.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlab = 8 * 128;   // gather slots of one batch

template <typename D>
__global__ void __launch_bounds__(kThreads)
    shuffle_gather_kernel(const int* __restrict__ octet,
                          const int* __restrict__ idx,
                          const float* __restrict__ vals,
                          const D* __restrict__ dest,
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
cudaError_t launch(const void* octet, const void* idx, const void* vals,
                   const void* dest, const void* filler, long long n_gather,
                   long long n_filler, const void* x, long long ncols,
                   long long n_slots, void* out, cudaStream_t stream) {
  const long long total = n_gather + n_filler;
  if (total == 0) return cudaSuccess;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;   // grid-stride beyond
  shuffle_gather_kernel<D><<<(unsigned)blocks, kThreads, 0, stream>>>(
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
// octet (B,) int32; idx (B*1024,) int32; vals (B*1024,) float32; dest
// (B*1024,) and filler (n_filler,) int32 (dest64 = 0) or int64 (dest64 =
// 1); x (ncols,) float32.
int sps_shuffle_gather(int dest64, const void* octet, const void* idx,
                       const void* vals, const void* dest, const void* filler,
                       long long n_batches, long long n_filler, const void* x,
                       long long ncols, long long n_slots, void* out,
                       void* stream) {
  if (n_batches < 0 || n_filler < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_gather = n_batches * kSlab;
  if (dest64 == 0)
    return (int)launch<int>(octet, idx, vals, dest, filler, n_gather,
                            n_filler, x, ncols, n_slots, out, s);
  if (dest64 == 1)
    return (int)launch<long long>(octet, idx, vals, dest, filler, n_gather,
                                  n_filler, x, ncols, n_slots, out, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
