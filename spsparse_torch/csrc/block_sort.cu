// Bitonic block sort for Hopper (sm_90a), behind a plain C interface.
//
// K12  sps_block_sort  replaces spsparse_tpu/ops/pallas_sort.py::_sort_kernel
//     Each (R, 128) block of (nblk, R, 128) arrays, read row-major as n =
//     128 R elements, is sorted ascending by the lexicographic order of the
//     first num_keys arrays (int32); the other arrays (any 4-byte type, moved
//     as bits) ride along. Not stable.
//
// The network is plan_stages' (pallas_sort.py:49-70): for span = 2, 4, ...,
// n and d = span/2, ..., 1, element e is paired with e + d when e & d == 0,
// and the pair is put in ascending order when e & span' == 0, descending
// otherwise, where span' = span below n and 2n at the last span (so the
// final merge is ascending). The compare-exchange is the JAX kernel's
// (pallas_sort.py:117-123), ties included: an ascending pair is swapped
// when lo > hi, a descending pair when lo <= hi, lexicographically.
//
// Design. The TPU ran every stage on a VMEM-resident block, with lane
// rolls for partners closer than 128 and row swaps beyond. Here a CTA loads
// a chunk of C elements of every array into shared memory (C = the block,
// or the largest power of two whose arrays fit kSmemBudget) and runs all
// stages whose distance is below C there, one compare-exchange a thread per
// step, __syncthreads() between stages; the kernels are specialised on the
// key and array counts the callers use, so the loops over the arrays
// unroll into registers. A block of C elements is sorted in
// one launch that reads and writes device memory once. A larger block (at
// (256, 128) with three arrays, 384 KB > the 227 KB a CTA may have) first
// sorts its chunks in alternating directions, then, for each larger span,
// runs the stages of distance >= C as global-memory passes (one thread a
// pair) and finishes the span's short stages in shared memory again: the
// bitonic network allows exactly this split.
//
// Bound. Each array is read once and written once (8 bytes an element and
// array) when the block fits; every global pass adds a read and a write.
// Compares and selects: log2(n)(log2(n)+1)/2 stages of n/2 pairs, a few
// integer operations a pair and array, on the SIMT units: at (64, 128)
// blocks the bytes bound it.
//
// The entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxArrays = 8;
constexpr int kMaxThreads = 512;
constexpr long long kSmemBudget = 96 * 1024;   // 2 CTAs per SM fit

struct Arrays {
  const int* in[kMaxArrays];
  int* out[kMaxArrays];
};

// Whether the pair (lo, hi) is swapped: an ascending pair (up) when lo >
// hi, a descending one when lo <= hi, over the keys lexicographically.
// key(k, i): the k-th key of element i.
template <int NK, typename Key, typename Index>
__device__ __forceinline__ bool swap_pair(Key key, Index lo, Index hi,
                                          int num_keys, bool up) {
  bool le = true;
#pragma unroll
  for (int k = 0; k < (NK ? NK : kMaxArrays); ++k) {
    if (k >= num_keys) break;
    const int a = key(k, lo), b = key(k, hi);
    if (a != b) {
      le = a < b;
      break;
    }
  }
  return up ? !le : le;
}

// Stages in shared memory over a chunk of C elements of each block: spans
// span_first..span_last (doubling), each from distance min(span, C)/2 down
// to 1. base: the chunk's first element index within its block. NK and NA
// fix num_keys and n_arrays at compile time (0: given at run time), so that
// the loops over the arrays unroll.
template <int NK, int NA>
__global__ void __launch_bounds__(kMaxThreads)
    sort_chunk_kernel(Arrays arr, int n_arrays, int num_keys, long long n,
                      int C, long long span_first, long long span_last) {
  extern __shared__ int smem[];
  if (NK) num_keys = NK;
  if (NA) n_arrays = NA;
  const long long chunks = n / C;
  const long long blk = blockIdx.x / chunks;
  const long long base = (blockIdx.x % chunks) * C;
  const long long g0 = blk * n + base;
#pragma unroll
  for (int a = 0; a < (NA ? NA : kMaxArrays); ++a) {
    if (a >= n_arrays) break;
    for (int i = threadIdx.x; i < C; i += blockDim.x)
      smem[a * C + i] = arr.in[a][g0 + i];
  }
  __syncthreads();
  const auto key = [&](int k, int i) { return smem[k * C + i]; };
  for (long long span = span_first; span <= span_last; span *= 2) {
    const long long mask = span < n ? span : 2 * n;
    for (int d = (int)((span < C ? span : C) / 2); d >= 1; d /= 2) {
      for (int p = threadIdx.x; p < C / 2; p += blockDim.x) {
        const int i = ((p & ~(d - 1)) << 1) + (p & (d - 1));
        const int j = i + d;
        const bool up = ((base + i) & mask) == 0;
        if (swap_pair<NK>(key, i, j, num_keys, up)) {
#pragma unroll
          for (int a = 0; a < (NA ? NA : kMaxArrays); ++a) {
            if (a >= n_arrays) break;
            const int t = smem[a * C + i];
            smem[a * C + i] = smem[a * C + j];
            smem[a * C + j] = t;
          }
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int a = 0; a < (NA ? NA : kMaxArrays); ++a) {
    if (a >= n_arrays) break;
    for (int i = threadIdx.x; i < C; i += blockDim.x)
      arr.out[a][g0 + i] = smem[a * C + i];
  }
}

// One stage of distance d >= C in device memory, in place on arr.out.
template <int NK, int NA>
__global__ void __launch_bounds__(256)
    sort_global_stage_kernel(Arrays arr, int n_arrays, int num_keys,
                             long long n, long long nblk, long long d,
                             long long mask) {
  if (NK) num_keys = NK;
  if (NA) n_arrays = NA;
  const long long half = n / 2;
  const long long pairs = nblk * half;
  const auto key = [&](int k, long long i) { return arr.out[k][i]; };
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < pairs; p += (long long)gridDim.x * blockDim.x) {
    const long long blk = p / half;
    const long long q = p % half;
    const long long i = ((q & ~(d - 1)) << 1) + (q & (d - 1));
    const long long gi = blk * n + i;
    const long long gj = gi + d;
    if (swap_pair<NK>(key, gi, gj, num_keys, (i & mask) == 0)) {
#pragma unroll
      for (int a = 0; a < (NA ? NA : kMaxArrays); ++a) {
        if (a >= n_arrays) break;
        const int t = arr.out[a][gi];
        arr.out[a][gi] = arr.out[a][gj];
        arr.out[a][gj] = t;
      }
    }
  }
}

// The launch sequence of one sort, for kernels specialised on NK / NA.
template <int NK, int NA>
cudaError_t run(Arrays arr, int n_arrays, int num_keys, long long nblk,
                long long n, long long C, cudaStream_t s) {
  const size_t smem = (size_t)(C * n_arrays * 4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sort_chunk_kernel<NK, NA>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int threads = (int)(C / 2 < kMaxThreads ? C / 2 : kMaxThreads);
  const long long ctas = nblk * (n / C);
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  // Sort each chunk (every span up to C), reading the inputs.
  sort_chunk_kernel<NK, NA><<<(unsigned)ctas, threads, smem, s>>>(
      arr, n_arrays, num_keys, n, (int)C, 2, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // From here on the stages run in place on the outputs.
  for (int a = 0; a < n_arrays; ++a) arr.in[a] = arr.out[a];
  long long gblocks = (nblk * (n / 2) + 255) / 256;
  if (gblocks > (1LL << 30)) gblocks = 1LL << 30;
  for (long long span = 2 * C; span <= n; span *= 2) {
    const long long mask = span < n ? span : 2 * n;
    for (long long d = span / 2; d >= C; d /= 2) {
      sort_global_stage_kernel<NK, NA><<<(unsigned)gblocks, 256, 0, s>>>(
          arr, n_arrays, num_keys, n, nblk, d, mask);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    sort_chunk_kernel<NK, NA><<<(unsigned)ctas, threads, smem, s>>>(
        arr, n_arrays, num_keys, n, (int)C, span, span);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K12: sort each of the nblk blocks of n elements (n = 128 R, a power of
// two) of n_arrays arrays; ins and outs are host arrays of n_arrays device
// pointers (4-byte elements, contiguous (nblk, n)); the first num_keys
// arrays are the int32 keys.
int sps_block_sort(const void* ins, const void* outs, int n_arrays,
                   int num_keys, long long nblk, long long n, void* stream) {
  if (n_arrays < 1 || n_arrays > kMaxArrays || num_keys < 1 ||
      num_keys > n_arrays || n < 2 || (n & (n - 1)) != 0 || nblk < 0)
    return (int)cudaErrorInvalidValue;
  if (nblk == 0) return (int)cudaSuccess;
  Arrays arr;
  for (int a = 0; a < kMaxArrays; ++a) {
    arr.in[a] = a < n_arrays ? static_cast<const int* const*>(ins)[a]
                             : nullptr;
    arr.out[a] = a < n_arrays ? static_cast<int* const*>(outs)[a] : nullptr;
  }
  long long C = n;
  while (C > 2 && C * n_arrays * 4 > kSmemBudget) C /= 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The key/array counts the callers use (a key and up to two payloads,
  // two keys and up to two payloads) get kernels of their own.
  const int shape = num_keys * 16 + n_arrays;
  switch (shape) {
    case 1 * 16 + 1: return (int)run<1, 1>(arr, 1, 1, nblk, n, C, s);
    case 1 * 16 + 2: return (int)run<1, 2>(arr, 2, 1, nblk, n, C, s);
    case 1 * 16 + 3: return (int)run<1, 3>(arr, 3, 1, nblk, n, C, s);
    case 2 * 16 + 2: return (int)run<2, 2>(arr, 2, 2, nblk, n, C, s);
    case 2 * 16 + 3: return (int)run<2, 3>(arr, 3, 2, nblk, n, C, s);
    case 2 * 16 + 4: return (int)run<2, 4>(arr, 4, 2, nblk, n, C, s);
    default:
      return (int)run<0, 0>(arr, n_arrays, num_keys, nblk, n, C, s);
  }
}

}  // extern "C"
