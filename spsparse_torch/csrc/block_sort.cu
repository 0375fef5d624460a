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
// rolls for partners closer than 128 and row swaps beyond. Here a CTA of T
// threads sorts a chunk of C = T E elements (the block, or the largest
// power of two that the registers and the shared-memory budget allow) with
// E consecutive elements of each array in every thread's registers (E = 16
// for up to four arrays, 8 for more; 4 for blocks under 512 elements). Two
// placements of the chunk:
//   L0 (blocked):  element e = t E + i  (thread t, register i);
//   L1 (striped):  element e = i T + t.
// A stage of distance d = 2^k then runs
//   * in registers when d < E (L0) or d >= T (L1): no exchange, no barrier;
//   * by __shfl_xor_sync with lane ^ (d / E) when E <= d < 32 E (L0);
// and only a change of placement touches shared memory: every element is
// written once and read once (16-byte chunks XOR-swizzled within 128-byte
// rows, so that both placements are free of bank conflicts), between two
// barriers. With C <= 32 E^2, every distance of 32 E or more is a register
// distance in L1, so a span of the network needs at most two changes of
// placement. At n = 8192 (E = 16, T = 512) the 91 stages run with 10 such
// exchanges (the load and the store included) instead of 91 barriered
// shared-memory stages. The device-memory reads and writes are coalesced
// (L1: a warp touches 32 consecutive elements). The kernels are specialised
// on the key and array counts the callers use, so the loops over the arrays
// unroll into registers. block_sort_schedule (ops/block_sort.py) gives the
// same stage sequence, with each stage's kind, for a host replay.
//
// A larger block (at (256, 128) with three arrays, past the chunk) first
// sorts its chunks in alternating directions, then, for each larger span,
// runs the stages of distance >= C as global-memory passes (one thread a
// pair) and finishes the span's short stages in a chunk again: the bitonic
// network allows exactly this split. The compare-exchanges are the
// network's, in its order, whatever the placement, so the result (payloads
// included) is bit for bit that of the first body, which ran every stage in
// shared memory (since deleted).
//
// Bound. Each array is read once and written once (8 bytes an element and
// array) when the block fits; every global pass adds a read and a write.
// Compares and selects: log2(n)(log2(n)+1)/2 stages of n/2 pairs, a few
// integer operations a pair and array, on the SIMT units: at (64, 128)
// blocks the bytes bound it.
//
// The entry points return cudaGetLastError() after their launches.

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

// ---- K12: the chunk in registers, warp shuffles, few exchanges ----------
namespace reg {

// Physical index of element e of a chunk array in shared memory: 16-byte
// chunks XOR-swizzled within 128-byte rows. A warp's 16-byte accesses in L0
// (lanes E elements apart) and its 4-byte accesses in L1 (32 consecutive
// elements) then fall on distinct banks.
__device__ __forceinline__ int phys(int e) {
  const int q = e >> 2;
  return ((q ^ ((q >> 3) & 7)) << 2) | (e & 3);
}

// Elements of each array a thread holds, by array count; chunks under
// 32 times that (blocks of 128 and 256 elements) take kSmallElems.
template <int NA>
constexpr int big_elems() {
  return NA == 0 || NA > 4 ? 8 : 16;
}
constexpr int kSmallElems = 4;

template <int NK, int NA, int E>
struct Chunk {
  static constexpr int A = NA ? NA : kMaxArrays;
  static constexpr int eb = E == 4 ? 2 : E == 8 ? 3 : 4;   // log2(E)
  int v[A][E];
  int n_arrays, num_keys;
  int t, lane, sh, C;   // sh = log2(T), the register shift in L1
  bool l1;
  // Direction of a pair: up when the span bit (emask, or ubase: that bit
  // of the chunk's base) of its lower element is clear. Per stage, the
  // thread's part (up_t) and the register bits it tests (imask).
  bool ubase;
  int emask;
  bool up_t;
  int imask;

  template <bool kL1>
  __device__ __forceinline__ void set_dir() {
    up_t = ubase && ((kL1 ? t : t << eb) & emask) == 0;
    imask = kL1 ? emask >> sh : emask & (E - 1);
  }
  __device__ __forceinline__ bool up(int i) const {
    return up_t && (i & imask) == 0;
  }

  // The compare-exchange of registers i < j in direction up, by selects.
  __device__ __forceinline__ void cx(int i, int j, bool up) {
    const auto key = [&](int k, int idx) { return v[k][idx]; };
    const bool sw = swap_pair<NK>(key, i, j, num_keys, up);
#pragma unroll
    for (int a = 0; a < A; ++a) {
      if (a >= n_arrays) break;
      const int lo = v[a][i], hi = v[a][j];
      v[a][i] = sw ? hi : lo;
      v[a][j] = sw ? lo : hi;
    }
  }

  // A stage of register distance D in placement L1 (kL1) or L0.
  template <int D, bool kL1>
  __device__ __forceinline__ void reg_stage() {
    set_dir<kL1>();
    if (imask == 0) {   // one direction for all the thread's pairs
#pragma unroll
      for (int i = 0; i < E; ++i)
        if (!(i & D)) cx(i, i + D, up_t);
    } else {
#pragma unroll
      for (int i = 0; i < E; ++i)
        if (!(i & D)) cx(i, i + D, up(i));
    }
  }

  template <bool kL1>
  __device__ __forceinline__ void reg_stage(int r) {   // D = 2^r
    switch (r) {
      case 0: reg_stage<1, kL1>(); break;
      case 1: reg_stage<2, kL1>(); break;
      case 2: if constexpr (E > 4) reg_stage<4, kL1>(); break;
      case 3: if constexpr (E > 8) reg_stage<8, kL1>(); break;
    }
  }

  // A stage of distance d = 2^k, E <= d < 32 E, in L0: with lane ^ (d/E).
  __device__ __forceinline__ void shuffle_stage(int k) {
    const int ld = 1 << (k - eb);
    const bool lower = (lane & ld) == 0;
    set_dir<false>();   // the span bit is above d: no register bit
#pragma unroll
    for (int i = 0; i < E; ++i) {
      int o[A];
#pragma unroll
      for (int a = 0; a < A; ++a) {
        if (a >= n_arrays) break;
        o[a] = __shfl_xor_sync(0xffffffffu, v[a][i], ld);
      }
      const auto key = [&](int kk, int side) {
        return (side == 0) == lower ? v[kk][i] : o[kk];
      };
      const bool sw = swap_pair<NK>(key, 0, 1, num_keys, up_t);
#pragma unroll
      for (int a = 0; a < A; ++a) {
        if (a >= n_arrays) break;
        v[a][i] = sw ? o[a] : v[a][i];
      }
    }
  }

  // A change of placement through shared memory. Two barriers: every
  // thread has read the previous exchange before any writes this one.
  __device__ __forceinline__ void exchange(int* sm) {
    __syncthreads();
#pragma unroll
    for (int a = 0; a < A; ++a) {
      if (a >= n_arrays) break;
      int* s = sm + a * C;
      if (l1) {
#pragma unroll
        for (int i = 0; i < E; ++i) s[phys((i << sh) | t)] = v[a][i];
      } else {
#pragma unroll
        for (int c = 0; c < E / 4; ++c)
          *reinterpret_cast<int4*>(s + phys((t << eb) + 4 * c)) = make_int4(
              v[a][4 * c], v[a][4 * c + 1], v[a][4 * c + 2], v[a][4 * c + 3]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < A; ++a) {
      if (a >= n_arrays) break;
      const int* s = sm + a * C;
      if (l1) {
#pragma unroll
        for (int c = 0; c < E / 4; ++c) {
          const int4 q =
              *reinterpret_cast<const int4*>(s + phys((t << eb) + 4 * c));
          v[a][4 * c] = q.x;
          v[a][4 * c + 1] = q.y;
          v[a][4 * c + 2] = q.z;
          v[a][4 * c + 3] = q.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < E; ++i) v[a][i] = s[phys((i << sh) | t)];
      }
    }
    l1 = !l1;
  }
};

// Stages over a chunk of C = T E elements of each block (T = blockDim.x):
// spans span_first .. span_last (doubling), each from distance
// min(span, C)/2 down to 1. Reads arr.in and writes arr.out, coalesced, in
// L1.
template <int NK, int NA, int E>
__global__ void __launch_bounds__(kMaxThreads)
    sort_chunk_kernel(Arrays arr, int n_arrays, int num_keys, long long n,
                      int C, int cb, long long span_first,
                      long long span_last) {
  extern __shared__ int4 smem4[];
  int* sm = reinterpret_cast<int*>(smem4);
  using Ch = Chunk<NK, NA, E>;
  Ch ch;
  ch.n_arrays = NA ? NA : n_arrays;
  ch.num_keys = NK ? NK : num_keys;
  ch.t = threadIdx.x;
  ch.lane = threadIdx.x & 31;
  ch.sh = cb - Ch::eb;
  ch.C = C;
  const long long chunks = n / C;
  const long long blk = blockIdx.x / chunks;
  const long long base = (blockIdx.x % chunks) * C;
  const long long g0 = blk * n + base;
#pragma unroll
  for (int a = 0; a < Ch::A; ++a) {
    if (a >= ch.n_arrays) break;
#pragma unroll
    for (int i = 0; i < E; ++i)
      ch.v[a][i] = arr.in[a][g0 + ((i << ch.sh) | ch.t)];
  }
  ch.l1 = true;
  ch.exchange(sm);   // to L0
  for (long long span = span_first; span <= span_last; span *= 2) {
    const long long mask = span < n ? span : 2 * n;
    ch.ubase = (base & mask) == 0;
    ch.emask = mask < C ? (int)mask : 0;
    const long long top = span < C ? span : C;
    for (int k = 62 - __clzll(top); k >= 0; --k) {
      if (k >= ch.sh && (ch.l1 || k >= Ch::eb + 5)) {
        if (!ch.l1) ch.exchange(sm);
        ch.template reg_stage<true>(k - ch.sh);
      } else {
        if (ch.l1) ch.exchange(sm);
        if (k < Ch::eb)
          ch.template reg_stage<false>(k);
        else
          ch.shuffle_stage(k);
      }
    }
  }
  if (!ch.l1) ch.exchange(sm);   // to L1 for the store
#pragma unroll
  for (int a = 0; a < Ch::A; ++a) {
    if (a >= ch.n_arrays) break;
#pragma unroll
    for (int i = 0; i < E; ++i)
      arr.out[a][g0 + ((i << ch.sh) | ch.t)] = ch.v[a][i];
  }
}

// The chunk of a block of n elements (C, a power of two) and the elements
// a thread holds (E): T = C / E <= kMaxThreads; C <= 32 E^2, so that every
// distance of 32 E or more is a register distance in L1; the arrays fit
// the shared-memory budget.
template <int NA>
void geometry(long long n, int n_arrays, long long* C, int* E) {
  const int big = big_elems<NA>();
  const int eb = big == 8 ? 3 : 4;
  long long c = n;
  while (c > (long long)kMaxThreads * big || c > (1LL << (2 * eb + 5)) ||
         c * n_arrays * 4 > kSmemBudget)
    c /= 2;
  *C = c;
  *E = c >= 32LL * big ? big : kSmallElems;
}

// The geometry of run<NK, NA> for blocks of n elements: out = (C, E, T).
template <int NK, int NA>
cudaError_t geometry_of(Arrays, int n_arrays, int, long long n,
                        long long* out) {
  int E;
  geometry<NA>(n, n_arrays, &out[0], &E);
  out[1] = E;
  out[2] = out[0] / E;
  return out[0] < 128 ? cudaErrorInvalidValue : cudaSuccess;
}

template <int NK, int NA, int E>
cudaError_t launch_chunks(Arrays arr, int n_arrays, int num_keys,
                          long long nblk, long long n, long long C,
                          long long span_first, long long span_last,
                          cudaStream_t s) {
  const size_t smem = (size_t)(C * n_arrays * 4);
  auto kernel = sort_chunk_kernel<NK, NA, E>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int cb = 0;
  while ((1LL << cb) < C) ++cb;
  const long long ctas = nblk * (n / C);
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)ctas, (unsigned)(C / E), smem, s>>>(
      arr, n_arrays, num_keys, n, (int)C, cb, span_first, span_last);
  return cudaGetLastError();
}

template <int NK, int NA>
cudaError_t run(Arrays arr, int n_arrays, int num_keys, long long nblk,
                long long n, cudaStream_t s) {
  long long C;
  int E;
  geometry<NA>(n, n_arrays, &C, &E);
  if (C < 128) return cudaErrorInvalidValue;
  const auto chunks = [&](long long first, long long last) {
    if (E == kSmallElems)
      return launch_chunks<NK, NA, kSmallElems>(arr, n_arrays, num_keys, nblk,
                                                n, C, first, last, s);
    return launch_chunks<NK, NA, big_elems<NA>()>(arr, n_arrays, num_keys,
                                                  nblk, n, C, first, last, s);
  };
  // Sort each chunk (every span up to C), reading the inputs.
  cudaError_t err = chunks(2, C);
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
    err = chunks(span, span);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // namespace reg

// Checks and the device-pointer tables of both entry points.
bool arrays_of(const void* ins, const void* outs, int n_arrays, int num_keys,
               long long nblk, long long n, Arrays* arr) {
  if (n_arrays < 1 || n_arrays > kMaxArrays || num_keys < 1 ||
      num_keys > n_arrays || n < 2 || (n & (n - 1)) != 0 || nblk < 0)
    return false;
  for (int a = 0; a < kMaxArrays; ++a) {
    arr->in[a] = a < n_arrays ? static_cast<const int* const*>(ins)[a]
                              : nullptr;
    arr->out[a] = a < n_arrays ? static_cast<int* const*>(outs)[a] : nullptr;
  }
  return true;
}

}  // namespace

// The key/array counts the callers use (a key and up to two payloads, two
// keys and up to two payloads) get kernels of their own.
#define SPS_K12_DISPATCH(RUN, ...)                                     \
  switch (num_keys * 16 + n_arrays) {                                  \
    case 1 * 16 + 1: return (int)RUN<1, 1>(arr, 1, 1, __VA_ARGS__);    \
    case 1 * 16 + 2: return (int)RUN<1, 2>(arr, 2, 1, __VA_ARGS__);    \
    case 1 * 16 + 3: return (int)RUN<1, 3>(arr, 3, 1, __VA_ARGS__);    \
    case 2 * 16 + 2: return (int)RUN<2, 2>(arr, 2, 2, __VA_ARGS__);    \
    case 2 * 16 + 3: return (int)RUN<2, 3>(arr, 3, 2, __VA_ARGS__);    \
    case 2 * 16 + 4: return (int)RUN<2, 4>(arr, 4, 2, __VA_ARGS__);    \
    default:                                                           \
      return (int)RUN<0, 0>(arr, n_arrays, num_keys, __VA_ARGS__);     \
  }


extern "C" {

// K12: sort each of the nblk blocks of n elements (n = 128 R, a power of
// two, at least 128) of n_arrays arrays; ins and outs are host arrays of
// n_arrays device pointers (4-byte elements, contiguous (nblk, n)); the
// first num_keys arrays are the int32 keys.
int sps_block_sort(const void* ins, const void* outs, int n_arrays,
                   int num_keys, long long nblk, long long n, void* stream) {
  Arrays arr;
  if (!arrays_of(ins, outs, n_arrays, num_keys, nblk, n, &arr) || n < 128)
    return (int)cudaErrorInvalidValue;
  if (nblk == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SPS_K12_DISPATCH(reg::run, nblk, n, s)
}

// The chunk sps_block_sort takes for blocks of n elements of n_arrays
// arrays and num_keys keys: out (host, 3 long long) = (C, E, threads), the
// chunk a CTA sorts, the elements of each array a thread holds, the CTA's
// threads. It lets the host replay of the schedule check its copy of the
// geometry against the kernel's.
int sps_block_sort_geometry(int n_arrays, int num_keys, long long n,
                            void* out) {
  const Arrays arr{};
  if (n_arrays < 1 || n_arrays > kMaxArrays || num_keys < 1 ||
      num_keys > n_arrays || n < 128 || (n & (n - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  SPS_K12_DISPATCH(reg::geometry_of, n, static_cast<long long*>(out))
}

#undef SPS_K12_DISPATCH

}  // extern "C"
