// Conjugate gradients on a banded (DIA) operator for Hopper (sm_90a), behind
// a plain C interface.
//
// K4  sps_dia_cg   replaces spsparse_tpu/ops/pallas_cg.py::_cg_kernel
//                  iters CG iterations on (A + shift I) x = b, A square DIA
//
// The iteration is the TPU kernel's, step for step:
//   x = 0, r = b, p = 0, rs = b.b, beta = 0; then each iteration
//   p = r + beta p;  Ap = (A + shift I) p;  pap = p.Ap;
//   alpha = rs / (pap == 0 ? 1 : pap);  x += alpha p;  r -= alpha Ap;
//   rsnew = r.r;  beta = rsnew / (rs == 0 ? 1 : rs);  rs = rsnew.
// Both guards are kept, so b = 0 gives x = 0 and rs = 0 with no NaN.
//
// What bounds it. An iteration must read the diagonals once: nnz * 4 bytes
// in float32, nnz * 2 in bfloat16, for 2 flops a stored element, so device
// memory bandwidth sets the least time (46 MB, 13.8 us at 3.35 TB/s, for
// n = 2^20 and 11 float32 diagonals). b in and x out are once a solve; p, r
// and Ap are intermediates that need never leave the chip.
//
// Design. One persistent cooperative launch runs the whole solve, init
// included: one CTA of 512 threads on each SM (G = the SM count; the
// registers of __launch_bounds__(512, 1) let a lane keep 12 (f32) or 16
// (bf16) taps of 4 rows in flight), CTA c owning the rows
// [c R, (c + 1) R) (R a multiple of 32; CTAs past n own none and still
// take part in every exchange).
//   * Resident mode: the CTA's rows of p, r, x and Ap live in shared memory
//     (16 bytes a row) from the first iteration to the last, and x goes to
//     device memory once, at the end. Only the diagonals stream, each
//     element once an iteration with the streaming (evict-first) hint, a
//     batch of taps loaded ahead of their use; a lane takes rows 32 apart,
//     so every load is a coalesced line and the shared-memory reads of p
//     are free of bank conflicts. After its SpMV a CTA prefetches into L2
//     the first rows of its diagonals for the next iteration, so that part
//     of the stream moves while the grid waits in the exchanges.
//   * Device-memory mode, when R rows do not fit in shared memory: the same
//     kernel with p, r and Ap in a scratch buffer and x in the output, each
//     CTA touching only its own rows. The wrapper chooses the mode from the
//     geometry (sps_dia_cg_geometry), which both it and the launch compute.
// An iteration synchronises the grid twice: after the p.Ap partials and
// after the r.r partials. Each CTA writes its partial, with the epoch it
// belongs to, into its own 64-bit slot (a release store; one slot array
// for each reduction, so no slot is rewritten before every CTA has read
// it), and polls all G slots with acquire loads until each carries the
// epoch: the barrier and the exchange of partials are one round of stores
// and loads, with no counter to serialise on.
// Every CTA then sums the G partials in the same fixed order, so alpha and
// beta are the same in every CTA and from run to run, with no broadcast
// and no float atomics.
//
// Taps into another CTA's rows, at any offset (the TPU kernel's
// |offset| <= 128 halo limit does not apply). Before the r.r exchange each
// CTA publishes to device memory the rows that another CTA can read (those
// within max(offset) of its first row or max(-offset) of its last: only the
// edges for a band, every row for offsets as far as a CTA's span): the
// iteration's new r and its p. After the exchange a reader forms the next p
// of a foreign row as fmaf(beta, p, r) from the published values, the fma
// the owner uses, so it equals the owner's p bit for bit, and two exchanges
// an iteration suffice. Chunks whose taps all stay in the CTA's rows take a
// path with no bounds checks.
//
// Counters. Thread 0 of each CTA counts, by clock64() (the SM's cycles, so a
// CTA's ratios need no clock rate), the cycles it spends waiting for the
// slots of the p.Ap exchanges and of the r.r exchanges (the init's b.b sum
// among them), and those from its entry to its exit, in shared memory. If
// the launch is given a stats buffer, each CTA writes its three sums to its
// own slot of it as it exits; otherwise nothing is written. Nothing else
// differs, so x and rs are the same bit for bit with and without it.

#include <cstdint>

#include "dia_common.cuh"

namespace {

using sps::DiaOffsets;

constexpr int kCgThreads = 512;
constexpr int kCgWarps = kCgThreads / 32;
constexpr int kLaneRows = 4;                    // rows a lane a chunk, 32 apart
constexpr int kChunkRows = 32 * kLaneRows;      // rows a warp a chunk
constexpr int kRowAlign = 32;                   // R is a multiple of this
constexpr int kScratchFloats = 64;              // ahead of the vectors
constexpr long long kScratchBytes = kScratchFloats * 4;
constexpr int kVecBytesPerRow = 16;             // p, r, x, Ap
constexpr int kPoll = 8;                        // slots a lane polls at once
constexpr int kEdgeTaps = 4;                    // taps a batch off the interior
constexpr long long kPrefetchBytes = 160 * 1024; // a CTA's L2 prefetch
enum { kSlotPap = 32, kSlotRr = 33 };           // scratch slots of the sums
// Scratch floats 36-41: thread 0's cycle counts (64 bits each): the p.Ap
// and r.r waits, then the clock at entry.
enum { kCycles = 36, kWaitPap = 0, kWaitRr = 1, kEntry = 2 };

// A diagonal element with the streaming (evict-first) hint when live, else
// 0: a predicated load, so that a batch of them issues with no branch.
__device__ __forceinline__ float load_stream(const float* p, bool live) {
  float v;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t"
      "mov.b32 %0, 0;\n\t@q ld.global.cs.f32 %0, [%1];\n\t}"
      : "=f"(v)
      : "l"(p), "r"((unsigned)live));
  return v;
}
__device__ __forceinline__ float load_stream(const __nv_bfloat16* p,
                                             bool live) {
  unsigned short u;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t"
      "mov.b16 %0, 0;\n\t@q ld.global.cs.u16 %0, [%1];\n\t}"
      : "=h"(u)
      : "l"(p), "r"((unsigned)live));
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}

// Brings the CTA's first rows of every diagonal into L2 for the next
// iteration's SpMV (the diagonals do not change), one 128-byte line a
// prefetch: issued after the SpMV, it fills the memory system's idle time
// during the two exchanges.
template <typename T>
__device__ __forceinline__ void prefetch_next(const T* data, long long ld,
                                              long long row0, int nloc,
                                              int K) {
  constexpr int kLineElems = 128 / sizeof(T);
  const int rows = min(nloc, (int)(kPrefetchBytes / (sizeof(T) * max(K, 1))));
  const int lines = (rows + kLineElems - 1) / kLineElems + 1;
  for (int q = threadIdx.x; q < K * lines; q += kCgThreads) {
    const int k = q / lines, line = q % lines;
    const T* seg = data + (long long)k * ld + row0;
    const uintptr_t start = reinterpret_cast<uintptr_t>(seg) & ~uintptr_t(127);
    const uintptr_t at = start + (uintptr_t)line * 128;
    if (at < reinterpret_cast<uintptr_t>(seg + rows))
      asm volatile("prefetch.global.L2 [%0];" ::"l"(at));
  }
}

template <typename T>
struct CgArgs {
  const T* data;
  long long ld, n, rows;        // rows: R, the rows a CTA owns
  const float* b;
  float* x;
  float* vec;                   // device-memory mode: p, r, Ap (n each)
  float* pub_p;                 // published rows of p and r
  float* pub_r;
  unsigned long long* slot_pap;  // a CTA's (epoch, partial), one array a
  unsigned long long* slot_rr;   // reduction; all 0 on entry
  float* rs;                    // out: the final r.r
  unsigned long long* stats;    // out, or null: 3 cycle counts a CTA
  float shift;
  int iters;
  int min_off, max_off;
};

// Sum over the CTA; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kCgWarps ? scratch[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A wait longer than this (no iteration takes that long) traps, so a fault
// shows as a launch error and not as a hang.
constexpr unsigned long long kExchangeTimeoutNs = 20ull * 1000 * 1000 * 1000;

// The grid-wide sum of one partial a CTA, which is also the grid barrier:
// after the CTA's barrier, thread 0 stores (epoch, partial) into its slot
// with release semantics (so the CTA's earlier stores, the published rows,
// are visible first); warp 0 then loads all G slots with acquire semantics
// until each carries this epoch (acquire loads cost less here than relaxed
// ones and a fence), and sums the partials in a fixed order (lane q adds
// slots q, q + 32, ...; then a shuffle tree), the same in every CTA; the
// CTA's barrier passes the ordering on to its other warps. Returns the sum
// to every thread. Thread 0 adds its cycles in the loads to *wait.
__device__ __forceinline__ float grid_sum(float part,
                                          unsigned long long* slots,
                                          unsigned epoch, float* scratch,
                                          int slot, unsigned long long* wait) {
  const float total = block_sum(part, scratch);
  if (threadIdx.x == 0) {
    const unsigned long long w =
        (unsigned long long)epoch << 32 | __float_as_uint(total);
    asm volatile("st.release.gpu.global.u64 [%0], %1;"
                 :
                 : "l"(slots + blockIdx.x), "l"(w)
                 : "memory");
  }
  if (threadIdx.x < 32) {
    const unsigned lane = threadIdx.x;
    const unsigned long long t0 = global_ns();
    const long long c0 = clock64();
    float v = 0.f;
    for (unsigned q0 = 0; q0 < gridDim.x; q0 += 32 * kPoll) {
      unsigned long long w[kPoll];
#pragma unroll
      for (int i = 0; i < kPoll; ++i) w[i] = 0ull;
      for (unsigned spins = 0;; ++spins) {
        bool ready = true;
#pragma unroll
        for (int i = 0; i < kPoll; ++i) {
          const unsigned q = q0 + lane + 32 * i;
          if (q < gridDim.x && (unsigned)(w[i] >> 32) != epoch) {
            asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                         : "=l"(w[i])
                         : "l"(slots + q)
                         : "memory");
            ready = ready && (unsigned)(w[i] >> 32) == epoch;
          }
        }
        if (ready) break;
        if ((spins & 1023u) == 1023u && global_ns() - t0 > kExchangeTimeoutNs)
          __trap();
      }
#pragma unroll
      for (int i = 0; i < kPoll; ++i)
        if (q0 + lane + 32 * i < gridDim.x)
          v += __uint_as_float((unsigned)w[i]);
    }
    if (lane == 0) *wait += clock64() - c0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) scratch[slot] = v;
  }
  __syncthreads();
  return scratch[slot];
}

// Ap = (A + shift I) p on one chunk of the CTA's rows (lane rows li = base +
// 32 e); returns this lane's share of p.Ap. kInterior: the chunk is full and
// every tap of it lands in the CTA's own rows, so nothing is checked. The
// other chunks (a CTA's first and last, and every chunk when taps reach
// other CTAs) load a batch of taps' coefficients and published rows
// together, as predicated loads outside any branch, so that a batch costs
// one round trip to memory and not one a tap.
template <typename T, bool kInterior>
__device__ __forceinline__ float spmv_chunk(const CgArgs<T>& a,
                                            const DiaOffsets& offs,
                                            long long row0, int nloc,
                                            int base, float beta,
                                            const float* vp, float* vap,
                                            float part) {
  // Taps loaded ahead of their use: all 11 of the benchmark's band at once
  // in the interior (64 or 32 bytes a lane), fewer at the edges, where the
  // published rows load beside them.
  constexpr int kTaps = kInterior ? (sizeof(T) == 4 ? 12 : 16) : kEdgeTaps;
  float acc[kLaneRows];
#pragma unroll
  for (int e = 0; e < kLaneRows; ++e) acc[e] = 0.f;
  for (int k0 = 0; k0 < offs.k; k0 += kTaps) {
    float d[kTaps][kLaneRows];
    float pp[kInterior ? 1 : kTaps][kLaneRows];
    float pr[kInterior ? 1 : kTaps][kLaneRows];
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      const int k = k0 + t;
      const int off = k < offs.k ? offs.off[k] : 0;
      const T* col = a.data + (long long)k * a.ld + row0 + base;
#pragma unroll
      for (int e = 0; e < kLaneRows; ++e) {
        const int li = base + 32 * e;
        const long long j = row0 + li + off;
        const bool live = k < offs.k && (kInterior || (li < nloc && j >= 0 &&
                                                         j < a.n));
        d[t][e] = load_stream(col + 32 * e, live);
        if constexpr (!kInterior) {
          const long long lj = (long long)li + off;
          const bool foreign = live && (lj < 0 || lj >= nloc);
          pp[t][e] = foreign ? __ldcg(a.pub_p + j) : 0.f;
          pr[t][e] = foreign ? __ldcg(a.pub_r + j) : 0.f;
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      const int k = k0 + t;
      if (k >= offs.k) break;
      const int off = offs.off[k];
#pragma unroll
      for (int e = 0; e < kLaneRows; ++e) {
        const int li = base + 32 * e;
        if constexpr (kInterior) {
          acc[e] = fmaf(d[t][e], vp[li + off], acc[e]);
        } else {
          const long long j = row0 + li + off;
          const long long lj = (long long)li + off;
          if (li < nloc && j >= 0 && j < a.n) {
            const bool local = lj >= 0 && lj < nloc;
            const float pl = vp[local ? lj : li];
            acc[e] = fmaf(d[t][e], local ? pl : fmaf(beta, pp[t][e], pr[t][e]),
                          acc[e]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kLaneRows; ++e) {
    const int li = base + 32 * e;
    if (kInterior || li < nloc) {
      const float pi = vp[li];
      const float api = fmaf(a.shift, pi, acc[e]);
      vap[li] = api;
      part = fmaf(pi, api, part);
    }
  }
  return part;
}

template <typename T, bool kResident>
__global__ void __launch_bounds__(kCgThreads, 1)
    cg_kernel(const __grid_constant__ CgArgs<T> a,
              const __grid_constant__ DiaOffsets offs) {
  extern __shared__ float4 smem4[];
  float* scratch = reinterpret_cast<float*>(smem4);
  unsigned long long* cycles =
      reinterpret_cast<unsigned long long*>(scratch + kCycles);
  if (threadIdx.x == 0) {
    cycles[kEntry] = clock64();
    cycles[kWaitPap] = cycles[kWaitRr] = 0ull;
  }
  const long long row0 = min(a.n, (long long)blockIdx.x * a.rows);
  const int nloc = (int)(min(a.n, row0 + a.rows) - row0);
  float *vp, *vr, *vx, *vap;
  if constexpr (kResident) {
    vp = scratch + kScratchFloats;
    vr = vp + a.rows;
    vx = vr + a.rows;
    vap = vx + a.rows;
  } else {
    vp = a.vec + row0;
    vr = a.vec + a.n + row0;
    vap = a.vec + 2 * a.n + row0;
    vx = a.x + row0;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nchunks = (nloc + kChunkRows - 1) / kChunkRows;
  // Rows another CTA reads: the first max(offset), the last max(-offset).
  const int head = max(a.max_off, 0), tail = max(-a.min_off, 0);

  // Init: x = 0, r = b, p = 0 (published as such), rs = b.b.
  float part = 0.f;
  for (int c = warp; c < nchunks; c += kCgWarps) {
#pragma unroll
    for (int e = 0; e < kLaneRows; ++e) {
      const int li = c * kChunkRows + 32 * e + lane;
      if (li < nloc) {
        const float bi = a.b[row0 + li];
        vr[li] = bi;
        vp[li] = 0.f;
        vx[li] = 0.f;
        part = fmaf(bi, bi, part);
        if (li < head || nloc - li <= tail) {
          a.pub_p[row0 + li] = 0.f;
          a.pub_r[row0 + li] = bi;
        }
      }
    }
  }
  // Epochs: 1 for the init's sum, then 2 it + 2 (p.Ap), 2 it + 3 (r.r).
  float rs = grid_sum(part, a.slot_rr, 1u, scratch, kSlotRr,
                      cycles + kWaitRr);
  float beta = 0.f;

  for (int it = 0; it < a.iters; ++it) {
    // p = r + beta p on the CTA's rows. Both updates load a chunk's rows
    // before they store any (the compiler cannot tell p, r and x apart, so
    // it keeps the program's order; in the device-memory mode a load after
    // each store cost a round trip a row).
    for (int c = warp; c < nchunks; c += kCgWarps) {
      float pv[kLaneRows], rv[kLaneRows];
#pragma unroll
      for (int e = 0; e < kLaneRows; ++e) {
        const int li = c * kChunkRows + 32 * e + lane;
        pv[e] = li < nloc ? vp[li] : 0.f;
        rv[e] = li < nloc ? vr[li] : 0.f;
      }
#pragma unroll
      for (int e = 0; e < kLaneRows; ++e) {
        const int li = c * kChunkRows + 32 * e + lane;
        if (li < nloc) vp[li] = fmaf(beta, pv[e], rv[e]);
      }
    }
    __syncthreads();
    // Ap = (A + shift I) p and this CTA's share of p.Ap.
    part = 0.f;
    for (int c = warp; c < nchunks; c += kCgWarps) {
      const int lo = c * kChunkRows;
      const bool interior = lo + kChunkRows <= nloc && lo + a.min_off >= 0 &&
                            lo + kChunkRows - 1 + a.max_off < nloc;
      part = interior ? spmv_chunk<T, true>(a, offs, row0, nloc, lo + lane,
                                            beta, vp, vap, part)
                      : spmv_chunk<T, false>(a, offs, row0, nloc, lo + lane,
                                             beta, vp, vap, part);
    }
    prefetch_next(a.data, a.ld, row0, nloc, offs.k);
    const float pap =
        grid_sum(part, a.slot_pap, 2u * it + 2u, scratch, kSlotPap,
                 cycles + kWaitPap);
    const float alpha = rs / (pap == 0.f ? 1.f : pap);
    // x += alpha p; r -= alpha Ap; this CTA's share of r.r; publish.
    part = 0.f;
    for (int c = warp; c < nchunks; c += kCgWarps) {
      float pv[kLaneRows], xv[kLaneRows], av[kLaneRows], rv[kLaneRows];
#pragma unroll
      for (int e = 0; e < kLaneRows; ++e) {
        const int li = c * kChunkRows + 32 * e + lane;
        const bool ok = li < nloc;
        pv[e] = ok ? vp[li] : 0.f;
        xv[e] = ok ? vx[li] : 0.f;
        av[e] = ok ? vap[li] : 0.f;
        rv[e] = ok ? vr[li] : 0.f;
      }
#pragma unroll
      for (int e = 0; e < kLaneRows; ++e) {
        const int li = c * kChunkRows + 32 * e + lane;
        if (li < nloc) {
          const float pi = pv[e];
          vx[li] = fmaf(alpha, pi, xv[e]);
          const float rn = fmaf(-alpha, av[e], rv[e]);
          vr[li] = rn;
          part = fmaf(rn, rn, part);
          if (li < head || nloc - li <= tail) {
            a.pub_p[row0 + li] = pi;
            a.pub_r[row0 + li] = rn;
          }
        }
      }
    }
    const float rsnew =
        grid_sum(part, a.slot_rr, 2u * it + 3u, scratch, kSlotRr,
                 cycles + kWaitRr);
    beta = rsnew / (rs == 0.f ? 1.f : rs);
    rs = rsnew;
  }

  if constexpr (kResident) {
    for (int li = threadIdx.x; li < nloc; li += kCgThreads)
      a.x[row0 + li] = vx[li];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.rs = rs;
  if (a.stats != nullptr && threadIdx.x == 0) {
    unsigned long long* out = a.stats + 3 * blockIdx.x;
    out[0] = cycles[kWaitPap];
    out[1] = cycles[kWaitRr];
    out[2] = clock64() - cycles[kEntry];
  }
}

// Rows a CTA owns: ceil(n / G) rounded up to kRowAlign.
long long rows_for(long long n, long long grid) {
  const long long r = (n + grid - 1) / grid;
  return (r + kRowAlign - 1) / kRowAlign * kRowAlign;
}

struct Geometry {
  long long grid, ctas_per_sm, rows, resident, smem;
};

// One CTA an SM. The resident mode when the CTA's rows fit in its shared
// memory at an occupancy of one (as the card reports it), else the
// device-memory mode.
template <typename T>
cudaError_t geometry(long long n, Geometry* g) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cg_kernel<T, true>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const long long rows = rows_for(n, sms);
  const long long smem = kScratchBytes + kVecBytesPerRow * rows;
  int occ = 0;
  if (smem <= optin) {
    err = cudaFuncSetAttribute(cg_kernel<T, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ, cg_kernel<T, true>, kCgThreads, (size_t)smem);
    if (err != cudaSuccess) return err;
    if (occ >= 1) {
      *g = {sms, 1, rows, 1, smem};
      return cudaSuccess;
    }
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, cg_kernel<T, false>, kCgThreads, (size_t)kScratchBytes);
  if (err != cudaSuccess) return err;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  *g = {sms, 1, rows, 0, kScratchBytes};
  return cudaSuccess;
}

// Floats of the caller's scratch: published p and r (n each), the two slot
// arrays (G 64-bit slots each), and in the device-memory mode p, r and Ap
// (n each).
long long scratch_floats(long long n, const Geometry& g) {
  return 2 * n + 4 * g.grid + (g.resident ? 0 : 3 * n);
}

template <typename T>
cudaError_t run(const void* data, long long ld, long long n,
                const DiaOffsets& offs, float shift, const float* b, float* x,
                float* scratch, long long scratch_len, float* rs, int iters,
                cudaStream_t stream, unsigned long long* stats) {
  Geometry g;
  cudaError_t err = geometry<T>(n, &g);
  if (err != cudaSuccess) return err;
  if (scratch_len < scratch_floats(n, g)) return cudaErrorInvalidValue;
  CgArgs<T> a;
  a.data = static_cast<const T*>(data);
  a.ld = ld;
  a.n = n;
  a.rows = g.rows;
  a.b = b;
  a.x = x;
  a.pub_p = scratch;
  a.pub_r = scratch + n;
  a.slot_pap = reinterpret_cast<unsigned long long*>(scratch + 2 * n);
  a.slot_rr = a.slot_pap + g.grid;
  a.vec = scratch + 2 * n + 4 * g.grid;
  a.rs = rs;
  a.stats = stats;
  a.shift = shift;
  a.iters = iters;
  a.min_off = a.max_off = 0;
  for (int k = 0; k < offs.k; ++k) {
    a.min_off = k == 0 || offs.off[k] < a.min_off ? offs.off[k] : a.min_off;
    a.max_off = k == 0 || offs.off[k] > a.max_off ? offs.off[k] : a.max_off;
  }
  err = cudaMemsetAsync(a.slot_pap, 0, 2 * g.grid * sizeof(unsigned long long),
                        stream);
  if (err != cudaSuccess) return err;
  DiaOffsets o = offs;
  void* params[] = {&a, &o};
  const void* kernel = g.resident
                           ? reinterpret_cast<const void*>(cg_kernel<T, true>)
                           : reinterpret_cast<const void*>(cg_kernel<T, false>);
  return cudaLaunchCooperativeKernel(kernel, dim3((unsigned)g.grid),
                                     dim3(kCgThreads), params,
                                     (size_t)g.smem, stream);
}

}  // namespace

extern "C" {

// K4's launch geometry for n rows (dtype: 0 = float32 data, 1 = bfloat16):
// out = (grid, CTAs an SM, rows a CTA, resident (1) or device-memory (0)
// mode, dynamic shared-memory bytes, scratch floats the caller allocates).
int sps_dia_cg_geometry(int dtype, long long n, void* out) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  Geometry g;
  cudaError_t err;
  if (dtype == 0)
    err = geometry<float>(n, &g);
  else if (dtype == 1)
    err = geometry<__nv_bfloat16>(n, &g);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  long long* o = static_cast<long long*>(out);
  o[0] = g.grid;
  o[1] = g.ctas_per_sm;
  o[2] = g.rows;
  o[3] = g.resident;
  o[4] = g.smem;
  o[5] = scratch_floats(n, g);
  return 0;
}

// K4: iters CG iterations on (A + shift I) x = b for a square A (n x n) in
// DIA form, as one cooperative launch on the caller's stream. dtype: 0 =
// float32 data, 1 = bfloat16 data. b and x hold n floats; scratch holds at
// least the floats sps_dia_cg_geometry reports (its slot arrays are zeroed
// here, on the stream); rs receives the final r.r (one float). stats is null
// or holds 3 x grid 64-bit counts, which each CTA writes as it exits: its
// cycles waiting in the p.Ap exchanges, in the r.r exchanges, and from its
// entry to its exit.
// A launch the card refuses (a grid that cannot be co-resident, too much
// shared memory) returns its error; nothing else is tried.
int sps_dia_cg(int dtype, const void* data, long long ld, long long n, int K,
               const void* offsets, float shift, const void* b, void* x,
               void* scratch, long long scratch_len, void* rs, int iters,
               void* stream, void* stats) {
  DiaOffsets offs;
  if (!sps::make_offsets(K, offsets, &offs) || iters < 0 || n <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bb = static_cast<const float*>(b);
  float* xx = static_cast<float*>(x);
  float* ss = static_cast<float*>(scratch);
  float* out_rs = static_cast<float*>(rs);
  unsigned long long* st = static_cast<unsigned long long*>(stats);
  cudaError_t err;
  if (dtype == 0)
    err = run<float>(data, ld, n, offs, shift, bb, xx, ss, scratch_len,
                     out_rs, iters, s, st);
  else if (dtype == 1)
    err = run<__nv_bfloat16>(data, ld, n, offs, shift, bb, xx, ss,
                             scratch_len, out_rs, iters, s, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
