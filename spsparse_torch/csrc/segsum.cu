// Segmented row sums for Hopper (sm_90a), behind a plain C interface.
//
// K10  sps_segsum  replaces spsparse_tpu/ops/pallas_segsum.py::_segsum_kernel
//                  y[r] = sum_{e in [rp[r], rp[r+1])} prod[e]
//
// The TPU kernel computed R row sums at a time as one masked (R, W) @ (W,)
// product on the MXU over a 1024-aligned DMA window of entries, sized by
// the caller's rows_per_block / entries_per_block. None of that is the
// function: it is the per-row sum, and Hopper reads any entry range
// directly. Here a group of `group` neighbouring lanes (a power of two up
// to 32, chosen by the wrapper so that a lane of a mean-length row sums
// about four entries) owns one row: the lanes stride over the row's
// entries, each keeping a float32 partial sum, with the loads unrolled so
// that several are in flight, and a shuffle reduction inside the group
// gives the total. (With a lane per entry every warp would end after two
// dependent loads, row_ptr and then the products, and that latency would
// bound the kernel.) Empty rows write 0; a long row is walked by its group
// alone, so one 4096-entry row among rows of 10 costs its group of 4 lanes
// 1024 steps and nobody else anything.
//
// Bound. Each entry's product is read once (4 bytes), row_ptr once and y
// written once: 4 nnz + 8 nrows bytes, one add per entry, so the kernel is
// bound by device memory. The sum order (lane-strided, then a tree) differs
// from the MXU's and from a sequential sum; callers hold it to an rtol.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    segsum_kernel(const float* __restrict__ prod,
                  const int* __restrict__ row_ptr, long long nrows, int group,
                  float* __restrict__ y) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long r = t / group;
  const int lane = (int)(t % group);
  float acc = 0.f;
  if (r < nrows) {
    const int lo = __ldg(row_ptr + r);
    const int hi = __ldg(row_ptr + r + 1);
#pragma unroll 4
    for (int e = lo + lane; e < hi; e += group) acc += __ldg(prod + e);
  }
  // Every lane of the warp takes part in the shuffles (rows past the end
  // carry 0); `width` keeps each group's reduction inside the group.
  for (int off = group / 2; off > 0; off /= 2)
    acc += __shfl_down_sync(0xffffffffu, acc, off, group);
  if (r < nrows && lane == 0) y[r] = acc;
}

}  // namespace

extern "C" {

// K10: y (nrows, float32) = per-row sums of prod over row_ptr (nrows + 1
// int32 offsets into prod). group: lanes per row, a power of two <= 32.
int sps_segsum(const void* prod, const void* row_ptr, long long nrows,
               int group, void* y, void* stream) {
  if (group <= 0 || group > 32 || (group & (group - 1)) != 0 || nrows < 0)
    return (int)cudaErrorInvalidValue;
  if (nrows == 0) return (int)cudaSuccess;
  const long long threads = nrows * group;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  segsum_kernel<<<(unsigned)blocks, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(prod), static_cast<const int*>(row_ptr),
      nrows, group, static_cast<float*>(y));
  return (int)cudaGetLastError();
}

}  // extern "C"
