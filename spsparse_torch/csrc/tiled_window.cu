// Super-row window dense-block SpMM for Hopper (sm_90a), behind a plain C
// interface.
//
// K5  sps_tiled_window  replaces spsparse_tpu/ops/pallas_tiled_window.py::
//                       _window_kernel
//     Y = A X for dense 128 x 128 blocks (nbr_pad, rt, 128, 128) grouped in
//     super-rows of `group` block rows; slot t of block row b sits at tile
//     column wstart[b / group] + offs[b*rt + t] (offs -1 = padding).
//
// What bounds it. The same products as K6: 2*128*128*N operations per live
// block against 64 KB (float32) or 32 KB (bfloat16) of block bytes, so at
// N = 128 float32 is bound by the card's float32 rate (true float32, never
// TF32) and bfloat16, on the tensor-core rate, by memory: the blocks once,
// X once per occupied column block, Y once.
//
// Design. K5 runs K6's body (tiled_dense.cuh): a 3-stage cp.async ring of
// k-chunks over the live (slot, k0) sequence of a block row, two CTAs per
// SM, bfloat16 on mma.sync tensor cores, float32 on SIMT FMAs with an 8 x 8
// register tile a thread; only the tile column comes from the window table
// (WindowCols, read as it is) instead of K6's tcols. A thin X (N <= 32)
// keeps the SIMT body of tiled_common.cuh, 32 output columns a CTA, as K6
// does.
//
// The TPU kernel copied each super-row's X window once into VMEM and sliced
// it there. At bench config 3 a window is about 67 column blocks x 128 rows
// x 128 bfloat16 columns, about 2.2 MB, which does not fit Hopper's 227 KB
// of shared memory. The Hopper design leans on the 50 MB L2 instead: the
// grid keeps block-row order (CTA b * nchunks + chunk, the column chunks of
// a row next to each other), so the block rows of a super-row run together
// and read their window's X tiles while the tiles are in L2; each window
// comes from device memory about once. The TPU's call-time delegation to K6
// for a wide RHS (the VMEM scratch budget) is gone: K5 has no scratch budget
// and runs at every width. The blocks must be 16-byte aligned for cp.async
// (the wrapper checks).

#include "tiled_common.cuh"
#include "tiled_dense.cuh"

extern "C" {

// K5: Y (M x N, float32, row-major) = A X over the first nbr block rows of
// the window layout; X (K x N, row-major) in the block type. dtype: 0 =
// float32, 1 = bfloat16.
int sps_tiled_window(int dtype, const void* wstart, const void* offs,
                     const void* blocks, int nbr, int rt, int group,
                     const void* X, long long K, int N, void* Y, long long M,
                     void* stream) {
  if (group <= 0) return (int)cudaErrorInvalidValue;
  const sps_tiled::WindowCols cols{static_cast<const int*>(wstart),
                                   static_cast<const int*>(offs), rt, group};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return sps_dense::launch_dense_ring<float>(blocks, cols, nbr, rt, X, K,
                                               N, Y, M, s);
  if (dtype == 1)
    return sps_dense::launch_dense_ring<__nv_bfloat16>(blocks, cols, nbr, rt,
                                                       X, K, N, Y, M, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
