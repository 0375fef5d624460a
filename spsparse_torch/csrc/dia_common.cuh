// Shared pieces of the DIA kernels (dia.cu, dia_mrhs.cu, dia_cg.cu).
//
// The operand is row-per-diagonal: data is (K, ld) with row k holding
// A[i, i + off_k] at column i. Offsets travel by value in the
// kernel-parameter struct DiaOffsets (at most SPS_MAX_DIAGS of them).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

#define SPS_MAX_DIAGS 128

namespace sps {

constexpr int kThreads = 256;

struct DiaOffsets {
  int k;
  int off[SPS_MAX_DIAGS];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

inline bool make_offsets(int K, const void* offsets, DiaOffsets* out) {
  if (K < 0 || K > SPS_MAX_DIAGS) return false;
  out->k = K;
  std::memset(out->off, 0, sizeof(out->off));
  if (K) std::memcpy(out->off, offsets, sizeof(int) * (size_t)K);
  return true;
}

inline unsigned grid_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace sps
