// Deterministic sum over one block, shared by the tile-reducing kernels
// (fused_memory.cu, squant.cu).  Each warp folds its 32 values with
// shuffles, warp 0 folds the warps' partial sums; the order depends only on
// blockDim.x, so the same inputs give the same sum on every run (no float
// atomics).  Every thread of the block must call it; it returns the sum to
// all of them.  warp_sums holds at least 32 floats of shared memory.
#pragma once
#include <cuda_runtime.h>

__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    v = lane < n_warps ? warp_sums[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) warp_sums[0] = v;
  }
  __syncthreads();
  return warp_sums[0];
}
