// Deterministic sum over one tile split across the CTAs of a thread-block
// cluster (Hopper, sm_90), for the two-pass tile kernels: a tile's norm
// first, then the quantize pass that needs it (fused_memory.cu; squant.cu's
// encode has the same structure).
//
// Each CTA folds its threads' partial sums with block_sum (block_sum.cuh),
// which leaves the CTA's sum in warp_sums[0] of its shared memory.  After a
// cluster.sync(), lane r of every warp reads rank r's partial through
// distributed shared memory (cluster.map_shared_rank), and the warp folds
// the partials in rank order with shuffles, starting from 0.0f.  So every
// thread of every CTA of the cluster gets the same sum from the same order,
// and the same inputs give the same bits on every run (no atomics).
//
// Rules for the caller: every thread of the CTA calls it; blockDim.x is a
// multiple of 32; the cluster has at most 32 CTAs; warp_sums holds at least
// 32 floats of shared memory and is not written again; and the kernel calls
// cluster.sync() once more before it exits, so that no CTA leaves (and
// frees its shared memory) while another still reads its partial.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "block_sum.cuh"

__device__ __forceinline__ float cluster_tile_sum(float v, float* warp_sums) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  block_sum(v, warp_sums);          // this CTA's partial, in warp_sums[0]
  cluster.sync();                   // every CTA's partial is written
  const int lane = threadIdx.x & 31;
  const int ranks = (int)cluster.num_blocks();
  const float p = lane < ranks ? *cluster.map_shared_rank(warp_sums, lane)
                               : 0.f;
  float total = 0.f;
  for (int r = 0; r < ranks; ++r)
    total = __fadd_rn(total, __shfl_sync(0xffffffffu, p, r));
  return total;
}
