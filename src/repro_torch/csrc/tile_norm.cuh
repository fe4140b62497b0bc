// Deterministic sum over one tile split across the CTAs of a thread-block
// cluster (Hopper, sm_90), for the two-pass tile kernels (tile_quant.cuh:
// squant.cu's encode and fused_memory.cu): a tile's norm first, then the
// quantize pass that needs it.
//
// The partials are pushed, not pulled.  Every thread arrives (relaxed) on
// the cluster barrier when the kernel starts (cluster_start).  Each CTA
// folds its threads' partial sums with block_sum (block_sum.cuh), waits on
// that first barrier (every CTA of the cluster has started, so its shared
// memory may be written; by then this wait costs nothing), and thread r
// stores the CTA's partial into slot [own rank] of rank r's shared memory
// (distributed shared memory).  A second barrier, arrive with release and
// wait with acquire, makes every partial visible; each warp then reads its
// own CTA's slots and folds them in rank order with shuffles, starting from
// 0.0f.  So every thread of every CTA of the cluster gets the same sum from
// the same order, and the same inputs give the same bits on every run (no
// atomics).  No CTA touches another's shared memory after the second
// barrier, so the kernel exits without a third.  Against pulling the
// partials after one barrier and guarding the exit with another, B1 took
// up to 0.7 µs less a launch at the compression API's shapes and 2-3 %
// more on a 67 M-element probe (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// Rules for the caller: every thread of the CTA calls cluster_start()
// once, first, and cluster_tile_sum() once; blockDim.x is a multiple of 32;
// the cluster has at most 32 CTAs; warp_sums (32 floats) and slots (one
// float per CTA of the cluster) are shared memory that nothing else writes.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "block_sum.cuh"

__device__ __forceinline__ void cluster_start() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float cluster_tile_sum(float v, float* warp_sums,
                                                  float* slots) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const float part = block_sum(v, warp_sums);    // this CTA's partial
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  const int ranks = (int)cluster.num_blocks();
  const int me = (int)cluster.block_rank();
  if ((int)threadIdx.x < ranks)
    *cluster.map_shared_rank(slots + me, (int)threadIdx.x) = part;
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  const int lane = threadIdx.x & 31;
  const float p = lane < ranks ? slots[lane] : 0.f;
  float total = 0.f;
  for (int r = 0; r < ranks; ++r)
    total = __fadd_rn(total, __shfl_sync(0xffffffffu, p, r));
  return total;
}
