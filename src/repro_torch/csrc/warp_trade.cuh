// The warp trade of the 16-level kernels (bucket_ring.cu, ring_sum.cu):
// int8 levels folded into float32 sums, 16 levels a thread, with every
// float4 access of a warp on 512 contiguous bytes.
//
// A warp takes 32 consecutive chunks of 16 levels: 512 consecutive values
// of its output.  Each lane loads its own chunk's levels (one 16-byte load)
// and row scale.  Stored as they were loaded, a lane's 16 results would put
// each float4 store of the warp on 16 cache lines, a quarter of each.  So the
// warp trades the levels and scales through shared memory: afterwards lane
// `lane` holds, for v = 0..3, the 4 levels and the scale of the warp's float4
// number v * 32 + lane, and its loads and stores of those float4s cover 512
// contiguous bytes across the warp.
//
// Rounding: fold is __fmul_rn then __fadd_rn, so nvcc cannot contract it
// into an FMA and a chain of folds equals the plain PyTorch
// decode-then-add (acc + float(q) * scale, two roundings) bit for bit.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kChunk = 16;          // levels a thread takes

__device__ __forceinline__ float fold(float a, int8_t q, float sc) {
  return __fadd_rn(a, __fmul_rn((float)q, sc));
}

// float(level k of the 4 packed in word ^ 0x80808080), exactly: the byte
// b = q + 128 goes into the low mantissa bits of 2^23 (one byte permute),
// and 2^23 + 128 comes off again (one add).  The int-to-float conversion
// unit runs at a quarter of the add's rate, and at 16 levels a thread it,
// not memory, would set the pace.
template <int k>
__device__ __forceinline__ float level(unsigned int biased) {
  return __fsub_rn(__uint_as_float(__byte_perm(biased, 0x4B000000u,
                                               0x7650u | k)),
                   8388736.0f);
}

// a + float(the 4 levels packed in word) * sc, elementwise; the same bits
// as fold on each level
__device__ __forceinline__ float4 fold4(float4 a, int word, float sc) {
  const unsigned int biased = (unsigned int)word ^ 0x80808080u;
  return make_float4(__fadd_rn(a.x, __fmul_rn(level<0>(biased), sc)),
                     __fadd_rn(a.y, __fmul_rn(level<1>(biased), sc)),
                     __fadd_rn(a.z, __fmul_rn(level<2>(biased), sc)),
                     __fadd_rn(a.w, __fmul_rn(level<3>(biased), sc)));
}

// The trade.  levels and scales are the warp's 32 slots of shared memory
// (16-byte aligned); every lane of the warp must call it.  On return
// word[v] holds the 4 levels and s4[v] the scale of the warp's float4
// number v * 32 + lane.  It ends in a __syncwarp, so the slots may be
// written again at once.
__device__ __forceinline__ void trade16(int4 lv, float sc, int4* levels,
                                        float* scales, int lane,
                                        int word[4], float s4[4]) {
  levels[lane] = lv;
  scales[lane] = sc;
  __syncwarp();
  const int* words = reinterpret_cast<const int*>(levels);
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const int j = v * 32 + lane;            // the warp's j-th float4
    word[v] = words[j];
    s4[v] = scales[j / 4];
  }
  __syncwarp();
}
