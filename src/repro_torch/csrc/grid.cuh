// Launch helpers of the port's grid-stride elementwise kernels.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// Enough blocks of `threads` for `work` items, at most `waves` times the
// blocks the card holds at once (blocks resident per SM x SMs), so each
// thread loops over several items of a large array and a small one still
// fills as many SMs as it can.
template <typename Kernel>
unsigned int stride_grid(Kernel kernel, long long work, int threads,
                         int waves) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  const long long blocks = (work + threads - 1) / threads;
  const long long cap = (long long)(sms > 0 ? sms : 1) *
                        (per_sm > 0 ? per_sm : 1) * waves;
  return (unsigned int)(blocks < cap ? blocks : cap);
}

// Whether p may be read or written 16 bytes at a time.
inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}
