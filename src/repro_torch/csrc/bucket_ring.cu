// One hop of the bucketed ring for Hopper (sm_90a): for acc [M, C] float32,
// q [M, C] int8 and scales [M, 1] float32 (M = every leading axis flattened:
// workers x buckets x rows) it computes
//
//   out[m, c] = acc[m, c] + float(q[m, c]) * scales[m]
//
// Replaces the Pallas kernel repro/kernels/bucket_ring.py::bucket_acc
// (_acc_kernel).  The Pallas kernel's block_rows tiles TPU VMEM; a grid-stride
// loop with one thread per element needs no tiling, so it has no counterpart.
//
// Bound: bytes.  Per element it reads 4 + 1 bytes and writes 4, plus 4 bytes
// of scale per row, at 3.35 TB/s on an H100 SXM; the 2 flops per element are
// far below the compute rate.  Neighbouring threads touch neighbouring
// elements, so every load and store is coalesced; the scale of a row is read
// by the C threads of the row from the same cache line.
//
// Rounding: __fmul_rn then __fadd_rn, so nvcc cannot contract the expression
// into an FMA.  Only then does the ring of these hops equal the decode-then-add
// ring (acc + (float(q) * scale), two roundings) bit for bit: the reference's
// invariant (DESIGN.md §7).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void bucket_acc_kernel(const float* __restrict__ acc,
                                  const int8_t* __restrict__ q,
                                  const float* __restrict__ scales,
                                  float* __restrict__ out, long long total,
                                  long long c) {
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    out[t] = __fadd_rn(acc[t], __fmul_rn((float)q[t], scales[t / c]));
  }
}

}  // namespace

extern "C" {

// acc, q, out: m * c contiguous elements; scales: m contiguous floats.
// Returns a cudaError_t.
int bucket_acc(const float* acc, const int8_t* q, const float* scales,
               float* out, long long m, long long c, void* stream) {
  const long long total = m * c;
  if (total == 0) return (int)cudaSuccess;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  bucket_acc_kernel<<<(unsigned int)blocks, kThreads, 0,
                      (cudaStream_t)stream>>>(acc, q, scales, out, total, c);
  return (int)cudaGetLastError();
}

const char* bucket_ring_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
