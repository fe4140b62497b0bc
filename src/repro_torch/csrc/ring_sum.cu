// Server dequant-accumulate for Hopper (sm_90a): for q [N, M, C] int8 and
// scales [N, M, 1] float32 it computes
//
//   out[m, c] = sum_{i = 0..N-1} q[i, m, c] * scales[i, m]
//
// in worker order with one write per output element.  Replaces the Pallas
// kernel repro/kernels/ring_sum.py::ring_sum (_ring_sum_kernel).
//
// Bound: bytes.  It reads N * M * C int8 levels and N * M scales and writes
// M * C floats, at 3.35 TB/s on an H100 SXM; the 2 flops per level are far
// below the compute rate.  One thread per output element keeps the running
// sum in a register, so no partial sum ever goes to device memory.
//
// Strides: the first two axes of q and scales may have any strides (the
// Artemis round hands it a transposed [M, N] worker layout without a copy);
// the last axis of q must be contiguous.
//
// Rounding: acc = acc + float(q) * scale with __fmul_rn/__fadd_rn, starting
// from 0, so nvcc cannot contract it into an FMA and the plain PyTorch loop
// (acc = acc + q[i].float() * s[i]) matches it bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void ring_sum_kernel(const int8_t* __restrict__ q,
                                const float* __restrict__ scales,
                                float* __restrict__ out, int n, long long m,
                                long long c, long long q_sn, long long q_sm,
                                long long s_sn, long long s_sm) {
  const long long total = m * c;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long mi = t / c, ci = t % c;
    const int8_t* qp = q + mi * q_sm + ci;
    const float* sp = scales + mi * s_sm;
    float acc = 0.f;
    for (int i = 0; i < n; ++i)
      acc = __fadd_rn(acc, __fmul_rn((float)qp[i * q_sn], sp[i * s_sn]));
    out[t] = acc;
  }
}

}  // namespace

extern "C" {

// out: [m, c] contiguous.  Strides are in elements.  Returns a cudaError_t.
int ring_sum(const int8_t* q, const float* scales, float* out, int n,
             long long m, long long c, long long q_sn, long long q_sm,
             long long s_sn, long long s_sm, void* stream) {
  const long long total = m * c;
  if (total == 0) return (int)cudaSuccess;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  ring_sum_kernel<<<(unsigned int)blocks, kThreads, 0,
                    (cudaStream_t)stream>>>(q, scales, out, n, m, c, q_sn,
                                            q_sm, s_sn, s_sm);
  return (int)cudaGetLastError();
}

const char* ring_sum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
