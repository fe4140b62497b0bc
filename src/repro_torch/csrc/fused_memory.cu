// Fused Artemis worker uplink for Hopper (sm_90a): per (bm x bn) tile of
// row-major [M, N] float32 arrays g, h, u it computes, in one block,
//
//   delta  = g - h
//   norm   = ||delta||_2 over the tile
//   scale  = norm / s, or 0 when norm is not finite
//   r      = |delta| / (norm > 0 ? norm : 1) * s
//   psi    = floor(r) + (u < r - floor(r))
//   q      = int8(sign(delta) * psi)            (0 where r is NaN)
//   h_new  = h + alpha * (q * scale)
//
// and writes q, one scale per tile and h_new.  Replaces the Pallas kernel
// repro/kernels/fused_memory.py::fused_memory_update (_fused_kernel).
//
// Bound: bytes.  Per element it reads g, h, u (12 B) and writes q and h_new
// (5 B), plus 4 B per tile, at 3.35 TB/s on an H100 SXM.  It does a few
// flops per element, far below the card's compute rate.  The design keeps
// delta and q in registers (never in device memory) and reads g and h twice:
// the second pass over a small tile comes from L1/L2.
//
// Layout: one block per tile; threads stride over the tile's elements, so a
// tile of any width works (the main path's tiles are single rows of d = 2 to
// 40 elements) and the ragged edge is masked.  A warp-shuffle plus
// shared-memory reduction gives the norm (block_sum.cuh).  At d = 2^20 with
// 20 rows, one block per row keeps only 20 of the 132 SMs busy: splitting a
// row across blocks (a second pass or a cluster reduction) is a design point
// for later.  ops.memory_update runs it on (256, 256) tiles.
//
// Rounding: h + alpha * (q * scale) is computed with __fmul_rn/__fadd_rn so
// that nvcc cannot contract it into an FMA and the plain PyTorch version
// (separate multiply and add) can match it bit for bit.  The uniforms stay an
// operand, as in the Pallas kernel: the card's Philox stream is not the TPU's,
// and an operand lets the tests feed both versions the same numbers.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_sum.cuh"

namespace {

constexpr int kMaxThreads = 1024;

__global__ void fused_memory_kernel(const float* __restrict__ g,
                                    const float* __restrict__ h,
                                    const float* __restrict__ u, float alpha,
                                    int s, long long n_cols, int bm, int bn,
                                    long long tiles_per_row,
                                    int8_t* __restrict__ q,
                                    float* __restrict__ scales,
                                    float* __restrict__ h_new) {
  __shared__ float warp_sums[32];
  const long long tile = blockIdx.x;
  const long long row0 = (tile / tiles_per_row) * bm;
  const long long col0 = (tile % tiles_per_row) * bn;
  const long long tile_elems = (long long)bm * bn;

  float acc = 0.f;
  for (long long k = threadIdx.x; k < tile_elems; k += blockDim.x) {
    const long long i = (row0 + k / bn) * n_cols + col0 + k % bn;
    const float d = __fsub_rn(g[i], h[i]);
    acc = __fadd_rn(acc, __fmul_rn(d, d));
  }
  const float norm = sqrtf(block_sum(acc, warp_sums));
  const float sf = (float)s;
  const float scale = isfinite(norm) ? __fdiv_rn(norm, sf) : 0.f;
  const float safe = norm > 0.f ? norm : 1.f;
  if (threadIdx.x == 0) scales[tile] = scale;

  for (long long k = threadIdx.x; k < tile_elems; k += blockDim.x) {
    const long long i = (row0 + k / bn) * n_cols + col0 + k % bn;
    const float hv = h[i];
    const float d = __fsub_rn(g[i], hv);
    const float r = __fmul_rn(__fdiv_rn(fabsf(d), safe), sf);
    const float low = floorf(r);
    const float psi = __fadd_rn(low, u[i] < __fsub_rn(r, low) ? 1.f : 0.f);
    const float sign = d > 0.f ? 1.f : (d < 0.f ? -1.f : 0.f);
    const float qf = sign * psi;
    const int8_t qi = isnan(qf) ? (int8_t)0 : (int8_t)(int)qf;
    q[i] = qi;
    h_new[i] = __fadd_rn(hv, __fmul_rn(alpha, __fmul_rn((float)qi, scale)));
  }
}

}  // namespace

extern "C" {

// g, h, u, q, h_new: [m, n] row-major; scales: [m / bm, n / bn].  The caller
// checks that bm divides m and bn divides n.  Returns a cudaError_t.
int fused_memory_update(const float* g, const float* h, const float* u,
                        float alpha, int s, long long m, long long n, int bm,
                        int bn, int8_t* q, float* scales, float* h_new,
                        void* stream) {
  const long long tiles_per_row = n / bn;
  const long long n_tiles = (m / bm) * tiles_per_row;
  if (n_tiles == 0) return (int)cudaSuccess;
  const long long tile_elems = (long long)bm * bn;
  int threads = 32;
  while (threads < kMaxThreads && threads < tile_elems) threads <<= 1;
  fused_memory_kernel<<<(unsigned int)n_tiles, threads, 0,
                        (cudaStream_t)stream>>>(g, h, u, alpha, s, n, bm, bn,
                                                tiles_per_row, q, scales,
                                                h_new);
  return (int)cudaGetLastError();
}

const char* fused_memory_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
