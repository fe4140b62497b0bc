// Fused Artemis worker uplink for Hopper (sm_90a): per (bm x bn) tile of
// row-major [M, N] arrays g, h, u of one element type T (float32 or bf16)
// it computes
//
//   delta  = round_T(g - h)
//   norm   = ||delta||_2 over the tile, in float32
//   scale  = norm / s, or 0 when norm is not finite
//   q      = int8 levels of delta from the uniforms u
//   h_new  = round_T(h + round_T(round_T(alpha) *
//                                round_T(q * round_T(scale))))
//
// and writes q, one f32 scale per tile and h_new in T.  Replaces the Pallas
// kernel repro/kernels/fused_memory.py::fused_memory_update (_fused_kernel).
//
// It is tile_quant.cuh instantiated with a memory: the design (three
// regimes by tile size: a group of lanes per tile for the Artemis round's
// rows, a thread-block cluster holding a (256, 256) tile in registers, a
// cluster streaming a row of 2^20), its bound (bytes: 17 B an element in
// f32, 9 B in bf16, at 3.35 TB/s on an H100 SXM) and its rounding are
// stated there.  squant.cu's encode is the same design without the memory.
//
// The uniforms stay an operand, as in the Pallas kernel: the card's Philox
// stream is not the TPU's, and an operand lets the tests feed both versions
// the same numbers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_quant.cuh"

extern "C" {

// g, h, u, q, h_new: [m, n] row-major, g, h, u and h_new bf16 when bf16,
// else float32; scales: [m / bm, n / bn] float32.  The caller checks that
// bm divides m and bn divides n, and that the tile count and bm * bn fit
// in 31 bits.  Returns a cudaError_t.
int fused_memory_update(const void* g, const void* h, const void* u,
                        int bf16, float alpha, int s, long long m,
                        long long n, int bm, int bn, int8_t* q,
                        float* scales, void* h_new, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    typedef __nv_bfloat16 T;
    return tile_quant::launch<T, T, true>(
        (const T*)g, (const T*)h, (const T*)u, alpha, s, m, n, bm, bn, q,
        scales, (T*)h_new, st);
  }
  return tile_quant::launch<float, float, true>(
      (const float*)g, (const float*)h, (const float*)u, alpha, s, m, n, bm,
      bn, q, scales, (float*)h_new, st);
}

const char* fused_memory_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
