// Per-tile stochastic s-quantization for Hopper (sm_90a): the three kernels
// behind the shape-agnostic compression API (kernels/ops.py).  For row-major
// [M, N] arrays cut into (bm x bn) tiles (tile (i, j) covers rows i*bm.. and
// columns j*bn..), with one f32 scale per tile:
//
//   squant_encode   x, u f32 or bf16 (each on its own), math in f32:
//                     norm  = ||x||_2 over the tile
//                     scale = norm / s, or 0 when norm is not finite
//                     r     = |x| / (norm > 0 ? norm : 1) * s
//                     q     = int8(sign(x) * (floor(r) + (u < r - floor(r))))
//                             (0 where r is NaN)
//   squant_decode   out = q * scale, written as f32 or bf16
//   dequant_apply   out = w - gamma * (q * scale), in w's type (f32 or bf16)
//
// Replaces the Pallas kernels of repro/kernels/squant.py: squant_encode
// (_encode_kernel), squant_decode (_decode_kernel) and dequant_apply
// (_dequant_apply_kernel).
//
// Bound: bytes, on an H100 SXM at 3.35 TB/s; each does a few float ops per
// element, far below the card's compute rate.  encode reads x and u and
// writes q (9 B per element in f32) plus 4 B per tile; decode reads q and
// writes out (5 B in f32); dequant_apply reads w and q and writes out (9 B
// in f32).
//
// encode: one block per tile, B1's two-pass design (fused_memory.cu) on a
// 2-D tile.  Pass 1 sums x*x into a deterministic block reduction
// (block_sum.cuh: no float atomics, so the same inputs give the same levels
// on every run); pass 2 re-reads x and u, from L2 for the reference's
// 256 x 256 tiles (256 KiB of f32, more than one SM's shared memory), and
// writes the levels.  One block per tile leaves SMs idle when the array has
// few tiles (16 blocks on 132 SMs at [4096, 256]): splitting a tile's
// reduction across blocks is a design point for later.
//
// decode: a grid-stride loop over chunks of 16 consecutive elements of a
// row, sized to a few waves of the card's SMs (grid.cuh: 256 blocks at
// [4096, 256], not one per row).  When N and bn are multiples of 16 and q and
// out are 16-byte aligned, a chunk lies in one tile: a thread makes one
// 16-byte load of q and one scale load; a warp's 32 chunks are 512
// consecutive values, and the warp trades levels and scales through shared
// memory so that each thread's 16-byte stores (four in f32, two of 8 bf16 in
// bf16) cover 512 contiguous bytes across the warp.  Any other block takes
// one element a thread in the same kernel.
//
// dequant_apply: elementwise over a 2-D grid, one row of the array per
// blockIdx.y (striding when M > 65535) and one element per thread along it;
// each thread reads its tile's scale, which the threads of a row share
// through the cache.
//
// Rounding: the arithmetic uses __fmul_rn/__fsub_rn/__fdiv_rn/__fsqrt_rn so
// that nvcc cannot contract it into an FMA (and with IEEE division, not the
// fast approximate one), so the plain PyTorch versions repeat it bit for bit.
// In bf16 each operation is rounded to bf16 after it, as PyTorch's bf16
// operations are (compute in f32, round): the scale and gamma are rounded to
// bf16 first, then q * scale, gamma * (q * scale) and w - ... each in turn.
// The product of q and a bf16 scale is exact in f32, so its rounding equals a
// bf16 multiply.  The uniforms u stay an operand, as in the Pallas kernel, so
// the tests can feed both versions the same numbers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_sum.cuh"
#include "grid.cuh"

namespace {

constexpr int kMaxThreads = 1024;   // encode: threads per tile
constexpr int kThreads = 256;       // decode, dequant_apply: threads per block
constexpr int kWaves = 4;           // decode: at most 4 waves of blocks
constexpr int kVec = 16;            // decode: elements a thread takes

__device__ __forceinline__ float load(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i,
                                      float v) {
  p[i] = __float2bfloat16_rn(v);
}

// v rounded to the element type T and back: exact for f32
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename TX, typename TU>
__global__ void squant_encode_kernel(const TX* __restrict__ x,
                                     const TU* __restrict__ u, int s,
                                     long long n, int bm, int bn,
                                     long long tiles_per_row,
                                     int8_t* __restrict__ q,
                                     float* __restrict__ scales) {
  __shared__ float warp_sums[32];
  const long long tile = blockIdx.x;
  const long long row0 = (tile / tiles_per_row) * bm;
  const long long col0 = (tile % tiles_per_row) * bn;
  const int tile_elems = bm * bn;     // the wrapper keeps it below 2^31

  float acc = 0.f;
  for (int k = threadIdx.x; k < tile_elems; k += blockDim.x) {
    const int r = k / bn;
    const float v = load(x, (row0 + r) * n + col0 + (k - r * bn));
    acc = __fadd_rn(acc, __fmul_rn(v, v));
  }
  const float norm = __fsqrt_rn(block_sum(acc, warp_sums));
  const float sf = (float)s;
  const float scale = isfinite(norm) ? __fdiv_rn(norm, sf) : 0.f;
  const float safe = norm > 0.f ? norm : 1.f;
  if (threadIdx.x == 0) scales[tile] = scale;

  for (int k = threadIdx.x; k < tile_elems; k += blockDim.x) {
    const int r = k / bn;
    const long long i = (row0 + r) * n + col0 + (k - r * bn);
    const float v = load(x, i);
    const float ratio = __fmul_rn(__fdiv_rn(fabsf(v), safe), sf);
    const float low = floorf(ratio);
    const float psi =
        __fadd_rn(low, load(u, i) < __fsub_rn(ratio, low) ? 1.f : 0.f);
    const float sign = v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
    const float qf = __fmul_rn(sign, psi);
    q[i] = isnan(qf) ? (int8_t)0 : (int8_t)(int)qf;
  }
}

// 16 bytes of T at p (16-byte aligned): 4 f32 or 8 bf16 values, each
// rounded to T
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 h[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<int4*>(p) = *reinterpret_cast<const int4*>(h);
}

// kE = 16: the vector path; kE = 1: one element a thread
template <typename T, int kE>
__global__ void squant_decode_kernel(const int8_t* __restrict__ q,
                                     const float* __restrict__ scales,
                                     long long m, long long n, int bm, int bn,
                                     long long tiles_per_row,
                                     T* __restrict__ out) {
  constexpr int kPer = 16 / sizeof(T);     // values in a 16-byte store
  __shared__ int4 levels[kThreads];
  __shared__ float tile_scale[kThreads];
  const int lane = threadIdx.x & 31, warp0 = threadIdx.x - lane;
  const long long total = m * n / kE;
  // a warp takes 32 consecutive chunks; chunk k is out[k * kE ...]
  for (long long k0 = blockIdx.x * (long long)blockDim.x + warp0;
       k0 < total; k0 += (long long)gridDim.x * blockDim.x) {
    const long long k = k0 + lane;
    const bool live = k < total;
    const long long i = k * kE;
    float sc = 0.f;
    if (live) {
      const long long row = i / n;
      const long long col = i - row * n;
      sc = round_to<T>(scales[(row / bm) * tiles_per_row + col / bn]);
    }
    if constexpr (kE == 1) {
      if (live) store(out, i, __fmul_rn((float)q[i], sc));
    } else if (k0 + 32 <= total) {
      // The warp's 32 chunks are 512 consecutive values.  Each lane loads
      // its chunk's 16 levels and scale, and the warp trades them through
      // shared memory, so that every 16-byte store of the warp covers 512
      // contiguous bytes.
      levels[threadIdx.x] = *reinterpret_cast<const int4*>(q + i);
      tile_scale[threadIdx.x] = sc;
      __syncwarp();
      const int8_t* lv = reinterpret_cast<const int8_t*>(levels + warp0);
      T* base = out + k0 * kE;
#pragma unroll
      for (int v = 0; v < kE / kPer; ++v) {
        const int j = v * 32 + lane;           // the warp's j-th store
        int words[kPer / 4];
#pragma unroll
        for (int t = 0; t < kPer / 4; ++t)
          words[t] = reinterpret_cast<const int*>(lv)[j * (kPer / 4) + t];
        const int8_t* b = reinterpret_cast<const int8_t*>(words);
        const float s_j = tile_scale[warp0 + j * kPer / kE];
        float x[kPer];
#pragma unroll
        for (int t = 0; t < kPer; ++t) x[t] = __fmul_rn((float)b[t], s_j);
        store_vec(base + j * kPer, x);
      }
      __syncwarp();
    } else if (live) {
      // the array's last, partial warp: each lane its own chunk
      const int4 qv = *reinterpret_cast<const int4*>(q + i);
      const int8_t* b = reinterpret_cast<const int8_t*>(&qv);
      float x[kE];
#pragma unroll
      for (int t = 0; t < kE; ++t) x[t] = __fmul_rn((float)b[t], sc);
#pragma unroll
      for (int v = 0; v < kE / kPer; ++v) store_vec(out + i + v * kPer,
                                                  x + v * kPer);
    }
  }
}

template <typename T>
__global__ void dequant_apply_kernel(const T* __restrict__ w,
                                     const int8_t* __restrict__ q,
                                     const float* __restrict__ scales,
                                     float gamma, long long m, int n, int bm,
                                     int bn, long long tiles_per_row,
                                     T* __restrict__ out) {
  const float g = round_to<T>(gamma);
  for (long long row = blockIdx.y; row < m; row += gridDim.y) {
    const long long tile_row = (row / bm) * tiles_per_row;
    for (int col = blockIdx.x * blockDim.x + threadIdx.x; col < n;
         col += gridDim.x * blockDim.x) {
      const long long i = row * n + col;
      const float sc = round_to<T>(scales[tile_row + col / bn]);
      const float dq = round_to<T>(__fmul_rn((float)q[i], sc));
      const float step = round_to<T>(__fmul_rn(g, dq));
      store(out, i, __fsub_rn(load(w, i), step));
    }
  }
}

int encode_threads(long long tile_elems) {
  int threads = 32;
  while (threads < kMaxThreads && threads < tile_elems) threads <<= 1;
  return threads;
}

template <typename T, int kE>
int decode(const int8_t* q, const float* scales, long long m, long long n,
           int bm, int bn, void* out, cudaStream_t stream) {
  const unsigned int blocks = stride_grid(squant_decode_kernel<T, kE>,
                                          m * n / kE, kThreads, kWaves);
  squant_decode_kernel<T, kE><<<blocks, kThreads, 0, stream>>>(
      q, scales, m, n, bm, bn, n / bn, (T*)out);
  return (int)cudaGetLastError();
}

dim3 elementwise_grid(long long m, long long n) {
  const long long gx = (n + kThreads - 1) / kThreads;
  return dim3((unsigned int)gx, (unsigned int)(m < 65535 ? m : 65535));
}

}  // namespace

extern "C" {

// x, u, q: [m, n] row-major; scales: [m / bm, n / bn].  x_bf16 and u_bf16
// say whether x and u are bf16 (else f32).  The caller checks that the
// block tiles the shape, that a tile has fewer than 2^31 elements and that
// there are fewer than 2^31 tiles.  Returns a cudaError_t.
int squant_encode(const void* x, int x_bf16, const void* u, int u_bf16,
                  int s, long long m, long long n, int bm, int bn, int8_t* q,
                  float* scales, void* stream) {
  const long long tiles_per_row = n / bn;
  const long long n_tiles = (m / bm) * tiles_per_row;
  if (n_tiles == 0) return (int)cudaSuccess;
  const int threads = encode_threads((long long)bm * bn);
  const unsigned int grid = (unsigned int)n_tiles;
  cudaStream_t st = (cudaStream_t)stream;
  typedef __nv_bfloat16 bf16;
  if (x_bf16 && u_bf16)
    squant_encode_kernel<bf16, bf16><<<grid, threads, 0, st>>>(
        (const bf16*)x, (const bf16*)u, s, n, bm, bn, tiles_per_row, q,
        scales);
  else if (x_bf16)
    squant_encode_kernel<bf16, float><<<grid, threads, 0, st>>>(
        (const bf16*)x, (const float*)u, s, n, bm, bn, tiles_per_row, q,
        scales);
  else if (u_bf16)
    squant_encode_kernel<float, bf16><<<grid, threads, 0, st>>>(
        (const float*)x, (const bf16*)u, s, n, bm, bn, tiles_per_row, q,
        scales);
  else
    squant_encode_kernel<float, float><<<grid, threads, 0, st>>>(
        (const float*)x, (const float*)u, s, n, bm, bn, tiles_per_row, q,
        scales);
  return (int)cudaGetLastError();
}

// q, out: [m, n] row-major (n < 2^31); scales: [m / bm, n / bn]; out is
// bf16 when out_bf16, else f32.  Returns a cudaError_t.
int squant_decode(const int8_t* q, const float* scales, long long m,
                  long long n, int bm, int bn, void* out, int out_bf16,
                  void* stream) {
  if (m == 0 || n == 0) return (int)cudaSuccess;
  const bool vec = n % kVec == 0 && bn % kVec == 0 && aligned16(q) &&
                   aligned16(out);
  cudaStream_t st = (cudaStream_t)stream;
  if (out_bf16)
    return vec ? decode<__nv_bfloat16, kVec>(q, scales, m, n, bm, bn, out, st)
               : decode<__nv_bfloat16, 1>(q, scales, m, n, bm, bn, out, st);
  return vec ? decode<float, kVec>(q, scales, m, n, bm, bn, out, st)
             : decode<float, 1>(q, scales, m, n, bm, bn, out, st);
}

// w, q, out: [m, n] row-major (n < 2^31); scales: [m / bm, n / bn]; w and
// out are bf16 when w_bf16, else f32.  Returns a cudaError_t.
int dequant_apply(const void* w, int w_bf16, const int8_t* q,
                  const float* scales, float gamma, long long m, long long n,
                  int bm, int bn, void* out, void* stream) {
  if (m == 0 || n == 0) return (int)cudaSuccess;
  const dim3 grid = elementwise_grid(m, n);
  cudaStream_t st = (cudaStream_t)stream;
  if (w_bf16)
    dequant_apply_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)w, q, scales, gamma, m, (int)n, bm, bn,
        n / bn, (__nv_bfloat16*)out);
  else
    dequant_apply_kernel<float><<<grid, kThreads, 0, st>>>(
        (const float*)w, q, scales, gamma, m, (int)n, bm, bn, n / bn,
        (float*)out);
  return (int)cudaGetLastError();
}

const char* squant_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
