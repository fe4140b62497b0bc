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
// encode: tile_quant.cuh without a memory, the design B1 (fused_memory.cu)
// shares: a group of 4-32 lanes a tile for tiles of at most 1024 elements;
// larger tiles split across a thread-block cluster of up to 16 CTAs that
// sums the norm in rank order through distributed shared memory
// (tile_norm.cuh: no float atomics, so the same inputs give the same levels
// on every run), holding its share in registers ((256, 256) tiles) or
// streaming it twice (rows of 2^20).  x and u are each f32 or bf16.
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
// dequant_apply: decode's design with w read beside the levels.  A thread
// takes a chunk of 16 levels (one 16-byte load) and its tile's scale, once
// a chunk; after the warp's trade each lane reads and writes 16-byte slots
// of w and w' that cover 512 contiguous bytes across the warp, its loads of
// w issued before the trade.  Levels become floats by a byte permute into
// 2^23's mantissa and one subtraction (warp_trade.cuh's level<k>), not the
// quarter-rate int-to-float unit.  The same blocks as decode's take one
// element a thread.
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
#include <stdint.h>

#include "grid.cuh"
#include "tile_quant.cuh"
#include "warp_trade.cuh"

namespace {

constexpr int kThreads = 256;       // decode, dequant_apply: threads per block
constexpr int kWaves = 4;           // decode: at most 4 waves of blocks
constexpr int kVec = 16;            // decode: elements a thread takes

using tile_quant::bf16;
using tile_quant::round_to;
using tile_quant::widen;

// 16 bytes of T at p (16-byte aligned): 4 f32 or 8 bf16 values, each
// rounded to T
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(bf16* p, const float* v) {
  __nv_bfloat162 h[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<int4*>(p) = *reinterpret_cast<const int4*>(h);
}

// the 4 f32 or 8 bf16 values of a 16-byte word loaded from T, as floats
template <typename T>
__device__ __forceinline__ void widen16_as(const int4& raw, float* v) {
  if constexpr (sizeof(T) == 4) {
    const float4 f = *reinterpret_cast<const float4*>(&raw);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x, v[2 * k + 1] = f.y;
    }
  }
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
      if (live) tile_quant::put(out + i, __fmul_rn((float)q[i], sc));
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
        store16(base + j * kPer, x);
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
      for (int v = 0; v < kE / kPer; ++v) store16(out + i + v * kPer,
                                                x + v * kPer);
    }
  }
}

// w - gamma * (q * scale), each operation rounded to T; g and sc are
// already rounded to T
template <typename T>
__device__ __forceinline__ float apply(float w, float qf, float sc,
                                       float g) {
  const float dq = round_to<T>(__fmul_rn(qf, sc));
  return __fsub_rn(w, round_to<T>(__fmul_rn(g, dq)));
}

// kE = 16: the vector path, a grid-stride loop over 16-level chunks;
// kE = 1: one element a thread, a row of the array per blockIdx.y (striding
// when M > 65535) and its columns over the x threads, so that a row's tile
// offset is found once and no element needs a 64-bit division
template <typename T, int kE>
__global__ void dequant_apply_kernel(const T* __restrict__ w,
                                     const int8_t* __restrict__ q,
                                     const float* __restrict__ scales,
                                     float gamma, long long m, long long n,
                                     int bm, int bn, long long tiles_per_row,
                                     T* __restrict__ out) {
  const float g = round_to<T>(gamma);
  if constexpr (kE == 1) {
    for (long long row = blockIdx.y; row < m; row += gridDim.y) {
      const long long tile_row = (row / bm) * tiles_per_row;
      for (int col = blockIdx.x * blockDim.x + threadIdx.x; col < n;
           col += gridDim.x * blockDim.x) {
        const long long i = row * n + col;
        const float sc = round_to<T>(scales[tile_row + col / bn]);
        tile_quant::put(out + i, apply<T>(widen(w[i]), (float)q[i], sc, g));
      }
    }
  } else {
    constexpr int kPer = 16 / sizeof(T);     // values in a 16-byte slot
    constexpr int kSlots = kE / kPer;        // 16-byte slots a lane takes
    __shared__ int4 levels[kThreads];
    __shared__ float tile_scale[kThreads];
    const int lane = threadIdx.x & 31, warp0 = threadIdx.x - lane;
    const long long total = m * n / kE;
    // a warp takes 32 consecutive chunks; chunk k is w[k * kE ...]
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
      if (k0 + 32 <= total) {
        // The warp's 32 chunks are 512 consecutive values.  Each lane loads
        // its chunk's 16 levels and scale and its slots of w (slot j = v * 32
        // + lane of the warp's 512 values), then the warp trades the levels
        // and scales through shared memory, so that every 16-byte load of w
        // and store of w' covers 512 contiguous bytes across the warp.
        const int4 lv = *reinterpret_cast<const int4*>(q + i);
        const T* wb = w + k0 * kE;
        int4 wr[kSlots];
#pragma unroll
        for (int v = 0; v < kSlots; ++v)
          wr[v] = *reinterpret_cast<const int4*>(wb + (v * 32 + lane) * kPer);
        levels[threadIdx.x] = lv;
        tile_scale[threadIdx.x] = sc;
        __syncwarp();
        const unsigned int* words =
            reinterpret_cast<const unsigned int*>(levels + warp0);
        T* ob = out + k0 * kE;
#pragma unroll
        for (int v = 0; v < kSlots; ++v) {
          const int j = v * 32 + lane;           // the warp's j-th slot
          const float s_j = tile_scale[warp0 + j * kPer / kE];
          float x[kPer];
          widen16_as<T>(wr[v], x);
#pragma unroll
          for (int t = 0; t < kPer / 4; ++t) {
            const unsigned int b = words[j * (kPer / 4) + t] ^ 0x80808080u;
            x[4 * t] = apply<T>(x[4 * t], level<0>(b), s_j, g);
            x[4 * t + 1] = apply<T>(x[4 * t + 1], level<1>(b), s_j, g);
            x[4 * t + 2] = apply<T>(x[4 * t + 2], level<2>(b), s_j, g);
            x[4 * t + 3] = apply<T>(x[4 * t + 3], level<3>(b), s_j, g);
          }
          store16(ob + j * kPer, x);
        }
        __syncwarp();
      } else if (live) {
        // the array's last, partial warp: each lane its own chunk
        const int4 lv = *reinterpret_cast<const int4*>(q + i);
        const unsigned int* words = reinterpret_cast<const unsigned int*>(&lv);
#pragma unroll
        for (int v = 0; v < kSlots; ++v) {
          float x[kPer];
          widen16_as<T>(*reinterpret_cast<const int4*>(w + i + v * kPer), x);
#pragma unroll
          for (int t = 0; t < kPer / 4; ++t) {
            const unsigned int b = words[v * (kPer / 4) + t] ^ 0x80808080u;
            x[4 * t] = apply<T>(x[4 * t], level<0>(b), sc, g);
            x[4 * t + 1] = apply<T>(x[4 * t + 1], level<1>(b), sc, g);
            x[4 * t + 2] = apply<T>(x[4 * t + 2], level<2>(b), sc, g);
            x[4 * t + 3] = apply<T>(x[4 * t + 3], level<3>(b), sc, g);
          }
          store16(out + i + v * kPer, x);
        }
      }
    }
  }
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

template <typename T, int kE>
int apply_launch(const void* w, const int8_t* q, const float* scales,
                 float gamma, long long m, long long n, int bm, int bn,
                 void* out, cudaStream_t stream) {
  // one element a thread: a block row per array row, up to 65535
  const dim3 grid =
      kE == 1 ? dim3((unsigned int)((n + kThreads - 1) / kThreads),
                     (unsigned int)(m < 65535 ? m : 65535))
              : dim3(stride_grid(dequant_apply_kernel<T, kE>, m * n / kE,
                                 kThreads, kWaves));
  dequant_apply_kernel<T, kE><<<grid, kThreads, 0, stream>>>(
      (const T*)w, q, scales, gamma, m, n, bm, bn, n / bn, (T*)out);
  return (int)cudaGetLastError();
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
  cudaStream_t st = (cudaStream_t)stream;
  using tile_quant::launch;
  if (x_bf16 && u_bf16)
    return launch<bf16, bf16, false>((const bf16*)x, nullptr,
                                     (const bf16*)u, 0.f, s, m, n, bm, bn,
                                     q, scales, nullptr, st);
  if (x_bf16)
    return launch<bf16, float, false>((const bf16*)x, nullptr,
                                      (const float*)u, 0.f, s, m, n, bm, bn,
                                      q, scales, nullptr, st);
  if (u_bf16)
    return launch<float, bf16, false>((const float*)x, nullptr,
                                      (const bf16*)u, 0.f, s, m, n, bm, bn,
                                      q, scales, nullptr, st);
  return launch<float, float, false>((const float*)x, nullptr,
                                     (const float*)u, 0.f, s, m, n, bm, bn,
                                     q, scales, nullptr, st);
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
    return vec ? decode<bf16, kVec>(q, scales, m, n, bm, bn, out, st)
               : decode<bf16, 1>(q, scales, m, n, bm, bn, out, st);
  return vec ? decode<float, kVec>(q, scales, m, n, bm, bn, out, st)
             : decode<float, 1>(q, scales, m, n, bm, bn, out, st);
}

// w, q, out: [m, n] row-major (n < 2^31); scales: [m / bm, n / bn]; w and
// out are bf16 when w_bf16, else f32.  Returns a cudaError_t.
int dequant_apply(const void* w, int w_bf16, const int8_t* q,
                  const float* scales, float gamma, long long m, long long n,
                  int bm, int bn, void* out, void* stream) {
  if (m == 0 || n == 0) return (int)cudaSuccess;
  const bool vec = n % kVec == 0 && bn % kVec == 0 && aligned16(q) &&
                   aligned16(w) && aligned16(out);
  cudaStream_t st = (cudaStream_t)stream;
  if (w_bf16)
    return vec ? apply_launch<bf16, kVec>(w, q, scales, gamma, m, n, bm, bn,
                                          out, st)
               : apply_launch<bf16, 1>(w, q, scales, gamma, m, n, bm, bn,
                                       out, st);
  return vec ? apply_launch<float, kVec>(w, q, scales, gamma, m, n, bm, bn,
                                         out, st)
             : apply_launch<float, 1>(w, q, scales, gamma, m, n, bm, bn, out,
                                      st);
}

const char* squant_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
