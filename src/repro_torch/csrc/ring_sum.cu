// Server dequant-accumulate for Hopper (sm_90a): for q [N, M, C] int8 and
// scales [N, M, 1] float32 it computes
//
//   out[m, c] = sum_{i = 0..N-1} q[i, m, c] * scales[i, m]
//
// in worker order, starting from 0.0f, with one write per output element.
// Replaces the Pallas kernel repro/kernels/ring_sum.py::ring_sum
// (_ring_sum_kernel), and through bucket_ring_sum the Pallas kernel
// repro/kernels/bucket_ring.py::bucket_ring_sum.
//
// Bound: bytes.  It reads N * M * C int8 levels and N * M scales and writes
// M * C floats, at 3.35 TB/s on an H100 SXM; the 2 flops per level are far
// below the compute rate.  A sum waits on N loads, so the design keeps all
// of a sum's loads in flight at once.  Three paths, one launch each:
//
// 1. Wide rows (C a multiple of 16, q and its worker and cell strides
//    16-byte aligned, and enough chunks for 4 warps an SM: the mesh psum's
//    [8, 16 * 3076, 256], a [20, 1, 2^20] row): a thread takes a chunk of 16
//    consecutive levels of one cell and issues one 16-byte load per worker,
//    up to 8 workers' loads in flight before it folds them; each row scale
//    is read once a chunk.  The warp trades each worker's levels through
//    shared memory (warp_trade.cuh, as bucket_ring.cu does), so the sums
//    stay in registers in the layout of the warp's float4 stores, each of
//    which covers 512 contiguous bytes.
// 2. Few outputs (under one thread each for a wave of 256-thread blocks)
//    in cells that fit in shared memory (the Artemis round's [20, 128, 40],
//    passed as a transposed view of its [M, N, C] layout): a block takes
//    one cell, stages its N x C levels and N scales in shared memory with
//    every load issued at once, as wide as the strides and alignment
//    allow (the round's cell is 800 contiguous bytes: 50 loads of 16 bytes),
//    and each thread then folds one output over the workers from shared
//    memory.  One block a cell at the round's shape: 128 blocks.
// 3. Anything else (a wave of outputs or more, such as the mesh's small
//    psum [8, 16 * 49, 64], or a cell too large for shared memory): one
//    thread an output, its loop over the workers unrolled 8 times.
//
// Strides: the first two axes of q and scales may have any strides; the last
// axis of q must be contiguous.
//
// Rounding: acc = acc + float(q) * scale with __fmul_rn/__fadd_rn, starting
// from 0, so nvcc cannot contract it into an FMA and the plain PyTorch loop
// (acc = acc + q[i].float() * s[i]) matches it bit for bit on every path.
//
// worker_sum: the same loop templated on its load, a float32 row value
// instead of a level times a scale: out[m, c] = sum_i x[i, m, c] in worker
// order from 0.0f (the Artemis round's server sums, which the reference
// adds in worker order with jnp.sum).  It takes paths 2 and 3 (the round's
// [20, 128, 40] is staged, a block a cell); it is not a TPU kernel of its
// own but a helper of this one.
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid.cuh"
#include "warp_trade.cuh"

namespace {

constexpr int kBatch = 8;              // workers' loads in flight at once
constexpr int kWideThreads = 128;
constexpr int kWideWaves = 4;          // grid.cuh: at most 4 waves of blocks
constexpr int kWideMinWarps = 4;       // warps an SM at least, on that path
constexpr int kCellThreads = 128;
constexpr int kCellSmem = 48 * 1024;   // dynamic shared memory without opt-in
constexpr int kOutThreads = 256;
constexpr int kOutWaves = 4;

struct Layout {
  int n;
  long long m, c, q_sn, q_sm, s_sn, s_sm;
};

// ---------------------------------------------------------------------------
// Path 1: wide rows, 16 levels a thread.
// ---------------------------------------------------------------------------

__global__ void ring_sum_wide_kernel(const int8_t* __restrict__ q,
                                     const float* __restrict__ scales,
                                     float* __restrict__ out, Layout l) {
  __shared__ int4 levels[kWideThreads];
  __shared__ float row_scale[kWideThreads];
  const int lane = threadIdx.x & 31, warp0 = threadIdx.x - lane;
  const long long per_row = l.c / kChunk;
  const long long total = l.m * per_row;
  // a warp takes 32 consecutive chunks; chunk k is out[k * 16 ...]
  for (long long k0 = blockIdx.x * (long long)blockDim.x + warp0;
       k0 < total; k0 += (long long)gridDim.x * blockDim.x) {
    const long long k = k0 + lane;
    const bool full = k0 + 32 <= total;        // the same for the warp
    if (!full && k >= total) continue;         // the last, partial warp
    const long long row = k / per_row;
    const int8_t* qp = q + row * l.q_sm + (k - row * per_row) * kChunk;
    const float* sp = scales + row * l.s_sm;
    float4 acc[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i0 = 0; i0 < l.n; i0 += kBatch) {
      int4 lv[kBatch];
      float sc[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const bool ok = i0 + b < l.n;
        lv[b] = ok ? *reinterpret_cast<const int4*>(qp + (i0 + b) * l.q_sn)
                   : make_int4(0, 0, 0, 0);
        sc[b] = ok ? sp[(i0 + b) * l.s_sn] : 0.f;
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (i0 + b >= l.n) break;
        int word[4];
        float s4[4];
        if (full) {
          trade16(lv[b], sc[b], levels + warp0, row_scale + warp0, lane,
                  word, s4);
        } else {                               // each lane its own chunk
          word[0] = lv[b].x, word[1] = lv[b].y;
          word[2] = lv[b].z, word[3] = lv[b].w;
#pragma unroll
          for (int v = 0; v < 4; ++v) s4[v] = sc[b];
        }
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[v] = fold4(acc[v], word[v], s4[v]);
      }
    }
    if (full) {
#pragma unroll
      for (int v = 0; v < 4; ++v)
        reinterpret_cast<float4*>(out + k0 * kChunk)[v * 32 + lane] = acc[v];
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v)
        reinterpret_cast<float4*>(out + k * kChunk)[v] = acc[v];
    }
  }
}

// One worker's term folded into a sum: a level times its row scale
// (ring_sum), or a float32 row value (worker_sum, no scales).
__device__ __forceinline__ float add_term(float acc, int8_t q, float sc) {
  return fold(acc, q, sc);
}
__device__ __forceinline__ float add_term(float acc, float x, float) {
  return __fadd_rn(acc, x);
}

// ---------------------------------------------------------------------------
// Path 2: cells staged in shared memory.  A cell's terms are `rows` rows of
// `row_len` bytes, `row_stride` bytes apart (one row when its workers' rows
// are adjacent); they are copied V bytes a load.
// ---------------------------------------------------------------------------

template <int V>
struct Bytes;
template <>
struct Bytes<16> { using T = int4; };
template <>
struct Bytes<8> { using T = int2; };
template <>
struct Bytes<4> { using T = int; };
template <>
struct Bytes<2> { using T = short; };
template <>
struct Bytes<1> { using T = int8_t; };

__host__ __device__ __forceinline__ int round16(int x) {
  return (x + 15) & ~15;
}

template <typename T, int V>
__global__ void ring_sum_cell_kernel(const T* __restrict__ q,
                                     const float* __restrict__ scales,
                                     float* __restrict__ out, Layout l,
                                     int rows, int row_len,
                                     long long row_stride) {
  using B = typename Bytes<V>::T;
  constexpr bool kLevels = sizeof(T) == 1;
  extern __shared__ int4 smem[];
  char* staged = reinterpret_cast<char*>(smem);
  const T* lv = reinterpret_cast<const T*>(staged);
  const int n = l.n, c = (int)l.c;
  float* sc =
      reinterpret_cast<float*>(staged + round16(n * c * (int)sizeof(T)));
  const long long m = blockIdx.x;
  const char* qm = reinterpret_cast<const char*>(q + m * l.q_sm);
  const int per_row = row_len / V;
  // every load of the cell's terms and scales, then one barrier
  for (int t = threadIdx.x; t < rows * per_row; t += blockDim.x) {
    const int r = t / per_row, b = (t - r * per_row) * V;
    *reinterpret_cast<B*>(staged + r * row_len + b) =
        *reinterpret_cast<const B*>(qm + r * row_stride + b);
  }
  if constexpr (kLevels)
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      sc[i] = scales[m * l.s_sm + i * l.s_sn];
  __syncthreads();
  for (int ci = threadIdx.x; ci < c; ci += blockDim.x) {
    float acc = 0.f;
    for (int i = 0; i < n; ++i)
      acc = add_term(acc, lv[i * c + ci], kLevels ? sc[i] : 0.f);
    out[m * c + ci] = acc;
  }
}

// ---------------------------------------------------------------------------
// Path 3: one thread an output.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void ring_sum_out_kernel(const T* __restrict__ q,
                                    const float* __restrict__ scales,
                                    float* __restrict__ out, Layout l) {
  constexpr bool kLevels = sizeof(T) == 1;
  const long long total = l.m * l.c;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long mi = t / l.c;
    const T* qp = q + mi * l.q_sm + (t - mi * l.c);
    const float* sp = kLevels ? scales + mi * l.s_sm : nullptr;
    float acc = 0.f;
#pragma unroll 8
    for (int i = 0; i < l.n; ++i)
      acc = add_term(acc, qp[i * l.q_sn], kLevels ? sp[i * l.s_sn] : 0.f);
    out[t] = acc;
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

template <typename T, int V>
int launch_cell(const T* q, const float* scales, float* out, const Layout& l,
                int rows, int row_len, long long row_stride,
                cudaStream_t stream) {
  const int smem = round16(l.n * (int)l.c * (int)sizeof(T)) +
                   (sizeof(T) == 1 ? 4 * l.n : 0);
  ring_sum_cell_kernel<T, V><<<(unsigned int)l.m, kCellThreads, smem,
                               stream>>>(q, scales, out, l, rows, row_len,
                                         row_stride);
  return (int)cudaGetLastError();
}

bool divides(int v, long long x) { return x % v == 0; }

template <typename T>
int cell_path(const T* q, const float* scales, float* out, const Layout& l,
              cudaStream_t stream) {
  // the workers' rows of a cell lie end to end: copy the cell as one row
  const long long size = sizeof(T);
  const bool one_row = l.n == 1 || l.q_sn == l.c;
  const int rows = one_row ? 1 : l.n;
  const int row_len = (int)((one_row ? l.n * l.c : l.c) * size);
  const long long row_stride = one_row ? 0 : l.q_sn * size;
  // the widest load that every row start and length allows
  int v = 16;
  while (v > 1 && !(divides(v, row_len) && divides(v, row_stride) &&
                    (l.m == 1 || divides(v, l.q_sm * size)) &&
                    divides(v, (long long)reinterpret_cast<uintptr_t>(q))))
    v >>= 1;
  switch (v) {
    case 16: return launch_cell<T, 16>(q, scales, out, l, rows, row_len,
                                       row_stride, stream);
    case 8: return launch_cell<T, 8>(q, scales, out, l, rows, row_len,
                                     row_stride, stream);
    case 4: return launch_cell<T, 4>(q, scales, out, l, rows, row_len,
                                     row_stride, stream);
    case 2: return launch_cell<T, 2>(q, scales, out, l, rows, row_len,
                                     row_stride, stream);
    default: return launch_cell<T, 1>(q, scales, out, l, rows, row_len,
                                      row_stride, stream);
  }
}

// staging pays where outputs are few (the round's 5120: one thread an
// output would fill 20 SMs with chains of N loads); with a wave of
// threads or more, one thread an output is the shorter chain
template <typename T>
int cell_or_out(const T* q, const float* scales, float* out, const Layout& l,
                bool cell_fits, cudaStream_t stream) {
  const bool few = l.m * l.c < (long long)kOutThreads * sm_count();
  if (cell_fits && few) return cell_path(q, scales, out, l, stream);
  const unsigned int blocks =
      stride_grid(ring_sum_out_kernel<T>, l.m * l.c, kOutThreads, kOutWaves);
  ring_sum_out_kernel<T><<<blocks, kOutThreads, 0, stream>>>(q, scales, out,
                                                             l);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out: [m, c] contiguous.  Strides are in elements.  Returns a cudaError_t.
int ring_sum(const int8_t* q, const float* scales, float* out, int n,
             long long m, long long c, long long q_sn, long long q_sm,
             long long s_sn, long long s_sm, void* stream) {
  if (m * c == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const Layout l{n, m, c, q_sn, q_sm, s_sn, s_sm};
  const bool cell_fits = n == 0 || (long long)n * c + 4LL * n + 16 <=
                                       kCellSmem;
  // 16 levels a thread where the layout allows it and the chunks give
  // every SM a few warps (or a cell would not fit): at fewer, a warp's
  // chain of one trade per worker outlasts the other paths' single round
  // trip
  const bool wide = c % kChunk == 0 && aligned16(q) && aligned16(out) &&
                    (n == 1 || q_sn % 16 == 0) &&
                    (m == 1 || q_sm % 16 == 0) &&
                    (!cell_fits ||
                     m * (c / kChunk) >= 32LL * kWideMinWarps * sm_count());
  if (wide) {
    const unsigned int blocks = stride_grid(ring_sum_wide_kernel,
                                            m * (c / kChunk), kWideThreads,
                                            kWideWaves);
    ring_sum_wide_kernel<<<blocks, kWideThreads, 0, st>>>(q, scales, out, l);
    return (int)cudaGetLastError();
  }
  return cell_or_out(q, scales, out, l, cell_fits, st);
}

// x: [n, m, c] float32 with strides x_sn, x_sm (elements) on its first two
// axes and a contiguous last one; out: [m, c] contiguous.  Returns a
// cudaError_t.
int worker_sum(const float* x, float* out, int n, long long m, long long c,
               long long x_sn, long long x_sm, void* stream) {
  if (m * c == 0) return (int)cudaSuccess;
  const Layout l{n, m, c, x_sn, x_sm, 0, 0};
  const bool cell_fits = 4LL * n * c + 16 <= kCellSmem;
  return cell_or_out(x, (const float*)nullptr, out, l, cell_fits,
                     (cudaStream_t)stream);
}

const char* ring_sum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
