// One hop of the bucketed ring for Hopper (sm_90a), over a stack of W
// workers' payloads.  For q [W, S] int8 (S = B * R * C: buckets x rows of C
// levels), scales [W, S / C] float32 (one per row) and a hop j in [0, W) it
// computes, for every worker w,
//
//   out[w, :] = in[w, :] + float(q[src, :]) * scales[src, row(:)],
//   src = (w - j) mod W,
//
// or, when in is null, 0.0f + float(q[src, :]) * scales[src, row(:)] (the
// start of the sum, without reading an accumulator).  Worker w at hop j
// reads the payload that torch.roll(stack, j, dims=0) puts in its slot: its
// own at hop 0, then w-1's, w-2's, ...  out may alias in (the ring
// accumulates in place).  With W = 1 and j = 0 it is one out-of-place fold
// of [M, C] levels, the reference's bucket_acc.
//
// Replaces the Pallas kernel repro/kernels/bucket_ring.py::bucket_acc
// (_acc_kernel).  The Pallas kernel's block_rows tiles TPU VMEM and has no
// counterpart; the ring's per-hop ppermute (a roll of the stack on the
// simulated worker axis) becomes the src offset in the index.
//
// Bound: bytes.  Per element a hop reads 4 + 1 bytes and writes 4 (the first
// hop reads no accumulator: 1 + 4), plus 4 bytes of scale per row, at 3.35
// TB/s on an H100 SXM; the 2 flops per element are far below the compute
// rate.  Design: when C and S are multiples of 16 and q, in and out are
// 16-byte aligned, a thread takes a chunk of 16 consecutive levels of one
// row: one 16-byte load of q and one scale.  A warp's 32 chunks are 512
// consecutive values of the accumulator; the warp trades its levels and
// scales through shared memory (warp_trade.cuh, shared with ring_sum.cu),
// and each thread makes four float4 loads of in and four float4 stores of
// out, each of them 512 contiguous bytes across the warp, all loads issued
// before the first store (out may alias in).  Any
// other shape (C = 1, C = 5, ...) takes one element a thread in the same
// kernel.  A grid-stride loop over the chunks of the whole [W, S] stack,
// sized to a few waves of the card's SMs.
//
// Rounding: fold (warp_trade.cuh) is __fmul_rn then __fadd_rn, so nvcc
// cannot contract the expression into an FMA.  Only then does the ring of
// these hops equal the decode-then-add ring (acc + (float(q) * scale), two
// roundings) bit for bit: the reference's invariant (DESIGN.md §7).
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid.cuh"
#include "warp_trade.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWaves = 4;           // grid.cuh: at most 4 waves of blocks
constexpr int kVec = kChunk;        // levels a thread takes on the vector path

// kE = 16: the vector path; kE = 1: one element a thread
template <int kE>
__global__ void bucket_acc_hop_kernel(const float* in,
                                      const int8_t* __restrict__ q,
                                      const float* __restrict__ scales,
                                      float* out, long long w_count,
                                      long long s, long long c,
                                      long long hop) {
  __shared__ int4 levels[kThreads];
  __shared__ float row_scale[kThreads];
  const int lane = threadIdx.x & 31, warp0 = threadIdx.x - lane;
  const long long per_w = s / kE;            // chunks per worker
  const long long total = w_count * per_w;
  const long long rows = s / c;              // rows per worker
  // a warp takes 32 consecutive chunks; chunk k is out[k * kE ...]
  for (long long k0 = blockIdx.x * (long long)blockDim.x + warp0;
       k0 < total; k0 += (long long)gridDim.x * blockDim.x) {
    const long long k = k0 + lane;
    const bool live = k < total;
    long long qi = 0;
    float sc = 0.f;
    if (live) {
      const long long w = k / per_w;
      const long long e = (k - w * per_w) * kE;  // in the worker's slice
      const long long src = w >= hop ? w - hop : w + w_count - hop;
      qi = src * s + e;
      sc = scales[src * rows + e / c];
    }
    if constexpr (kE == 1) {
      if (live) out[k] = fold(in ? in[k] : 0.f, q[qi], sc);
    } else if (k0 + 32 <= total) {
      // The warp's 32 chunks are 512 consecutive accumulator values: the
      // warp trades its levels and scales (warp_trade.cuh) so that every
      // float4 load and store of the warp covers 512 contiguous bytes.
      const int4 lv = *reinterpret_cast<const int4*>(q + qi);
      float4 a[4];
#pragma unroll
      for (int v = 0; v < 4; ++v)
        a[v] = in ? reinterpret_cast<const float4*>(in + k0 * kE)[v * 32 +
                                                                 lane]
                  : make_float4(0.f, 0.f, 0.f, 0.f);
      int word[4];
      float s4[4];
      trade16(lv, sc, levels + warp0, row_scale + warp0, lane, word, s4);
#pragma unroll
      for (int v = 0; v < 4; ++v)
        reinterpret_cast<float4*>(out + k0 * kE)[v * 32 + lane] =
            fold4(a[v], word[v], s4[v]);
    } else if (live) {
      // the stack's last, partial warp: each lane its own chunk
      const int4 qv = *reinterpret_cast<const int4*>(q + qi);
      const int word[4] = {qv.x, qv.y, qv.z, qv.w};
      float4 a[4];
#pragma unroll
      for (int v = 0; v < 4; ++v)
        a[v] = in ? reinterpret_cast<const float4*>(in + k * kE)[v]
                  : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int v = 0; v < 4; ++v)
        reinterpret_cast<float4*>(out + k * kE)[v] = fold4(a[v], word[v], sc);
    }
  }
}

template <int kE>
int launch(const float* in, const int8_t* q, const float* scales, float* out,
           long long w, long long s, long long c, long long hop,
           cudaStream_t stream) {
  const unsigned int blocks =
      stride_grid(bucket_acc_hop_kernel<kE>, w * (s / kE), kThreads, kWaves);
  bucket_acc_hop_kernel<kE><<<blocks, kThreads, 0, stream>>>(
      in, q, scales, out, w, s, c, hop);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q: [w, s] int8; scales: [w, s / c] float32; in (may be null) and out:
// [w, s] float32, out may equal in; 0 <= hop < w and c divides s (the
// caller checks).  Returns a cudaError_t.
int bucket_acc_hop(const float* in, const int8_t* q, const float* scales,
                   float* out, long long w, long long s, long long c,
                   long long hop, void* stream) {
  if (w * s == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = c % kVec == 0 && s % kVec == 0 && aligned16(q) &&
                   aligned16(out) && (in == nullptr || aligned16(in));
  return vec ? launch<kVec>(in, q, scales, out, w, s, c, hop, st)
             : launch<1>(in, q, scales, out, w, s, c, hop, st);
}

const char* bucket_ring_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
