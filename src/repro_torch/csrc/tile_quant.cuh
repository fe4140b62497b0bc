// Per-tile stochastic s-quantization for Hopper (sm_90a), with or without
// the Artemis memory: the one design behind squant_encode (squant.cu, B5)
// and fused_memory_update (fused_memory.cu, B1).  For row-major [M, N]
// arrays cut into (bm x bn) tiles, per tile:
//
//   v      = x                              (encode)
//          = round_T(g - h)                 (with a memory h)
//   norm   = ||v||_2 over the tile, in float32
//   scale  = norm / s, or 0 when norm is not finite
//   r      = |v| / (norm > 0 ? norm : 1) * s
//   q      = int8(sign(v) * (floor(r) + (u < r - floor(r))))  (0 where r
//            is NaN, saturated where a NaN norm lets r leave int8)
//   h_new  = round_T(h + round_T(round_T(alpha) *
//                                round_T(q * round_T(scale))))
//
// with one f32 scale per tile.  x, g, h and h_new are of one element type
// T (float or bf16) and u of its own, TU; round_T rounds to T (exact for
// float), so in bf16 each step of the memory update is rounded to bf16 in
// turn, as the Pallas kernel repro/kernels/fused_memory.py writes it.
//
// Bound: bytes, at 3.35 TB/s on an H100 SXM.  Per element encode reads x
// and u and writes q (9 B in f32); with a memory it reads g, h, u and
// writes q and h_new (17 B in f32).  A few float ops per element, far below
// the compute rate.  The norm has to be known before the first level, so
// the design question is where the tile waits for it.  Three regimes,
// chosen from the tile's size, compute the same function, one launch each:
//
// 1. Small tiles (at most 1024 elements; the Artemis round's (1, d) rows,
//    d = 2 to 40): a group of G = 4, 8, 16 or 32 lanes takes one tile, K
//    elements a lane (K = 1 to 32), 256 / G tiles a block.  Each lane
//    issues its loads at once, the norm is a shuffle reduction within the
//    group (no shared memory, no barrier), and levels, scale and h_new come
//    from the same registers: one memory round trip.
// 2. Middle tiles that a thread-block cluster holds in registers (the
//    compression API's (256, 256) tiles): the tile is split across a
//    cluster of 2 to 16 CTAs (16 where the card allows a non-portable
//    cluster size, else 8).  Each CTA loads its share into registers, four
//    elements a vector where bn is a multiple of 4 (16 bytes of f32, 8 of
//    bf16; instantiated for 1 to 32 elements a thread and launched with
//    just what the share needs, so that no registers are held idle), and
//    the cluster sums the squares in rank order, each CTA pushing its
//    partial into the others' shared memory (tile_norm.cuh: two cluster
//    barriers, the first arrived at when the kernel starts); each CTA then
//    quantizes its share from registers.  A whole grid of tiles fills the
//    card (16 CTAs a tile at [4096, 256]: 256 CTAs), and one tile still
//    spreads over 16 SMs.
// 3. Larger tiles (rows of 2^20): the same cluster split, but each CTA
//    streams its share twice, the squares first, then the inputs again for
//    the quantize pass.
//
// Indices: tile numbers and offsets inside a tile are 32-bit (the callers
// check the counts); only the final element offset is 64-bit.
//
// Rounding: __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn so that nvcc cannot
// contract the arithmetic into an FMA, and the plain PyTorch versions
// (separate operations, each rounded) match h_new bit for bit where the
// levels agree.  The norm's order is the kernel's own (hence the
// tolerance on levels); it depends only on the shape, so the same inputs
// give the same bits on every run (no float atomics).
#pragma once
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "tile_norm.cuh"

namespace {         // internal linkage: each library has its own copy
namespace tile_quant {

namespace cg = cooperative_groups;

constexpr int kRowThreads = 256;       // regime 1: block size
constexpr int kMaxSmallTile = 1024;    // regime 1: 32 lanes x 32 elements
constexpr int kCtaThreads = 256;       // regimes 2 and 3: threads per CTA
constexpr int kHeld = 32;              // regime 2: most elements a thread
constexpr int kStream = 4;             // regime 3: vectors in flight a pass
constexpr int kPortableCluster = 8;
constexpr int kMaxCluster = 16;

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// Element types: loads widen to float, stores round to the type.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

// v rounded to T and back: exact for float
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// V consecutive elements of T at p (aligned to V elements) as floats
template <int V, typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = widen(*p);
  } else if constexpr (sizeof(T) == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w.y));
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  }
}

// V floats rounded to T, stored at p (aligned to V elements)
template <int V, typename T>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    put(p, v[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 w;
    w.x = *reinterpret_cast<const unsigned int*>(&a);
    w.y = *reinterpret_cast<const unsigned int*>(&b);
    *reinterpret_cast<uint2*>(p) = w;
  }
}

// ---------------------------------------------------------------------------
// Tiles and the arithmetic of one element
// ---------------------------------------------------------------------------

struct Tile {
  long long n;                         // columns of the arrays
  int bm, bn, tiles_per_row;

  // offset of the tile's first element
  __device__ __forceinline__ long long base(int t) const {
    const int tr = t / tiles_per_row;
    return (long long)tr * bm * n + (long long)(t - tr * tiles_per_row) * bn;
  }
  // offset of element e (row-major in the tile) from the tile's first
  __device__ __forceinline__ long long offset(int e) const {
    if (bm == 1) return e;
    const int r = e / bn;
    return (long long)r * n + (e - r * bn);
  }
};

// What the quantize pass needs from a tile's sum of squares.
template <typename T>
struct Quant {
  float sf, scale, safe;
  float scale_t, alpha_t;              // the scale and alpha rounded to T
};

template <typename T>
__device__ __forceinline__ Quant<T> make_quant(float sumsq, int s,
                                               float alpha) {
  const float norm = sqrtf(sumsq);
  Quant<T> k;
  k.sf = (float)s;
  k.scale = isfinite(norm) ? __fdiv_rn(norm, k.sf) : 0.f;
  k.safe = norm > 0.f ? norm : 1.f;
  k.scale_t = round_to<T>(k.scale);
  k.alpha_t = round_to<T>(alpha);
  return k;
}

__device__ __forceinline__ float square_add(float acc, float d) {
  return __fadd_rn(acc, __fmul_rn(d, d));
}

// The value quantized: x, or g - h rounded to T.
template <typename T, bool kMem>
__device__ __forceinline__ float value(float x, float h) {
  if constexpr (kMem) return round_to<T>(__fsub_rn(x, h));
  return x;
}

// The level of v and, with a memory, h' = h + alpha * (q * scale), each
// step rounded to T.
template <typename T, bool kMem>
__device__ __forceinline__ int8_t quantize(const Quant<T>& k, float v,
                                           float hv, float uv, float* hn) {
  const float r = __fmul_rn(__fdiv_rn(fabsf(v), k.safe), k.sf);
  const float low = floorf(r);
  const float psi = __fadd_rn(low, uv < __fsub_rn(r, low) ? 1.f : 0.f);
  const float sign = v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
  const float qf = __fmul_rn(sign, psi);
  // int8 as XLA converts: NaN to 0, out-of-range values saturated (|qf|
  // exceeds s + 1 only where the norm is NaN and safe is 1)
  const int8_t qi =
      isnan(qf) ? (int8_t)0 : (int8_t)(int)fminf(fmaxf(qf, -128.f), 127.f);
  if constexpr (kMem) {
    const float dq = round_to<T>(__fmul_rn((float)qi, k.scale_t));
    *hn = round_to<T>(__fadd_rn(hv, round_to<T>(__fmul_rn(k.alpha_t, dq))));
  }
  return qi;
}

template <typename T, typename TU>
struct Args {
  const T* x;           // x, or g with a memory
  const T* h;           // the memory (null without one)
  const TU* u;
  float alpha;
  int s;
  Tile tile;
  int n_tiles;
  int8_t* q;
  float* scales;
  T* h_new;             // null without a memory
  cudaStream_t stream;
};

// ---------------------------------------------------------------------------
// Regime 1: a group of `group` lanes per tile, K elements a lane.
// ---------------------------------------------------------------------------

template <typename T, typename TU, bool kMem, int K>
__global__ void small_kernel(Args<T, TU> a, int group) {
  const long long thread = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const int t = (int)(thread / group);
  const int li = threadIdx.x & (group - 1);
  const int tile_elems = a.tile.bm * a.tile.bn;
  const bool live = t < a.n_tiles;
  const long long base = live ? a.tile.base(t) : 0;
  // element j * group + li of the tile: neighbouring lanes, neighbouring
  // addresses
  long long off[K];
  float xv[K], hv[K], uv[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int e = j * group + li;
    const bool ok = live && e < tile_elems;
    off[j] = ok ? base + a.tile.offset(e) : -1;
    xv[j] = ok ? widen(a.x[off[j]]) : 0.f;
    hv[j] = kMem && ok ? widen(a.h[off[j]]) : 0.f;
    uv[j] = ok ? widen(a.u[off[j]]) : 0.f;
  }
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    xv[j] = value<T, kMem>(xv[j], hv[j]);       // in place
    acc = square_add(acc, xv[j]);
  }
  // butterfly within the group: every lane adds the same two values at
  // each step (a + b == b + a), so all lanes end with the same bits
  for (int o = group >> 1; o > 0; o >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
  if (!live) return;
  const Quant<T> k = make_quant<T>(acc, a.s, a.alpha);
  if (li == 0) a.scales[t] = k.scale;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (off[j] < 0) continue;
    float hn;
    a.q[off[j]] = quantize<T, kMem>(k, xv[j], hv[j], uv[j], &hn);
    if constexpr (kMem) put(a.h_new + off[j], hn);
  }
}

// ---------------------------------------------------------------------------
// Regimes 2 and 3: one tile per cluster, V = 4 or 1 elements a vector, each
// CTA a contiguous share of the tile's vectors.
// ---------------------------------------------------------------------------

template <typename T, typename TU, bool kMem, int V>
struct Vecs {
  float x[V], h[V], u[V];

  __device__ __forceinline__ void load(const Args<T, TU>& a, long long off,
                                       bool ok, bool with_u) {
    if (ok) {
      load_vec<V>(a.x + off, x);
      if constexpr (kMem) {
        load_vec<V>(a.h + off, h);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) h[i] = 0.f;
      }
      if (with_u) load_vec<V>(a.u + off, u);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) x[i] = h[i] = u[i] = 0.f;
    }
  }

  __device__ __forceinline__ float square_add(float acc) const {
#pragma unroll
    for (int i = 0; i < V; ++i)
      acc = tile_quant::square_add(acc, value<T, kMem>(x[i], h[i]));
    return acc;
  }

  // quantize and store the levels and new memory
  __device__ __forceinline__ void quantize_store(const Quant<T>& k,
                                                 const Args<T, TU>& a,
                                                 long long off) const {
    float hn[V];
    int8_t qi[V];
#pragma unroll
    for (int i = 0; i < V; ++i)
      qi[i] = quantize<T, kMem>(k, value<T, kMem>(x[i], h[i]), h[i], u[i],
                                &hn[i]);
    if constexpr (V == 4)
      *reinterpret_cast<char4*>(a.q + off) =
          make_char4(qi[0], qi[1], qi[2], qi[3]);
    else
      a.q[off] = qi[0];
    if constexpr (kMem) store_vec<V>(a.h_new + off, hn);
  }
};

// kR > 0: regime 2, kR vectors a thread held in registers; kR = 0: regime 3
template <typename T, typename TU, bool kMem, int V, int kR>
__global__ void __launch_bounds__(kCtaThreads)
    cluster_kernel(Args<T, TU> a, int share) {
  using Vv = Vecs<T, TU, kMem, V>;
  __shared__ float warp_sums[32];
  __shared__ float slots[kMaxCluster];
  cluster_start();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int t = blockIdx.x / cluster.num_blocks();
  const int n_vec = a.tile.bm * a.tile.bn / V;
  const int v0 = rank * share;
  const int v1 = min(v0 + share, n_vec);
  const long long base = a.tile.base(t);
  const int step = blockDim.x;
  float acc = 0.f;
  if constexpr (kR > 0) {
    // regime 2: the share in registers, all loads issued before the sum
    Vv r[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int v = v0 + j * step + (int)threadIdx.x;
      const bool ok = v < v1;
      r[j].load(a, ok ? base + a.tile.offset(v * V) : 0, ok, true);
    }
#pragma unroll
    for (int j = 0; j < kR; ++j) acc = r[j].square_add(acc);
    const Quant<T> k =
        make_quant<T>(cluster_tile_sum(acc, warp_sums, slots), a.s,
                      a.alpha);
    if (rank == 0 && threadIdx.x == 0) a.scales[t] = k.scale;
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int v = v0 + j * step + (int)threadIdx.x;
      if (v < v1) r[j].quantize_store(k, a, base + a.tile.offset(v * V));
    }
  } else {
    // regime 3: the share streamed twice, kStream vectors in flight
    for (int v = v0 + (int)threadIdx.x; v < v1; v += kStream * step) {
      Vv r[kStream];
#pragma unroll
      for (int j = 0; j < kStream; ++j) {
        const int vj = v + j * step;
        const bool ok = vj < v1;
        r[j].load(a, ok ? base + a.tile.offset(vj * V) : 0, ok, false);
      }
#pragma unroll
      for (int j = 0; j < kStream; ++j) acc = r[j].square_add(acc);
    }
    const Quant<T> k =
        make_quant<T>(cluster_tile_sum(acc, warp_sums, slots), a.s,
                      a.alpha);
    if (rank == 0 && threadIdx.x == 0) a.scales[t] = k.scale;
    for (int v = v0 + (int)threadIdx.x; v < v1; v += kStream * step) {
      Vv r[kStream];
#pragma unroll
      for (int j = 0; j < kStream; ++j) {
        const int vj = v + j * step;
        const bool ok = vj < v1;
        r[j].load(a, ok ? base + a.tile.offset(vj * V) : 0, ok, true);
      }
#pragma unroll
      for (int j = 0; j < kStream; ++j) {
        const int vj = v + j * step;
        if (vj < v1) r[j].quantize_store(k, a, base + a.tile.offset(vj * V));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <typename T, typename TU, bool kMem, int K>
int launch_small(const Args<T, TU>& a, int group) {
  const long long threads = (long long)a.n_tiles * group;
  const unsigned int blocks =
      (unsigned int)((threads + kRowThreads - 1) / kRowThreads);
  small_kernel<T, TU, kMem, K><<<blocks, kRowThreads, 0, a.stream>>>(a,
                                                                     group);
  return (int)cudaGetLastError();
}

template <typename T, typename TU, bool kMem>
int small_regime(const Args<T, TU>& a) {
  const int tile_elems = a.tile.bm * a.tile.bn;
  int group = 4;
  while (group < 32 && group < tile_elems) group <<= 1;
  const int per_lane = (tile_elems + group - 1) / group;
  if (per_lane <= 1) return launch_small<T, TU, kMem, 1>(a, group);
  if (per_lane <= 2) return launch_small<T, TU, kMem, 2>(a, group);
  if (per_lane <= 4) return launch_small<T, TU, kMem, 4>(a, group);
  if (per_lane <= 8) return launch_small<T, TU, kMem, 8>(a, group);
  if (per_lane <= 16) return launch_small<T, TU, kMem, 16>(a, group);
  return launch_small<T, TU, kMem, 32>(a, group);
}

inline cudaLaunchConfig_t cluster_config(int clusters, int cluster,
                                         cudaLaunchAttribute* attr,
                                         cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned int)(clusters * cluster));
  cfg.blockDim = dim3(kCtaThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The largest cluster this kernel may use on this card: 16 where the card
// allows the non-portable size and can hold such a cluster, else 8.  Asked
// once per kernel; a refused query leaves no error behind.
template <typename T, typename TU, bool kMem, int V, int kR>
int max_cluster() {
  static int cached = 0;
  if (cached) return cached;
  auto kernel = cluster_kernel<T, TU, kMem, V, kR>;
  cached = kPortableCluster;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) == cudaSuccess) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(1, kMaxCluster, &attr, nullptr);
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) ==
            cudaSuccess &&
        clusters > 0)
      cached = kMaxCluster;
  }
  cudaGetLastError();
  return cached;
}

// One launch of a cluster kernel, each CTA `share` vectors of its tile.  A
// cluster larger than this kernel may have is refused here, as the card
// would refuse it (a kernel holding fewer registers takes any cluster one
// holding more can).
template <typename T, typename TU, bool kMem, int V, int kR>
int launch_cluster(const Args<T, TU>& a, int cluster, int share) {
  if (cluster > max_cluster<T, TU, kMem, V, kR>() ||
      (long long)a.n_tiles * cluster >= (1LL << 31))
    return (int)cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(a.n_tiles, cluster, &attr, a.stream);
  return (int)cudaLaunchKernelEx(&cfg, cluster_kernel<T, TU, kMem, V, kR>, a,
                                 share);
}

// Regimes 2 and 3 for vectors of V elements.
template <typename T, typename TU, bool kMem, int V>
int cluster_regime(const Args<T, TU>& a) {
  const int tile_elems = a.tile.bm * a.tile.bn;
  const int n_vec = tile_elems / V;
  // about 8 or more elements a thread: 2 CTAs for the smallest tiles of
  // this regime, up to the card's largest cluster
  int want = 2;
  while (want < kMaxCluster && want * 2 * kCtaThreads * 8 <= tile_elems)
    want <<= 1;
  // the vectors a thread must hold at the largest cluster the card gives
  // the kernel that holds the most; the launched kernel holds just that
  // many, so that no registers go unused
  int cluster = std::min(want, max_cluster<T, TU, kMem, V, kHeld / V>());
  int share = (n_vec + cluster - 1) / cluster;
  const int per_thread = (share + kCtaThreads - 1) / kCtaThreads;
  if (per_thread <= 1) return launch_cluster<T, TU, kMem, V, 1>(a, cluster,
                                                               share);
  if (per_thread <= 2) return launch_cluster<T, TU, kMem, V, 2>(a, cluster,
                                                               share);
  if (per_thread <= 4) return launch_cluster<T, TU, kMem, V, 4>(a, cluster,
                                                               share);
  if (per_thread <= 8) return launch_cluster<T, TU, kMem, V, 8>(a, cluster,
                                                               share);
  if constexpr (V == 1) {
    if (per_thread <= 16)
      return launch_cluster<T, TU, kMem, V, 16>(a, cluster, share);
    if (per_thread <= 32)
      return launch_cluster<T, TU, kMem, V, 32>(a, cluster, share);
  }
  cluster = std::min(want, max_cluster<T, TU, kMem, V, 0>());
  share = (n_vec + cluster - 1) / cluster;
  return launch_cluster<T, TU, kMem, V, 0>(a, cluster, share);
}

inline bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// One launch over every tile of [m, n] in (bm x bn) tiles.  The caller
// checks that the block tiles the shape.  Returns a cudaError_t: a launch
// the card refuses (a cluster it cannot place, say) returns its error, and
// no other regime is tried.
template <typename T, typename TU, bool kMem>
int launch(const T* x, const T* h, const TU* u, float alpha, int s,
           long long m, long long n, int bm, int bn, int8_t* q,
           float* scales, T* h_new, cudaStream_t stream) {
  const long long tiles_per_row = n / bn;
  const long long n_tiles = (m / bm) * tiles_per_row;
  if (n_tiles == 0) return (int)cudaSuccess;
  if (n_tiles >= (1LL << 31) || (long long)bm * bn >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const Args<T, TU> a{x, h, u, alpha, s,
                      Tile{n, bm, bn, (int)tiles_per_row}, (int)n_tiles, q,
                      scales, h_new, stream};
  if ((long long)bm * bn <= kMaxSmallTile) return small_regime<T, TU, kMem>(a);
  const bool vec4 = bn % 4 == 0 && aligned(x, 4 * sizeof(T)) &&
                    aligned(u, 4 * sizeof(TU)) && aligned(q, 4) &&
                    (!kMem || (aligned(h, 4 * sizeof(T)) &&
                               aligned(h_new, 4 * sizeof(T))));
  return vec4 ? cluster_regime<T, TU, kMem, 4>(a)
              : cluster_regime<T, TU, kMem, 1>(a);
}

}  // namespace tile_quant
}  // namespace
