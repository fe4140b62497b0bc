// Fused Artemis worker uplink for Hopper (sm_90a): per (bm x bn) tile of
// row-major [M, N] float32 arrays g, h, u it computes
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
// flops per element, far below the card's compute rate.  The norm has to be
// known before the first level, so the design question is where delta waits
// for it.  Three regimes, chosen from the tile's size, compute the same
// function, each with one launch:
//
// 1. Small tiles (at most 1024 elements; the Artemis round's (1, d) rows,
//    d = 2 to 40 on the main path): a group of G = 4, 8, 16 or 32 lanes takes
//    one tile, K elements a lane (K = 1 to 32), 256 / G tiles a block.  Each
//    lane issues its loads of g, h and u at once, the norm is a shuffle
//    reduction within the group (no shared memory, no barrier), and levels,
//    scale and h_new come from the same registers: one memory round trip.
// 2. Middle tiles that a thread-block cluster holds in registers (the
//    compression API's (256, 256) tiles): the tile is split across a cluster
//    of 2 to 16 CTAs (16 where the card allows a non-portable cluster size,
//    else 8).  Each CTA loads its share of g, h and u into registers, float4
//    at a time where bn is a multiple of 4 (the kernel is instantiated for
//    1 to 32 elements a thread and launched with just what the share
//    needs, so that no registers are held idle), and the cluster sums the
//    squares in rank order through distributed shared memory
//    (tile_norm.cuh); each CTA then quantizes its share from registers.
// 3. Larger tiles (rows of 2^20): the same cluster split, but each CTA
//    streams its share twice, the squares first, then g, h and u again for
//    the quantize pass (25 bytes an element instead of 17).
//
// Indices: tile numbers and offsets inside a tile are 32-bit (the wrapper
// checks the counts); only the final element offset is 64-bit.
//
// Rounding: h + alpha * (q * scale) is computed with __fmul_rn/__fadd_rn so
// that nvcc cannot contract it into an FMA and the plain PyTorch version
// (separate multiply and add) can match it bit for bit.  The norm's order of
// summation is the kernel's own (the plain version's differs, hence the
// tolerance on levels); it depends only on the shape, so the same inputs
// give the same bits on every run.  The uniforms stay an operand, as in the
// Pallas kernel: the card's Philox stream is not the TPU's, and an operand
// lets the tests feed both versions the same numbers.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "tile_norm.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kRowThreads = 256;       // regime 1: block size
constexpr int kMaxSmallTile = 1024;    // regime 1: 32 lanes x 32 elements
constexpr int kCtaThreads = 256;       // regimes 2 and 3: threads per CTA
constexpr int kHeld = 32;              // regime 2: most elements a thread
constexpr int kStream = 4;             // regime 3: vectors in flight a pass
constexpr int kPortableCluster = 8;
constexpr int kMaxCluster = 16;

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
struct Quant {
  float sf, scale, safe, alpha;
};

__device__ __forceinline__ Quant make_quant(float sumsq, int s, float alpha) {
  const float norm = sqrtf(sumsq);
  Quant k;
  k.sf = (float)s;
  k.scale = isfinite(norm) ? __fdiv_rn(norm, k.sf) : 0.f;
  k.safe = norm > 0.f ? norm : 1.f;
  k.alpha = alpha;
  return k;
}

__device__ __forceinline__ float square_add(float acc, float d) {
  return __fadd_rn(acc, __fmul_rn(d, d));
}

// The level of delta d and the new memory h' = h + alpha * (q * scale).
__device__ __forceinline__ int8_t quantize(const Quant& k, float d, float hv,
                                           float uv, float* hn) {
  const float r = __fmul_rn(__fdiv_rn(fabsf(d), k.safe), k.sf);
  const float low = floorf(r);
  const float psi = __fadd_rn(low, uv < __fsub_rn(r, low) ? 1.f : 0.f);
  const float sign = d > 0.f ? 1.f : (d < 0.f ? -1.f : 0.f);
  const float qf = sign * psi;
  const int8_t qi = isnan(qf) ? (int8_t)0 : (int8_t)(int)qf;
  *hn = __fadd_rn(hv, __fmul_rn(k.alpha, __fmul_rn((float)qi, k.scale)));
  return qi;
}

// ---------------------------------------------------------------------------
// Regime 1: a group of `group` lanes per tile, K elements a lane.
// ---------------------------------------------------------------------------

template <int K>
__global__ void fused_small_kernel(const float* __restrict__ g,
                                   const float* __restrict__ h,
                                   const float* __restrict__ u, float alpha,
                                   int s, Tile tile, int n_tiles, int group,
                                   int8_t* __restrict__ q,
                                   float* __restrict__ scales,
                                   float* __restrict__ h_new) {
  const long long thread = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const int t = (int)(thread / group);
  const int li = threadIdx.x & (group - 1);
  const int tile_elems = tile.bm * tile.bn;
  const bool live = t < n_tiles;
  const long long base = live ? tile.base(t) : 0;
  // element j * group + li of the tile: neighbouring lanes, neighbouring
  // addresses
  long long off[K];
  float gv[K], hv[K], uv[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int e = j * group + li;
    const bool ok = live && e < tile_elems;
    off[j] = ok ? base + tile.offset(e) : -1;
    gv[j] = ok ? g[off[j]] : 0.f;
    hv[j] = ok ? h[off[j]] : 0.f;
    uv[j] = ok ? u[off[j]] : 0.f;
  }
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    gv[j] = __fsub_rn(gv[j], hv[j]);           // delta, in place
    acc = square_add(acc, gv[j]);
  }
  // butterfly within the group: every lane adds the same two values at
  // each step (a + b == b + a), so all lanes end with the same bits
  for (int o = group >> 1; o > 0; o >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
  if (!live) return;
  const Quant k = make_quant(acc, s, alpha);
  if (li == 0) scales[t] = k.scale;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (off[j] < 0) continue;
    float hn;
    q[off[j]] = quantize(k, gv[j], hv[j], uv[j], &hn);
    h_new[off[j]] = hn;
  }
}

// ---------------------------------------------------------------------------
// Regimes 2 and 3: one tile per cluster, V = 4 (float4) or 1 element a
// vector, each CTA a contiguous share of the tile's vectors.
// ---------------------------------------------------------------------------

template <int V>
struct Vec;
template <>
struct Vec<4> {
  using F = float4;
  __device__ static float at(const float4& x, int i) {
    return i == 0 ? x.x : (i == 1 ? x.y : (i == 2 ? x.z : x.w));
  }
  __device__ static float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
};
template <>
struct Vec<1> {
  using F = float;
  __device__ static float at(float x, int) { return x; }
  __device__ static float zero() { return 0.f; }
};

template <int V>
__device__ __forceinline__ typename Vec<V>::F load(const float* p,
                                                   long long off) {
  return *reinterpret_cast<const typename Vec<V>::F*>(p + off);
}

template <int V>
__device__ __forceinline__ float square_add_vec(
    float acc, const typename Vec<V>::F& gv, const typename Vec<V>::F& hv) {
#pragma unroll
  for (int i = 0; i < V; ++i)
    acc = square_add(acc, __fsub_rn(Vec<V>::at(gv, i), Vec<V>::at(hv, i)));
  return acc;
}

// quantize one vector and store its levels and new memory
template <int V>
__device__ __forceinline__ void quantize_store(
    const Quant& k, const typename Vec<V>::F& gv,
    const typename Vec<V>::F& hv, const typename Vec<V>::F& uv,
    long long off, int8_t* q, float* h_new) {
  float hn[V];
  int8_t qi[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float hi = Vec<V>::at(hv, i);
    qi[i] = quantize(k, __fsub_rn(Vec<V>::at(gv, i), hi), hi,
                     Vec<V>::at(uv, i), &hn[i]);
  }
  if constexpr (V == 4) {
    *reinterpret_cast<char4*>(q + off) =
        make_char4(qi[0], qi[1], qi[2], qi[3]);
    *reinterpret_cast<float4*>(h_new + off) =
        make_float4(hn[0], hn[1], hn[2], hn[3]);
  } else {
    q[off] = qi[0];
    h_new[off] = hn[0];
  }
}

// kR > 0: regime 2, kR vectors a thread held in registers; kR = 0: regime 3
template <int V, int kR>
__global__ void __launch_bounds__(kCtaThreads)
    fused_cluster_kernel(const float* __restrict__ g,
                         const float* __restrict__ h,
                         const float* __restrict__ u, float alpha, int s,
                         Tile tile, int share, int8_t* __restrict__ q,
                         float* __restrict__ scales,
                         float* __restrict__ h_new) {
  using F = typename Vec<V>::F;
  __shared__ float warp_sums[32];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int t = blockIdx.x / cluster.num_blocks();
  const int n_vec = tile.bm * tile.bn / V;
  const int v0 = rank * share;
  const int v1 = min(v0 + share, n_vec);
  const long long base = tile.base(t);
  const int step = blockDim.x;
  float acc = 0.f;
  if constexpr (kR > 0) {
    // regime 2: the share in registers, all loads issued before the sum
    F gv[kR], hv[kR], uv[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int v = v0 + j * step + (int)threadIdx.x;
      const bool ok = v < v1;
      const long long off = ok ? base + tile.offset(v * V) : 0;
      gv[j] = ok ? load<V>(g, off) : Vec<V>::zero();
      hv[j] = ok ? load<V>(h, off) : Vec<V>::zero();
      uv[j] = ok ? load<V>(u, off) : Vec<V>::zero();
    }
#pragma unroll
    for (int j = 0; j < kR; ++j) acc = square_add_vec<V>(acc, gv[j], hv[j]);
    const Quant k = make_quant(cluster_tile_sum(acc, warp_sums), s, alpha);
    if (rank == 0 && threadIdx.x == 0) scales[t] = k.scale;
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int v = v0 + j * step + (int)threadIdx.x;
      if (v < v1)
        quantize_store<V>(k, gv[j], hv[j], uv[j], base + tile.offset(v * V),
                          q, h_new);
    }
  } else {
    // regime 3: the share streamed twice, kStream vectors in flight
    for (int v = v0 + (int)threadIdx.x; v < v1; v += kStream * step) {
      F gv[kStream], hv[kStream];
#pragma unroll
      for (int j = 0; j < kStream; ++j) {
        const int vj = v + j * step;
        const bool ok = vj < v1;
        const long long off = ok ? base + tile.offset(vj * V) : 0;
        gv[j] = ok ? load<V>(g, off) : Vec<V>::zero();
        hv[j] = ok ? load<V>(h, off) : Vec<V>::zero();
      }
#pragma unroll
      for (int j = 0; j < kStream; ++j)
        acc = square_add_vec<V>(acc, gv[j], hv[j]);
    }
    const Quant k = make_quant(cluster_tile_sum(acc, warp_sums), s, alpha);
    if (rank == 0 && threadIdx.x == 0) scales[t] = k.scale;
    for (int v = v0 + (int)threadIdx.x; v < v1; v += kStream * step) {
      F gv[kStream], hv[kStream], uv[kStream];
#pragma unroll
      for (int j = 0; j < kStream; ++j) {
        const int vj = v + j * step;
        const bool ok = vj < v1;
        const long long off = ok ? base + tile.offset(vj * V) : 0;
        gv[j] = ok ? load<V>(g, off) : Vec<V>::zero();
        hv[j] = ok ? load<V>(h, off) : Vec<V>::zero();
        uv[j] = ok ? load<V>(u, off) : Vec<V>::zero();
      }
#pragma unroll
      for (int j = 0; j < kStream; ++j) {
        const int vj = v + j * step;
        if (vj < v1)
          quantize_store<V>(k, gv[j], hv[j], uv[j],
                            base + tile.offset(vj * V), q, h_new);
      }
    }
  }
  cluster.sync();   // no CTA exits while another reads its warp_sums
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

struct Args {
  const float *g, *h, *u;
  float alpha;
  int s;
  Tile tile;
  int n_tiles;
  int8_t* q;
  float *scales, *h_new;
  cudaStream_t stream;
};

template <int K>
int launch_small(const Args& a, int group) {
  const long long threads = (long long)a.n_tiles * group;
  const unsigned int blocks =
      (unsigned int)((threads + kRowThreads - 1) / kRowThreads);
  fused_small_kernel<K><<<blocks, kRowThreads, 0, a.stream>>>(
      a.g, a.h, a.u, a.alpha, a.s, a.tile, a.n_tiles, group, a.q, a.scales,
      a.h_new);
  return (int)cudaGetLastError();
}

int small_regime(const Args& a) {
  const int tile_elems = a.tile.bm * a.tile.bn;
  int group = 4;
  while (group < 32 && group < tile_elems) group <<= 1;
  const int per_lane = (tile_elems + group - 1) / group;
  if (per_lane <= 1) return launch_small<1>(a, group);
  if (per_lane <= 2) return launch_small<2>(a, group);
  if (per_lane <= 4) return launch_small<4>(a, group);
  if (per_lane <= 8) return launch_small<8>(a, group);
  if (per_lane <= 16) return launch_small<16>(a, group);
  return launch_small<32>(a, group);
}

cudaLaunchConfig_t cluster_config(int clusters, int cluster,
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
template <int V, int kR>
int max_cluster() {
  static int cached = 0;
  if (cached) return cached;
  auto kernel = fused_cluster_kernel<V, kR>;
  cached = kPortableCluster;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) == cudaSuccess) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg =
        cluster_config(1, kMaxCluster, &attr, nullptr);
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
template <int V, int kR>
int launch_cluster(const Args& a, int cluster, int share) {
  if (cluster > max_cluster<V, kR>() ||
      (long long)a.n_tiles * cluster >= (1LL << 31))
    return (int)cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(a.n_tiles, cluster, &attr, a.stream);
  return (int)cudaLaunchKernelEx(&cfg, fused_cluster_kernel<V, kR>, a.g,
                                 a.h, a.u, a.alpha, a.s, a.tile, share, a.q,
                                 a.scales, a.h_new);
}

// Regimes 2 and 3 for vectors of V elements.
template <int V>
int cluster_regime(const Args& a) {
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
  int cluster = std::min(want, max_cluster<V, kHeld / V>());
  int share = (n_vec + cluster - 1) / cluster;
  const int per_thread = (share + kCtaThreads - 1) / kCtaThreads;
  if (per_thread <= 1) return launch_cluster<V, 1>(a, cluster, share);
  if (per_thread <= 2) return launch_cluster<V, 2>(a, cluster, share);
  if (per_thread <= 4) return launch_cluster<V, 4>(a, cluster, share);
  if (per_thread <= 8) return launch_cluster<V, 8>(a, cluster, share);
  if constexpr (V == 1) {
    if (per_thread <= 16) return launch_cluster<V, 16>(a, cluster, share);
    if (per_thread <= 32) return launch_cluster<V, 32>(a, cluster, share);
  }
  cluster = std::min(want, max_cluster<V, 0>());
  share = (n_vec + cluster - 1) / cluster;
  return launch_cluster<V, 0>(a, cluster, share);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// g, h, u, q, h_new: [m, n] row-major; scales: [m / bm, n / bn].  The caller
// checks that bm divides m and bn divides n, and that the tile count and
// bm * bn fit in 31 bits.  Returns a cudaError_t: a launch the card refuses
// (a cluster it cannot place, say) returns its error, and no other regime
// is tried.
int fused_memory_update(const float* g, const float* h, const float* u,
                        float alpha, int s, long long m, long long n, int bm,
                        int bn, int8_t* q, float* scales, float* h_new,
                        void* stream) {
  const long long tiles_per_row = n / bn;
  const long long n_tiles = (m / bm) * tiles_per_row;
  if (n_tiles == 0) return (int)cudaSuccess;
  if (n_tiles >= (1LL << 31) || (long long)bm * bn >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const Args a{g, h, u, alpha, s, Tile{n, bm, bn, (int)tiles_per_row},
               (int)n_tiles, q, scales, h_new, (cudaStream_t)stream};
  if ((long long)bm * bn <= kMaxSmallTile) return small_regime(a);
  const bool vec4 = bn % 4 == 0 && aligned16(g) && aligned16(h) &&
                    aligned16(u) && aligned16(h_new) &&
                    (reinterpret_cast<uintptr_t>(q) & 3) == 0;
  return vec4 ? cluster_regime<4>(a) : cluster_regime<1>(a);
}

const char* fused_memory_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
