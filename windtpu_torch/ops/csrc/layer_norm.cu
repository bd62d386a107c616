// LayerNorm over the last axis of a contiguous (rows, n) tensor for Hopper
// (sm_90a): forward, backward and double backward, one kernel each, and a
// small kernel that adds per-block partial sums of the per-channel
// gradients up in a fixed order.
//
// Replaces no TPU kernel: the JAX package leaves flax's LayerNorm to XLA.
// The port ran it on ATen's layer-norm kernels, which launch one block of
// threads per row.  The critic normalises (8, 24, 96, 96, 16) bf16 maps over
// their 16 channels: 1.77 M rows of 32 bytes, a block each, a handful of its
// threads holding data.  Measured on the H100 in the flagship train step,
// ATen's forward ran at about 55x its byte bound and its input gradient at
// about 27x.
//
// What bounds it.  A few operations per element: far below the card's
// ratio of operations to bytes, so bytes alone.  Forward: read x, write y
// and the f32 mean and rstd of each row.  Backward: read dy, x, mean and
// rstd, write dx.  Double backward: read dy, x, the dx gradient ggx, mean
// and rstd, write the dy and x gradients.  At the 96 px map in bf16: 127,
// 184 and 297 MB, 38, 55 and 89 us at 3.35 TB/s.
//
// What the design does about it.  Each tensor is read once and written once
// per stage, in 16-byte vectors where the row allows.  A row is held in
// registers by a group of L lanes (L the row's vectors up to 32; 2 vectors a
// lane past that), 32 / L rows to a warp, so the mean, the variance and the
// backward's row sums are xor shuffles inside the group: no shared memory
// and no barrier.  Two rows per lane are loaded before either is reduced (K
// = 1), to keep bytes in flight.  A persistent grid walks the rows.  The
// per-channel sums (the gradients of gamma and beta) stay in registers over
// the rows a lane visits, then are added over the warp's rows by shuffles
// and over the block's warps in shared memory in a fixed order, to one row
// of partial sums per block; a second kernel adds the blocks' rows in a
// fixed order.  No atomics: the result does not depend on scheduling, so a
// replayed CUDA graph equals an eager call bit for bit.  Statistics and
// arithmetic in f32, as ATen's; results rounded once to the I/O dtype.
//
// With xh = (x - mean) rstd and g = dy gamma, per row of n (ATen's
// layer_norm_backward and layer_norm_double_backward, derived for these
// rows; the bars are means over the row):
//   dx      = rstd (g - mean(g) - xh mean(g xh))
//   dgamma  = sum over rows of dy xh,  dbeta = sum over rows of dy
// and for the gradients ggx, ggg, ggb of dx, dgamma, dbeta, with
//   a = mean(g), b = mean(g xh), c = mean(ggx), q = mean(ggx xh),
//   p = mean(ggx g), e = mean(ggg dy), f = mean(ggg dy xh),
//   h = rstd (ggx - c - xh q):
//   grad dy    = gamma h + ggg xh + ggb
//   grad gamma = sum over rows of dy h
//   grad x     = rstd (ggg dy - e) - rstd^2 (q (g - a) + b (ggx - c))
//                + xh (rstd^2 (3 b q - p + a c) - rstd f)
//
// Plain C interface for ctypes; each entry returns cudaGetLastError() of its
// launches (or cudaErrorInvalidValue for a shape it does not build).  The
// wrapper (windtpu_torch/ops/layer_norm.py) allocates every output and the
// partial sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;

struct F32 {
  using S = float;
  static __device__ __forceinline__ float get(S v) { return v; }
  static __device__ __forceinline__ S put(float v) { return v; }
};

struct BF16 {
  using S = uint16_t;
  static __device__ __forceinline__ float get(S v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
  static __device__ __forceinline__ S put(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

template <int BYTES> struct Raw;
template <> struct Raw<16> { using T = uint4; };
template <> struct Raw<4> { using T = uint32_t; };
template <> struct Raw<2> { using T = uint16_t; };

// W consecutive elements of dtype D as one access.
template <class D, int W> struct Vec {
  using S = typename D::S;
  using R = typename Raw<W * sizeof(S)>::T;
  union U {
    R r;
    S s[W];
  };
  static __device__ __forceinline__ void load(const S* p, float* f) {
    U u;
    u.r = *reinterpret_cast<const R*>(p);
#pragma unroll
    for (int i = 0; i < W; ++i) f[i] = D::get(u.s[i]);
  }
  static __device__ __forceinline__ void store(S* p, const float* f) {
    U u;
#pragma unroll
    for (int i = 0; i < W; ++i) u.s[i] = D::put(f[i]);
    *reinterpret_cast<R*>(p) = u.r;
  }
};

// How a warp covers rows of n elements: groups of L lanes, one row each
// (RPW = 32 / L rows a warp), a lane holding K vectors of W elements, the
// elements (sub + k L) W + i of its row for k < K, i < W, those below n.  U
// row groups are loaded before any is reduced.
template <class D_, int W_, int L_, int K_> struct Tile {
  using D = D_;
  using S = typename D::S;
  static constexpr int W = W_, L = L_, K = K_, E = W * K;
  static constexpr int RPW = 32 / L;
  static constexpr int U = K == 1 ? 2 : 1;
  static constexpr int CH = L * E;   // channels a group covers
};

// The lane's E elements of row ``row`` (zeros where absent or !ok).
template <class T>
__device__ __forceinline__ void load_row(const typename T::S* base,
                                         long long row, bool ok, int sub,
                                         int nv, int n, float* out) {
#pragma unroll
  for (int k = 0; k < T::K; ++k) {
    const int v = sub + k * T::L;
    if (base != nullptr && ok && v < nv) {
      Vec<typename T::D, T::W>::load(base + row * n + v * T::W,
                                     out + k * T::W);
    } else {
#pragma unroll
      for (int i = 0; i < T::W; ++i) out[k * T::W + i] = 0.f;
    }
  }
}

template <class T>
__device__ __forceinline__ void store_row(typename T::S* base, long long row,
                                          bool ok, int sub, int nv, int n,
                                          const float* in) {
#pragma unroll
  for (int k = 0; k < T::K; ++k) {
    const int v = sub + k * T::L;
    if (ok && v < nv) {
      Vec<typename T::D, T::W>::store(base + row * n + v * T::W,
                                      in + k * T::W);
    }
  }
}

// Sum over the L lanes of a row's group.
template <int L>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The block's per-channel sums of ``acc`` (each lane's E channels, summed
// over the rows it visited) into part[blockIdx.x * n + c]: over the warp's
// row slots by shuffles, then over the warps in ``red`` in warp order.
template <class T>
__device__ __forceinline__ void block_channel_sums(float* acc, float* red,
                                                   float* part, int n,
                                                   int lane, int warp) {
#pragma unroll
  for (int o = T::L; o < 32; o <<= 1) {
#pragma unroll
    for (int j = 0; j < T::E; ++j) acc[j] += __shfl_xor_sync(FULL, acc[j], o);
  }
  if (lane < T::L) {
#pragma unroll
    for (int k = 0; k < T::K; ++k) {
#pragma unroll
      for (int i = 0; i < T::W; ++i) {
        red[warp * T::CH + (lane + k * T::L) * T::W + i] = acc[k * T::W + i];
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < n; c += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w * T::CH + c];
    part[static_cast<long long>(blockIdx.x) * n + c] = s;
  }
  __syncthreads();   // red is used again
}

template <class T>
__global__ void __launch_bounds__(THREADS)
    ln_forward(const typename T::S* __restrict__ x,
               const typename T::S* __restrict__ gamma,
               const typename T::S* __restrict__ beta,
               typename T::S* __restrict__ y, float* __restrict__ mean_out,
               float* __restrict__ rstd_out, long long rows, int n,
               float eps) {
  constexpr int E = T::E, U = T::U;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = lane / T::L, sub = lane % T::L;
  const int nv = n / T::W;
  const float inv_n = 1.f / static_cast<float>(n);
  float gam[E], bet[E];
  load_row<T>(gamma, 0, true, sub, nv, n, gam);
  load_row<T>(beta, 0, true, sub, nv, n, bet);
  const long long groups = (rows + T::RPW - 1) / T::RPW;
  const long long stride = static_cast<long long>(gridDim.x) * WARPS * U;
  for (long long g0 = (static_cast<long long>(blockIdx.x) * WARPS + warp) * U;
       g0 < groups; g0 += stride) {
    float v[U][E];
    long long row[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      row[u] = (g0 + u) * T::RPW + slot;
      ok[u] = row[u] < rows;
      load_row<T>(x, row[u], ok[u], sub, nv, n, v[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < E; ++j) s += v[u][j];
      const float mu = row_sum<T::L>(s) * inv_n;
      float q = 0.f;
#pragma unroll
      for (int k = 0; k < T::K; ++k) {
        if (sub + k * T::L < nv) {
#pragma unroll
          for (int i = 0; i < T::W; ++i) {
            const float d = v[u][k * T::W + i] - mu;
            q += d * d;
          }
        }
      }
      const float r = 1.f / sqrtf(row_sum<T::L>(q) * inv_n + eps);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        v[u][j] = (v[u][j] - mu) * r * gam[j] + bet[j];
      }
      store_row<T>(y, row[u], ok[u], sub, nv, n, v[u]);
      if (mean_out != nullptr && ok[u] && sub == 0) {
        mean_out[row[u]] = mu;
        rstd_out[row[u]] = r;
      }
    }
  }
}

template <class T>
__global__ void __launch_bounds__(THREADS)
    ln_backward(const typename T::S* __restrict__ dy,
                const typename T::S* __restrict__ x,
                const float* __restrict__ mean, const float* __restrict__ rstd,
                const typename T::S* __restrict__ gamma,
                typename T::S* __restrict__ dx, float* __restrict__ part_g,
                float* __restrict__ part_b, long long rows, int n) {
  constexpr int E = T::E, U = T::U;
  __shared__ float red[WARPS * T::CH];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = lane / T::L, sub = lane % T::L;
  const int nv = n / T::W;
  const float inv_n = 1.f / static_cast<float>(n);
  float gam[E], acc_g[E], acc_b[E];
  load_row<T>(gamma, 0, true, sub, nv, n, gam);
#pragma unroll
  for (int j = 0; j < E; ++j) acc_g[j] = acc_b[j] = 0.f;
  const long long groups = (rows + T::RPW - 1) / T::RPW;
  const long long stride = static_cast<long long>(gridDim.x) * WARPS * U;
  for (long long g0 = (static_cast<long long>(blockIdx.x) * WARPS + warp) * U;
       g0 < groups; g0 += stride) {
    float d[U][E], v[U][E], mu[U], r[U];
    long long row[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      row[u] = (g0 + u) * T::RPW + slot;
      ok[u] = row[u] < rows;
      load_row<T>(dy, row[u], ok[u], sub, nv, n, d[u]);
      load_row<T>(x, row[u], ok[u], sub, nv, n, v[u]);
      mu[u] = ok[u] ? mean[row[u]] : 0.f;
      r[u] = ok[u] ? rstd[row[u]] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int j = 0; j < E; ++j) v[u][j] = (v[u][j] - mu[u]) * r[u];   // xh
      if (part_g != nullptr) {
#pragma unroll
        for (int j = 0; j < E; ++j) acc_g[j] += d[u][j] * v[u][j];
      }
      if (part_b != nullptr) {
#pragma unroll
        for (int j = 0; j < E; ++j) acc_b[j] += d[u][j];
      }
      if (dx != nullptr) {
        float sa = 0.f, sb = 0.f;
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float g = d[u][j] * gam[j];
          sa += g;
          sb += g * v[u][j];
        }
        const float a = row_sum<T::L>(sa) * inv_n;
        const float b = row_sum<T::L>(sb) * inv_n;
#pragma unroll
        for (int j = 0; j < E; ++j) {
          d[u][j] = r[u] * (d[u][j] * gam[j] - a - v[u][j] * b);
        }
        store_row<T>(dx, row[u], ok[u], sub, nv, n, d[u]);
      }
    }
  }
  if (part_g != nullptr) {
    block_channel_sums<T>(acc_g, red, part_g, n, lane, warp);
  }
  if (part_b != nullptr) {
    block_channel_sums<T>(acc_b, red, part_b, n, lane, warp);
  }
}

template <class T>
__global__ void __launch_bounds__(THREADS)
    ln_double_backward(const typename T::S* __restrict__ dy,
                       const typename T::S* __restrict__ x,
                       const float* __restrict__ mean,
                       const float* __restrict__ rstd,
                       const typename T::S* __restrict__ gamma,
                       const typename T::S* __restrict__ ggx,
                       const typename T::S* __restrict__ ggg,
                       const typename T::S* __restrict__ ggb,
                       typename T::S* __restrict__ gdy,
                       typename T::S* __restrict__ gx,
                       float* __restrict__ part_g, long long rows, int n) {
  constexpr int E = T::E, U = T::U;
  __shared__ float red[WARPS * T::CH];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = lane / T::L, sub = lane % T::L;
  const int nv = n / T::W;
  const float inv_n = 1.f / static_cast<float>(n);
  float gam[E], g3[E], b3[E], acc[E];
  load_row<T>(gamma, 0, true, sub, nv, n, gam);
  load_row<T>(ggg, 0, true, sub, nv, n, g3);   // zeros where absent
  load_row<T>(ggb, 0, true, sub, nv, n, b3);
#pragma unroll
  for (int j = 0; j < E; ++j) acc[j] = 0.f;
  const long long groups = (rows + T::RPW - 1) / T::RPW;
  const long long stride = static_cast<long long>(gridDim.x) * WARPS * U;
  for (long long g0 = (static_cast<long long>(blockIdx.x) * WARPS + warp) * U;
       g0 < groups; g0 += stride) {
    float d[U][E], v[U][E], z[U][E], mu[U], r[U];
    long long row[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      row[u] = (g0 + u) * T::RPW + slot;
      ok[u] = row[u] < rows;
      load_row<T>(dy, row[u], ok[u], sub, nv, n, d[u]);
      load_row<T>(x, row[u], ok[u], sub, nv, n, v[u]);
      load_row<T>(ggx, row[u], ok[u], sub, nv, n, z[u]);
      mu[u] = ok[u] ? mean[row[u]] : 0.f;
      r[u] = ok[u] ? rstd[row[u]] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float sa = 0.f, sb = 0.f, sc = 0.f, sq = 0.f, sp = 0.f, se = 0.f,
            sf = 0.f;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        v[u][j] = (v[u][j] - mu[u]) * r[u];   // xh
        const float g = d[u][j] * gam[j];
        const float gd = g3[j] * d[u][j];
        sa += g;
        sb += g * v[u][j];
        sc += z[u][j];
        sq += z[u][j] * v[u][j];
        sp += z[u][j] * g;
        se += gd;
        sf += gd * v[u][j];
      }
      const float c = row_sum<T::L>(sc) * inv_n;
      const float q = row_sum<T::L>(sq) * inv_n;
      const float ru = r[u];
      float h[E];
#pragma unroll
      for (int j = 0; j < E; ++j) h[j] = ru * (z[u][j] - c - v[u][j] * q);
      if (part_g != nullptr) {
#pragma unroll
        for (int j = 0; j < E; ++j) acc[j] += d[u][j] * h[j];
      }
      if (gx != nullptr) {
        const float a = row_sum<T::L>(sa) * inv_n;
        const float b = row_sum<T::L>(sb) * inv_n;
        const float p = row_sum<T::L>(sp) * inv_n;
        const float e = row_sum<T::L>(se) * inv_n;
        const float f = row_sum<T::L>(sf) * inv_n;
        const float r2 = ru * ru;
        const float kx = r2 * (3.f * b * q - p + a * c) - ru * f;
        float out[E];
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float g = d[u][j] * gam[j];
          out[j] = ru * (g3[j] * d[u][j] - e) -
                   r2 * (q * (g - a) + b * (z[u][j] - c)) + v[u][j] * kx;
        }
        store_row<T>(gx, row[u], ok[u], sub, nv, n, out);
      }
      if (gdy != nullptr) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          h[j] = gam[j] * h[j] + g3[j] * v[u][j] + b3[j];
        }
        store_row<T>(gdy, row[u], ok[u], sub, nv, n, h);
      }
    }
  }
  if (part_g != nullptr) {
    block_channel_sums<T>(acc, red, part_g, n, lane, warp);
  }
}

// out[c] = sum over the ``blocks`` rows of part (blocks, n), in row order
// within each of 32 strided slices, then over the slices in order.
// blockIdx.y picks (part_g, out_g) or (part_b, out_b); an absent output is
// skipped.
template <class D>
__global__ void __launch_bounds__(1024)
    ln_channel_sums(const float* __restrict__ part_g,
                    const float* __restrict__ part_b, int blocks, int n,
                    typename D::S* __restrict__ out_g,
                    typename D::S* __restrict__ out_b) {
  const float* part = blockIdx.y ? part_b : part_g;
  typename D::S* out = blockIdx.y ? out_b : out_g;
  if (out == nullptr) return;
  __shared__ float red[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (c < n) {
    for (int r = threadIdx.y; r < blocks; r += 32) {
      s += part[static_cast<long long>(r) * n + c];
    }
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < n) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) t += red[i][threadIdx.x];
    out[c] = D::put(t);
  }
}

// A persistent grid: as many blocks as fit on the card at once, at most the
// blocks the rows fill and ``cap`` (the rows of the partial sums the
// wrapper allocated; 0 for none), spread so that every block walks the same
// number of passes but the last.
template <class T, class Kernel>
int grid_for(Kernel kernel, long long rows, int cap, int* grid) {
  static int per_sm = 0;   // per instantiation
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess && per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per_block = static_cast<long long>(WARPS) * T::RPW * T::U;
  const long long need = (rows + per_block - 1) / per_block;
  long long g = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (cap > 0 && g > cap) g = cap;
  if (g > need) g = need;
  const long long passes = (need + g - 1) / g;
  g = (need + passes - 1) / passes;
  *grid = static_cast<int>(g);
  return 0;
}

// The arguments of each entry, and a stage that launches them for a tile.
struct Forward {
  long long rows;
  int n;
  float eps;
  const void *x, *gamma, *beta;
  void *y, *mean, *rstd;
  cudaStream_t s;

  template <class T> int run() const {
    using S = typename T::S;
    int grid = 0;
    const int err = grid_for<T>(ln_forward<T>, rows, 0, &grid);
    if (err) return err;
    ln_forward<T><<<grid, THREADS, 0, s>>>(
        static_cast<const S*>(x), static_cast<const S*>(gamma),
        static_cast<const S*>(beta), static_cast<S*>(y),
        static_cast<float*>(mean), static_cast<float*>(rstd), rows, n, eps);
    return static_cast<int>(cudaGetLastError());
  }
};

template <class D>
int launch_channel_sums(const float* part_g, const float* part_b, int blocks,
                        int n, void* out_g, void* out_b, cudaStream_t s) {
  using S = typename D::S;
  const dim3 grid((n + 31) / 32, out_b != nullptr ? 2 : 1);
  ln_channel_sums<D><<<grid, dim3(32, 32), 0, s>>>(
      part_g, part_b, blocks, n, static_cast<S*>(out_g),
      static_cast<S*>(out_b));
  return static_cast<int>(cudaGetLastError());
}

struct Backward {
  long long rows;
  int n;
  const void *dy, *x, *mean, *rstd, *gamma;
  void *dx, *dgamma, *dbeta, *part;
  int cap;
  cudaStream_t s;

  template <class T> int run() const {
    using S = typename T::S;
    const bool sums = dgamma != nullptr || dbeta != nullptr;
    if (sums && (part == nullptr || cap < 1)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    int grid = 0;
    int err = grid_for<T>(ln_backward<T>, rows, cap, &grid);
    if (err) return err;
    float* part_g = dgamma != nullptr ? static_cast<float*>(part) : nullptr;
    float* part_b = dbeta != nullptr
                        ? static_cast<float*>(part) +
                              static_cast<long long>(cap) * n
                        : nullptr;
    ln_backward<T><<<grid, THREADS, 0, s>>>(
        static_cast<const S*>(dy), static_cast<const S*>(x),
        static_cast<const float*>(mean), static_cast<const float*>(rstd),
        static_cast<const S*>(gamma), static_cast<S*>(dx), part_g, part_b,
        rows, n);
    err = static_cast<int>(cudaGetLastError());
    if (err || !sums) return err;
    if (dgamma == nullptr) {   // dbeta alone: its sums as the first output
      return launch_channel_sums<typename T::D>(part_b, nullptr, grid, n,
                                                dbeta, nullptr, s);
    }
    return launch_channel_sums<typename T::D>(part_g, part_b, grid, n, dgamma,
                                              dbeta, s);
  }
};

struct DoubleBackward {
  long long rows;
  int n;
  const void *dy, *x, *mean, *rstd, *gamma, *ggx, *ggg, *ggb;
  void *gdy, *gx, *ggamma, *part;
  int cap;
  cudaStream_t s;

  template <class T> int run() const {
    using S = typename T::S;
    if (ggamma != nullptr && (part == nullptr || cap < 1)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    int grid = 0;
    int err = grid_for<T>(ln_double_backward<T>, rows, cap, &grid);
    if (err) return err;
    float* part_g = ggamma != nullptr ? static_cast<float*>(part) : nullptr;
    ln_double_backward<T><<<grid, THREADS, 0, s>>>(
        static_cast<const S*>(dy), static_cast<const S*>(x),
        static_cast<const float*>(mean), static_cast<const float*>(rstd),
        static_cast<const S*>(gamma), static_cast<const S*>(ggx),
        static_cast<const S*>(ggg), static_cast<const S*>(ggb),
        static_cast<S*>(gdy), static_cast<S*>(gx), part_g, rows, n);
    err = static_cast<int>(cudaGetLastError());
    if (err || ggamma == nullptr) return err;
    return launch_channel_sums<typename T::D>(part_g, nullptr, grid, n,
                                              ggamma, nullptr, s);
  }
};

// Runs ``stage`` with the tile that covers its rows of n elements in
// vectors of W elements of dtype D.
template <class D, int W, class Stage>
int by_vectors(const Stage& stage) {
  const int nv = stage.n / W;
  if (nv <= 1) return stage.template run<Tile<D, W, 1, 1>>();
  if (nv <= 2) return stage.template run<Tile<D, W, 2, 1>>();
  if (nv <= 4) return stage.template run<Tile<D, W, 4, 1>>();
  if (nv <= 8) return stage.template run<Tile<D, W, 8, 1>>();
  if (nv <= 16) return stage.template run<Tile<D, W, 16, 1>>();
  if (nv <= 32) return stage.template run<Tile<D, W, 32, 1>>();
  if (nv <= 64) return stage.template run<Tile<D, W, 32, 2>>();
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype code 0 f32, 1 bf16; w elements a vector: 16 bytes or 1 element.
template <class Stage>
int dispatch(int dtype, int w, const Stage& stage) {
  if (stage.rows < 1 || stage.n < 1 || w < 1 || stage.n % w != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0 && w == 4) return by_vectors<F32, 4>(stage);
  if (dtype == 0 && w == 1) return by_vectors<F32, 1>(stage);
  if (dtype == 1 && w == 8) return by_vectors<BF16, 8>(stage);
  if (dtype == 1 && w == 1) return by_vectors<BF16, 1>(stage);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// y = (x - mean) rstd gamma + beta over rows of n; mean and rstd (rows,) f32
// are written where given (both or neither).
extern "C" int windtpu_layer_norm_forward(int dtype, int w, long long rows,
                                          int n, float eps, const void* x,
                                          const void* gamma, const void* beta,
                                          void* y, void* mean, void* rstd,
                                          void* stream) {
  return dispatch(dtype, w,
                  Forward{rows, n, eps, x, gamma, beta, y, mean, rstd,
                          static_cast<cudaStream_t>(stream)});
}

// dx, dgamma, dbeta where given (null: not computed).  ``part`` holds 2 x
// cap x n floats of scratch for the per-block sums where dgamma or dbeta is
// given (else null, cap 0).
extern "C" int windtpu_layer_norm_backward(
    int dtype, int w, long long rows, int n, const void* dy, const void* x,
    const void* mean, const void* rstd, const void* gamma, void* dx,
    void* dgamma, void* dbeta, void* part, int cap, void* stream) {
  return dispatch(dtype, w,
                  Backward{rows, n, dy, x, mean, rstd, gamma, dx, dgamma,
                           dbeta, part, cap,
                           static_cast<cudaStream_t>(stream)});
}

// The gradients of dy, x and gamma (where given) from those of dx, dgamma
// and dbeta (ggx, ggg, ggb; null reads as zero).  ``part`` holds cap x n
// floats of scratch for the per-block sums of the gamma gradient where it is
// given (else null, cap 0).
extern "C" int windtpu_layer_norm_double_backward(
    int dtype, int w, long long rows, int n, const void* dy, const void* x,
    const void* mean, const void* rstd, const void* gamma, const void* ggx,
    const void* ggg, const void* ggb, void* gdy, void* gx, void* ggamma,
    void* part, int cap, void* stream) {
  return dispatch(dtype, w,
                  DoubleBackward{rows, n, dy, x, mean, rstd, gamma, ggx, ggg,
                                 ggb, gdy, gx, ggamma, part, cap,
                                 static_cast<cudaStream_t>(stream)});
}
