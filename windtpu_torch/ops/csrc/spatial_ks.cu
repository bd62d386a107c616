// Spatially-convolved Kolmogorov-Smirnov statistic for Hopper (sm_90a).
//
// Replaces the TPU kernel windtpu/ops/pallas_ks.py:spatial_ks_pallas (body
// _ks_kernel, helper _band_matrix).  For each of the N = B*T*C (time,
// channel) fields of real and fake (B, T, H, W, C) it computes, for every
// patch x patch VALID window,
//
//   ks = max over thresholds p of | mean(real <= p) - mean(fake <= p) |
//
// over the window's pixels: an (OH, OW) = (H-patch+1, W-patch+1) image per
// field pair.  The caller averages over the pairs.
//
// What bounds it.  At the training step's shape (N = 96 pairs of 96 x 96,
// patch 9, 100 thresholds) the compulsory traffic is N*(2*H*W + OH*OW)*4 =
// 10.1 MB, 3.0 us at 3.35 TB/s, while the running-sum form of the arithmetic
// needs per pair and threshold 2*H*W comparisons, H*W differences, 2*OH*W
// vertical and 2*OH*OW horizontal adds and 2*OH*OW for |.| and max: 75,520
// operations, 7.25e8 in all, 10.8 us at the 67e12 non-tensor operations per
// second of the data sheet.  It is bound by operations on the CUDA cores, at
// 0.0108 ms.
//
// What the design does about it.  The TPU kernel turns the box filter into
// two banded matmuls because cumsum does not lower there; here the filter is
// sums in shared memory over integers.  A block owns one field pair and a
// band of ROWS output rows and reads the band's input rows once, straight
// from the (B, T, H, W, C) tensors (f32 or bf16), so device memory is read
// once and written once.  Both means share the denominator patch^2, so it
// counts window sums of real <= p and of fake <= p as integers, takes the max
// of their |difference| as an integer, and divides by patch^2 once, when the
// band is written.
//
// The thresholds run in parallel, not in sequence:
// - Each pixel's threshold index k(v) = the first k with v <= points[k]
//   (n_points for a NaN, which is never <= p, and for a value above every
//   point) is found once, by a branch-free binary search over the points
//   themselves (linspace's points are not exactly uniform, so no arithmetic
//   from lo and hi could stand in for them), 16 values at once, and kept in
//   shared memory, times 32/L, beside the fake field's.  As the points
//   ascend, [v <= points[k]] = [k >= k(v)]: no float comparison is left per
//   threshold.
// - L consecutive thresholds share one 32-bit word, one count per byte (L =
//   4, patch <= 10) or per half (L = 2, patch <= 180).  A pixel's indicator
//   word for thresholds k0..k0+L-1 is one funnel shift of 0x01010101 (or
//   0x00010001) by k(v) - k0 clamped to [0, L] fields: a subtract-and-max
//   and the clamping funnel shift.  Real and fake are
//   folded into one word per pixel, e = 1 + [real <= p] - [fake <= p] in
//   every field (0, 1 or 2), so one integer add counts L thresholds of both
//   fields at once, and a window sum S = patch^2 + (count_real - count_fake)
//   stays in [0, 2 patch^2]: no field carries into its neighbour.
// - A warp owns a strip of output columns and a share of the threshold
//   groups, with no block barrier between groups.  Vertical pass: lanes
//   over the strip's columns keep running prefix sums down the band.
//   Horizontal pass: lanes over (row, half-strip) slide along the strip,
//   reading each column's window sum as a difference of two prefixes, and
//   keep the max |S - patch^2| of their outputs in registers, per field:
//   max(a, b) = (a + b + |a - b|) / 2 on the SIMD absolute difference
//   (fields hold at most patch^2, so a + b + |a - b| cannot carry).  A
//   warp's maxima meet the other warps' in shared memory by one integer
//   atomicMax per output, once per strip.
// - Loads run ahead of stores: the vertical pass reads four rows of k(v)
//   before it writes their sums, which the compiler would not reorder.
// Bands of ROWS = 16 rows and 4 warps a block give N * ceil(OH/16) = 576
// blocks at the training shape, all resident at once (about 39 KB and 80
// registers each).
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit, at the training shape: 0.075 ms for the kernel, 0.080 ms through
// the wrapper (the thresholds in sequence took 0.316 ms, a first parallel
// form with two 32-bit counts per pixel and an atomicMax per output and
// group 0.098), 7x the 0.0108 ms bound.  ops/ks_variants.py splits the time:
// about a third each for the loads with the threshold search, the vertical
// pass and the horizontal pass.  What is left: the search's bank conflicts
// and the 50% halo of 16-row bands in the vertical pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16;                // output rows per band
constexpr int SEGS = 32 / ROWS;         // lanes per output row, horizontally
constexpr int MAXSL = (32 / SEGS) | 1;  // outputs per lane and strip
constexpr int MAX_PATCH = 180;          // what 16-bit counts hold
constexpr size_t MAX_SMEM = 232448;     // what one block can opt in to

struct Layout {
  int rin;       // input rows per band: ROWS + patch - 1
  int sw;        // output columns per strip
  int sl;        // output columns per lane (odd): ceil(sw / SEGS) | 1
  int cwp;       // stride (words) of a warp's prefix sums, == SEGS mod 32
  int owp;       // stride (ints) of the running max, == SEGS mod 32
  size_t bytes;  // dynamic shared memory
};

// The least stride >= n that is congruent to SEGS mod 32: with an odd sl,
// the lanes (row y, half s) of a horizontal step, at y * stride + s * sl + x,
// then fall in 32 distinct banks.
int bank_stride(int n) { return n + ((SEGS - n) % 32 + 32) % 32; }

// Point k sits at k + k/32 in shared memory, so that the binary search's
// probes at multiples of powers of two fall in different banks.
__host__ __device__ __forceinline__ int skew(int k) { return k + (k >> 5); }

Layout layout(int W, int OW, int patch, int n_points) {
  Layout l;
  l.rin = ROWS + patch - 1;
  l.sw = patch <= 16 ? 33 - patch : 32;   // sw + patch - 1 = 32 lanes
  if (l.sw > OW) l.sw = OW;
  l.sl = ((l.sw + SEGS - 1) / SEGS) | 1;
  l.cwp = bank_stride(l.sw + patch - 1);
  l.owp = bank_stride(OW);
  l.bytes = (size_t)WARPS * (l.rin + 1) * l.cwp * sizeof(uint32_t)  // sums
            + (size_t)l.rin * W * sizeof(int2)         // k(real), k(fake)
            + (size_t)ROWS * l.owp * sizeof(int)       // running max
            + (size_t)skew(n_points) * sizeof(float);  // the points
  return l;
}

// For U values at once, the first k with v <= points[k] (n for a NaN or a v
// above every point): a binary search over the ascending points, written as
// the count of leading points with !(v <= p), with no branch.
template <int U>
__device__ __forceinline__ void threshold_index(const float* pts, int n,
                                                const float (&v)[U],
                                                int (&pos)[U]) {
#pragma unroll
  for (int q = 0; q < U; ++q) pos[q] = 0;
  for (int step = 1 << (31 - __clz(n)); step > 0; step >>= 1) {
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int c = pos[q] + step;
      if (c <= n && !(v[q] <= pts[skew(c - 1)])) pos[q] = c;
    }
  }
}

// Value i of a (B, T, H, W, C) tensor of f32 (bf16 = 0) or bf16 (bf16 = 1).
__device__ __forceinline__ float load(const void* p, int bf16, size_t i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// Field i (of L, each 32/L bits wide) of the result is [k0 + i >= k], from
// kb = k * 32/L and k0b = k0 * 32/L: the funnel shift clamps at 32.
template <int L>
__device__ __forceinline__ uint32_t below(int kb, int k0b) {
  constexpr uint32_t unit = L == 4 ? 0x01010101u : 0x00010001u;
  return __funnelshift_lc(0u, unit, (unsigned)__viaddmax_s32(kb, -k0b, 0));
}

// Per field, |a - b|, and the max of two words whose fields are at most
// 2^(32/L - 1) (here at most patch^2): (a + b + |a - b|) / 2, where the sum
// cannot carry and every field of it is even.
template <int L>
__device__ __forceinline__ uint32_t abs_diff(uint32_t a, uint32_t b) {
  return L == 4 ? __vabsdiffu4(a, b) : __vabsdiffu2(a, b);
}
template <int L>
__device__ __forceinline__ uint32_t field_max(uint32_t a, uint32_t b) {
  return (a + b + abs_diff<L>(a, b)) >> 1;
}
// The largest field of a word.
template <int L>
__device__ __forceinline__ int widest(uint32_t w) {
  if (L == 4) {
    const uint32_t m = __vmaxu4(w, w >> 16);
    return (int)max(m & 0xffu, (m >> 8) & 0xffu);
  }
  return (int)max(w & 0xffffu, w >> 16);
}

// The explicit least of one block per SM lets ptxas take 80 registers where
// it takes 56 without it, and the kernel runs 6% faster (ops/ks_variants.py:
// 0.0746 against 0.0793 ms); 576 blocks of 80 registers still fit at once.
template <int L>
__global__ void __launch_bounds__(THREADS, 1)
spatial_ks_kernel(const void* __restrict__ real, int real_bf16,
                  const void* __restrict__ fake, int fake_bf16,
                  const float* __restrict__ points, float* __restrict__ out,
                  int C, int H, int W, int patch, int n_points, int sw, int sl,
                  int cwp, int owp) {
  constexpr uint32_t unit = L == 4 ? 0x01010101u : 0x00010001u;
  extern __shared__ __align__(16) unsigned char smem[];
  const int OH = H - patch + 1;
  const int OW = W - patch + 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = blockIdx.x;                  // field: (b, t) * C + channel
  const int y0 = blockIdx.y * ROWS;          // first output row of the band
  const int r_out = min(ROWS, OH - y0);
  const int r_in = r_out + patch - 1;
  const int rin_max = ROWS + patch - 1;

  // The 8-byte array first.  kp holds k(real) and k(fake) times 32/L.
  int2* kp = reinterpret_cast<int2*>(smem);
  uint32_t* sums = reinterpret_cast<uint32_t*>(kp + (size_t)rin_max * W) +
                   (size_t)warp * (rin_max + 1) * cwp;
  int* mx = reinterpret_cast<int*>(kp + (size_t)rin_max * W) +
            (size_t)WARPS * (rin_max + 1) * cwp;
  float* pts = reinterpret_cast<float*>(mx + ROWS * owp);

  for (int i = tid; i < n_points; i += THREADS) pts[skew(i)] = points[i];
  for (int i = tid; i < ROWS * owp; i += THREADS) mx[i] = 0;
  __syncthreads();

  // The band's pixels are contiguous in (H, W); value i of the band is at
  // (base + i) * C + channel.
  const size_t base = ((size_t)(n / C) * H + y0) * W;
  const int ch = n % C;
  constexpr int U = 8;                       // pixels per thread and pass
  for (int i0 = tid; i0 < r_in * W; i0 += U * THREADS) {
    float v[2 * U];
    int k[2 * U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const size_t at = (base + min(i0 + u * THREADS, r_in * W - 1)) * C + ch;
      v[2 * u] = load(real, real_bf16, at);
      v[2 * u + 1] = load(fake, fake_bf16, at);
    }
    threshold_index(pts, n_points, v, k);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * THREADS;
      if (i < r_in * W) {
        kp[i] = make_int2(k[2 * u] * (32 / L), k[2 * u + 1] * (32 / L));
      }
    }
  }
  __syncthreads();

  // This lane's outputs in the horizontal pass: row hy, columns hx .. hx +
  // len - 1 of the strip.
  const int hy = lane / SEGS;
  const int hx = (lane % SEGS) * sl;
  const uint32_t p2 = (uint32_t)(patch * patch) * unit;
  const int strips = (OW + sw - 1) / sw;
  const int groups = (n_points + L - 1) / L;
  const int parts = max(1, WARPS / strips);  // warps sharing a strip
  for (int item = warp; item < strips * parts; item += WARPS) {
    const int x0 = (item % strips) * sw;
    const int xs = min(sw, OW - x0);         // outputs in this strip
    const int cols = xs + patch - 1;         // input columns of the strip
    const int len = hy < r_out ? min(sl, xs - hx) : 0;
    uint32_t best[MAXSL];
#pragma unroll
    for (int x = 0; x < MAXSL; ++x) best[x] = 0;
    for (int g = item / strips; g < groups; g += parts) {
      const int k0b = g * 32;                // k0 * 32/L, k0 = g * L
      // Vertical pass: sums[r][cx] = sum of e over input rows < r of column
      // x0 + cx.  Thresholds k >= n_points count 1 in both fields.
      // Four rows' loads go ahead of their stores, which the compiler
      // would not move past each other.
      for (int cx = lane; cx < cols; cx += 32) {
        const int2* colp = kp + x0 + cx;
        uint32_t* col = sums + cx;
        uint32_t acc = 0;
        col[0] = 0;
        int r = 0;
        for (; r + 4 <= r_in; r += 4) {
          int2 kk[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) kk[q] = colp[(r + q) * W];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc = acc + unit + below<L>(kk[q].x, k0b) - below<L>(kk[q].y, k0b);
            col[(r + q + 1) * cwp] = acc;
          }
        }
        for (; r < r_in; ++r) {
          const int2 kk = colp[r * W];
          acc = acc + unit + below<L>(kk.x, k0b) - below<L>(kk.y, k0b);
          col[(r + 1) * cwp] = acc;
        }
      }
      __syncwarp();
      // Horizontal pass: the window sum S of output (hy, x) slides along
      // the strip; a column's vertical window is the difference of two
      // prefix sums, patch rows apart.
      if (len > 0) {
        const uint32_t* top = sums + hy * cwp + hx;
        const uint32_t* bot = top + patch * cwp;
        uint32_t s = 0;
        for (int dx = 0; dx < patch; ++dx) s += bot[dx] - top[dx];
        best[0] = field_max<L>(best[0], abs_diff<L>(s, p2));
#pragma unroll
        for (int x = 1; x < MAXSL; ++x) {
          if (x < len) {
            s = s + (bot[x + patch - 1] - top[x + patch - 1]) -
                (bot[x - 1] - top[x - 1]);
            best[x] = field_max<L>(best[x], abs_diff<L>(s, p2));
          }
        }
      }
      __syncwarp();   // sums is rewritten by the next group
    }
    int* row = mx + hy * owp + x0 + hx;
#pragma unroll
    for (int x = 0; x < MAXSL; ++x) {
      if (x < len) atomicMax(row + x, widest<L>(best[x]));
    }
  }
  __syncthreads();

  const float area = (float)patch * (float)patch;
  const size_t obase = ((size_t)n * OH + y0) * OW;
  for (int i = tid; i < r_out * OW; i += THREADS) {
    const int y = i / OW;
    const int x = i % OW;
    out[obase + i] = __fdiv_rn((float)mx[y * owp + x], area);
  }
}

// cudaFuncSetAttribute once per kernel, device and size: a host call that
// each launch would otherwise pay.
template <int L>
cudaError_t opt_in(size_t bytes) {
  static size_t done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(spatial_ks_kernel<L>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = bytes;
  return err;
}

template <int L>
int launch(const void* real, int real_bf16, const void* fake, int fake_bf16,
           const void* points, void* out, int N, int C, int H, int W,
           int patch, int n_points, const Layout& l, void* stream) {
  cudaError_t err = opt_in<L>(l.bytes);
  if (err != cudaSuccess) return (int)err;
  const int OH = H - patch + 1;
  const dim3 grid((unsigned)N, (unsigned)((OH + ROWS - 1) / ROWS));
  spatial_ks_kernel<L><<<grid, THREADS, l.bytes, (cudaStream_t)stream>>>(
      real, real_bf16, fake, fake_bf16, static_cast<const float*>(points),
      static_cast<float*>(out), C, H, W, patch, n_points, l.sw, l.sl, l.cwp,
      l.owp);
  return (int)cudaGetLastError();
}

}  // namespace

// KS images of the N = B*T*C field pairs of real and fake, (B, T, H, W, C)
// contiguous, each f32 (dtype 0) or bf16 (dtype 1); points (n_points,) f32
// ascending; out (N, H-patch+1, W-patch+1) f32, field (b*T + t)*C + c.
// Returns the launch's cudaGetLastError() code (0 on success), or
// cudaErrorInvalidValue without launching for sizes or types it does not
// take, or cudaErrorInvalidConfiguration when a band does not fit in shared
// memory.
extern "C" int windtpu_spatial_ks(const void* real, int real_dtype,
                                  const void* fake, int fake_dtype,
                                  const void* points, void* out, int N, int C,
                                  int H, int W, int patch, int n_points,
                                  void* stream) {
  if (N < 1 || C < 1 || N % C || patch < 1 || patch > H || patch > W ||
      n_points < 1 || n_points > (1 << 25) || (real_dtype | fake_dtype) & ~1) {
    return (int)cudaErrorInvalidValue;
  }
  const int OH = H - patch + 1;
  const int OW = W - patch + 1;
  const Layout l = layout(W, OW, patch, n_points);
  if (l.bytes > MAX_SMEM || patch > MAX_PATCH) {
    return (int)cudaErrorInvalidConfiguration;
  }
  if ((OH + ROWS - 1) / ROWS > 65535) {
    return (int)cudaErrorInvalidConfiguration;
  }
  if (patch <= 10) {
    return launch<4>(real, real_dtype, fake, fake_dtype, points, out, N, C, H,
                     W, patch, n_points, l, stream);
  }
  return launch<2>(real, real_dtype, fake, fake_dtype, points, out, N, C, H,
                   W, patch, n_points, l, stream);
}
