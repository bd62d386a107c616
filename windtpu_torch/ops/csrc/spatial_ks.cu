// Spatially-convolved Kolmogorov-Smirnov statistic for Hopper (sm_90a).
//
// Replaces the TPU kernel windtpu/ops/pallas_ks.py:spatial_ks_pallas (body
// _ks_kernel, helper _band_matrix).  For each of N pairs of f32 fields
// (H, W) it computes, for every patch x patch VALID window,
//
//   ks = max over thresholds p of | mean(real <= p) - mean(fake <= p) |
//
// over the window's pixels: an (OH, OW) = (H-patch+1, W-patch+1) image per
// pair.  The caller averages over the pairs.
//
// What bounds it.  At the training step's shape (N = 96 pairs of 96 x 96,
// patch 9, 100 thresholds) the compulsory traffic is N*(2*H*W + OH*OW)*4 =
// 10.1 MB, 3.0 us at 3.35 TB/s, while the running-sum form of the arithmetic
// needs per pair and threshold 2*H*W comparisons, H*W differences, 2*OH*W
// vertical and 2*OH*OW horizontal adds and 2*OH*OW for |.| and max: 75,520
// operations, 7.25e8 in all, 10.8 us at the 67e12 non-tensor operations per
// second of the data sheet.  It is bound by the arithmetic on the CUDA cores.
//
// What the design does about it.  The TPU kernel turns the box filter into
// two banded matmuls because cumsum does not lower there; here the filter is
// two passes of sliding sums in shared memory.  A block owns one pair and a
// band of output rows; it loads the band's input rows once and loops over the
// thresholds on chip, so device memory is read once and written once.  Since
// both means share the denominator patch^2, the block counts the signed
// difference d = (real <= p) - (fake <= p) in {-1, 0, 1} as integers: window
// sums of d are exact, the running max of |sum| is an integer, and the one
// division by patch^2 happens when the band is written.  Each pass cuts its
// lines into segments of SEG outputs (a direct sum of patch terms, then
// SEG-1 slides), which gives the 256 threads enough independent work at the
// price of patch/SEG extra reads.  A NaN is not <= p, as in the plain
// version.  Bands are sized so that N * bands blocks cover the card and the
// band fits in shared memory.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 256;
constexpr int SEG = 16;                 // outputs per sliding-sum segment
constexpr int TARGET_BLOCKS = 264;      // two blocks for each of 132 SMs
constexpr size_t MAX_SMEM = 232448;     // what one block can opt in to

struct Layout {
  int rows;      // output rows per band
  int rin;       // input rows per band: rows + patch - 1
  int wp;        // padded (odd) stride of the vertical sums
  int owp;       // padded (odd) stride of the running max
  size_t bytes;  // dynamic shared memory
};

Layout layout(int W, int OW, int patch, int rows) {
  Layout l;
  l.rows = rows;
  l.rin = rows + patch - 1;
  l.wp = W | 1;
  l.owp = OW | 1;
  l.bytes = 2 * (size_t)l.rin * W * sizeof(float)   // the two fields
            + (size_t)rows * l.wp * sizeof(int)      // vertical sums
            + (size_t)rows * l.owp * sizeof(int)     // running max
            + (size_t)l.rin * W;                     // d, one byte a pixel
  return l;
}

__global__ void __launch_bounds__(THREADS)
spatial_ks_kernel(const float* __restrict__ real,
                  const float* __restrict__ fake,
                  const float* __restrict__ points, float* __restrict__ out,
                  int H, int W, int patch, int n_points, int rows, int wp,
                  int owp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int OH = H - patch + 1;
  const int OW = W - patch + 1;
  const int tid = threadIdx.x;
  const size_t n = blockIdx.x;
  const int y0 = blockIdx.y * rows;          // first output row of the band
  const int r_out = min(rows, OH - y0);
  const int r_in = r_out + patch - 1;
  const int rin_max = rows + patch - 1;

  float* fr = reinterpret_cast<float*>(smem);
  float* ff = fr + (size_t)rin_max * W;
  int* col = reinterpret_cast<int*>(ff + (size_t)rin_max * W);
  int* mx = col + (size_t)rows * wp;
  signed char* d = reinterpret_cast<signed char*>(mx + (size_t)rows * owp);

  const size_t base = (n * H + y0) * W;      // the band's rows are contiguous
  for (int i = tid; i < r_in * W; i += THREADS) {
    fr[i] = real[base + i];
    ff[i] = fake[base + i];
  }
  for (int i = tid; i < r_out * owp; i += THREADS) mx[i] = 0;
  __syncthreads();

  const int vseg = (r_out + SEG - 1) / SEG;
  const int hseg = (OW + SEG - 1) / SEG;
  for (int k = 0; k < n_points; ++k) {
    const float p = points[k];
    for (int i = tid; i < r_in * W; i += THREADS) {
      d[i] = (signed char)((int)(fr[i] <= p) - (int)(ff[i] <= p));
    }
    __syncthreads();

    // Vertical sliding sums: col[y][x] = sum of d[y .. y+patch-1][x].
    for (int item = tid; item < W * vseg; item += THREADS) {
      const int x = item % W;
      const int ya = (item / W) * SEG;
      const int yb = min(ya + SEG, r_out);
      int run = 0;
      for (int dy = 0; dy < patch; ++dy) run += d[(ya + dy) * W + x];
      col[ya * wp + x] = run;
      for (int y = ya + 1; y < yb; ++y) {
        run += d[(y + patch - 1) * W + x] - d[(y - 1) * W + x];
        col[y * wp + x] = run;
      }
    }
    __syncthreads();

    // Horizontal sliding sums of col, |.| and the running max.  The next
    // threshold's d does not touch col or mx, and its vertical pass starts
    // only after the barrier above, so no third barrier is needed.
    for (int item = tid; item < r_out * hseg; item += THREADS) {
      const int y = item % r_out;
      const int xa = (item / r_out) * SEG;
      const int xb = min(xa + SEG, OW);
      const int* line = col + y * wp;
      int* best = mx + y * owp;
      int run = 0;
      for (int dx = 0; dx < patch; ++dx) run += line[xa + dx];
      best[xa] = max(best[xa], abs(run));
      for (int x = xa + 1; x < xb; ++x) {
        run += line[x + patch - 1] - line[x - 1];
        best[x] = max(best[x], abs(run));
      }
    }
  }
  __syncthreads();

  const float area = (float)patch * (float)patch;
  const size_t obase = (n * OH + y0) * OW;
  for (int i = tid; i < r_out * OW; i += THREADS) {
    const int y = i / OW;
    const int x = i % OW;
    out[obase + i] = __fdiv_rn((float)mx[y * owp + x], area);
  }
}

}  // namespace

// KS images of N field pairs: real, fake (N, H, W) f32 contiguous, points
// (n_points,) f32, out (N, H-patch+1, W-patch+1) f32.  Returns the launch's
// cudaGetLastError() code (0 on success), or cudaErrorInvalidValue without
// launching for sizes it does not take, or cudaErrorInvalidConfiguration when
// even a one-row band does not fit in shared memory.
extern "C" int windtpu_spatial_ks(const void* real, const void* fake,
                                  const void* points, void* out, int N, int H,
                                  int W, int patch, int n_points,
                                  void* stream) {
  if (N < 1 || patch < 1 || patch > H || patch > W || n_points < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int OH = H - patch + 1;
  const int OW = W - patch + 1;
  int bands = (TARGET_BLOCKS + N - 1) / N;
  if (bands > OH) bands = OH;
  int rows = (OH + bands - 1) / bands;
  while (rows > 1 && layout(W, OW, patch, rows).bytes > MAX_SMEM) {
    rows = (rows + 1) / 2;
  }
  const Layout l = layout(W, OW, patch, rows);
  if (l.bytes > MAX_SMEM) return (int)cudaErrorInvalidConfiguration;
  bands = (OH + rows - 1) / rows;
  if (bands > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      spatial_ks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)l.bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)N, (unsigned)bands);
  spatial_ks_kernel<<<grid, THREADS, l.bytes, (cudaStream_t)stream>>>(
      static_cast<const float*>(real), static_cast<const float*>(fake),
      static_cast<const float*>(points), static_cast<float*>(out), H, W, patch,
      n_points, rows, l.wp, l.owp);
  return (int)cudaGetLastError();
}
