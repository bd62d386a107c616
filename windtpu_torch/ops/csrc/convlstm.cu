// ConvLSTM recurrence, one time step per launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel windtpu/ops/pallas_convlstm.py:convlstm_seq_fused
// (body _convlstm_kernel, launcher _forward at its pallas_call).  It computes
// what that kernel computes, for every step t of the sequence:
//
//   z   = zx[:, t] + conv3x3_SAME(h_{t-1}, rk)        (f32 accumulation)
//   i, f, o = hard_sigmoid (or sigmoid) of their gate columns, g = tanh
//   c_t = f * c_{t-1} + i * g,   h_t = o * tanh(c_t)  (f32 gate math)
//
// with h_{-1} = c_{-1} = 0 and the gate order (i, f, c, o) along the 4F
// axis.  h_t and c_t are stored in the I/O type between steps, which
// reproduces the TPU kernel's rounding points.
//
// Layouts (all contiguous): zx (B, T, H, W, 4F); rk (3, 3, F, 4F) in the I/O
// type; y (B, T, H, W, F), which also holds h_{t-1} for step t; c (B, H, W,
// F), scratch owned by the caller.  The caller loops over t.
//
// What bounds it.  At the generator's shape (B=16, T=24, 24x24, F=128, bf16)
// one sequence is 2*B*(T-1)*H*W*9F*4F = 250.0 GFLOP (h_{-1} = 0, so step 0
// has no product) against 284 MB of compulsory traffic (zx read once, y
// written once, rk once): 0.253 ms at 989 TFLOP/s bf16 versus 0.085 ms at
// 3.35 TB/s.  It is compute-bound, with a bound of 0.253 ms per sequence.
//
// What the design does about it.  The TPU kernel keeps (h, c) in VMEM across
// a sequential grid; on the card blocks run in no order and h + c at the
// generator's shape is far more than one SM's shared memory, so each step is
// its own launch and the state stays in device memory (it is L2-resident:
// h_{t-1} is 2.4 MB).  Each step is an implicit GEMM with M = B*H*W pixels,
// depth K = 9F (tap-major) and N = 4F gate columns.  A block owns a tile of
// BM pixels x BJ channels j and computes the four gate columns {j, F+j, 2F+j,
// 3F+j} of those channels, so the gate math runs in the epilogue without a
// second pass.  SAME padding is done by masking out-of-image taps to zero.
// The product runs on the CUDA cores in f32 (one code path for the bf16
// serving type and the f32 parity type), tiled through shared memory with a
// 4x(4x4) register tile per thread.  That is far below the tensor-core bound
// above; wgmma, TMA and a persistent design are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BM = 64;        // pixels per block
constexpr int BJ = 64;        // channels per block (x4 gates = 256 columns)
constexpr int BK = 16;        // depth per shared-memory stage
constexpr int TM = 4;         // pixels per thread
constexpr int TJ = 4;         // channels per thread (per gate)
constexpr int THREADS = (BM / TM) * (BJ / TJ);  // 256

static_assert(THREADS == 256, "tile shape and thread count disagree");
static_assert(BM * BK == 4 * THREADS, "A tile: four loads per thread");
static_assert(4 * BJ == THREADS, "B tile: one column per thread");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Keras hard_sigmoid clip(0.2 x + 0.5, 0, 1), or the logistic sigmoid.
// Explicit _rn operations keep the compiler from contracting into an FMA,
// so the rounding matches the plain version's separate multiply and add.
__device__ __forceinline__ float gate(float x, bool hard) {
  if (hard) {
    return fminf(fmaxf(__fadd_rn(__fmul_rn(0.2f, x), 0.5f), 0.0f), 1.0f);
  }
  return 1.0f / (1.0f + expf(-x));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
convlstm_step_kernel(const T* __restrict__ zx, const T* __restrict__ rk,
                     T* __restrict__ y, T* __restrict__ c, int B, int Tn,
                     int H, int W, int F, int t, bool hard) {
  __shared__ __align__(16) float As[BM][BK];       // h_{t-1}, pixel-major
  __shared__ __align__(16) float Bs[BK][4 * BJ];   // rk, gate-major columns

  const int tid = threadIdx.x;
  const int HW = H * W;
  const long long M = (long long)B * HW;
  const long long m0 = (long long)blockIdx.x * BM;
  const int j0 = blockIdx.y * BJ;
  const size_t F4 = 4 * (size_t)F;
  const int tx = tid % (BJ / TJ);  // channel group
  const int ty = tid / (BJ / TJ);  // pixel group

  float acc[TM][4][TJ];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int q = 0; q < TJ; ++q) acc[i][g][q] = 0.0f;

  if (t > 0) {
    // A loads: rows a_m + 16 r of the tile, depth column a_k.
    const int a_k = tid % BK;
    const int a_m = tid / BK;
    int a_b[4], a_y[4], a_x[4];
    bool a_ok[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long m = m0 + a_m + 16 * r;
      a_ok[r] = m < M;
      const long long mm = a_ok[r] ? m : 0;
      a_b[r] = (int)(mm / HW);
      const int p = (int)(mm % HW);
      a_y[r] = p / W;
      a_x[r] = p % W;
    }
    // B loads: column n = tid (gate g, channel jj), rows 0..BK-1.
    const int b_g = tid / BJ;
    const int b_j = j0 + tid % BJ;
    const bool b_ok = b_j < F;

    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3 - 1;
      const int dx = tap % 3 - 1;
      for (int k0 = 0; k0 < F; k0 += BK) {
        const int k = k0 + a_k;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int sy = a_y[r] + dy;
          const int sx = a_x[r] + dx;
          float v = 0.0f;
          if (a_ok[r] && k < F && sy >= 0 && sy < H && sx >= 0 && sx < W) {
            const size_t row =
                ((size_t)a_b[r] * Tn + (t - 1)) * HW + (size_t)sy * W + sx;
            v = to_f32(y[row * F + k]);
          }
          As[a_m + 16 * r][a_k] = v;
        }
#pragma unroll
        for (int r = 0; r < BK; ++r) {
          const int kk = k0 + r;
          float v = 0.0f;
          if (b_ok && kk < F) {
            v = to_f32(rk[((size_t)tap * F + kk) * F4 + (size_t)b_g * F + b_j]);
          }
          Bs[r][tid] = v;
        }
        __syncthreads();

#pragma unroll
        for (int kq = 0; kq < BK; kq += 4) {
          float4 a4[TM];
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            a4[i] = *reinterpret_cast<const float4*>(&As[ty * TM + i][kq]);
          }
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            float bv[4][TJ];
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              const float4 b4 = *reinterpret_cast<const float4*>(
                  &Bs[kq + s][g * BJ + tx * TJ]);
              bv[g][0] = b4.x;
              bv[g][1] = b4.y;
              bv[g][2] = b4.z;
              bv[g][3] = b4.w;
            }
#pragma unroll
            for (int i = 0; i < TM; ++i) {
              const float a = s == 0 ? a4[i].x
                            : s == 1 ? a4[i].y
                            : s == 2 ? a4[i].z
                                     : a4[i].w;
#pragma unroll
              for (int g = 0; g < 4; ++g)
#pragma unroll
                for (int q = 0; q < TJ; ++q)
                  acc[i][g][q] = fmaf(a, bv[g][q], acc[i][g][q]);
            }
          }
        }
        __syncthreads();
      }
    }
  }

  // Epilogue: the four gates of each (pixel, channel) are in this thread.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty * TM + i;
    if (m >= M) continue;
    const int b = (int)(m / HW);
    const int p = (int)(m % HW);
    const size_t step_row = ((size_t)b * Tn + t) * HW + p;
    const size_t c_row = (size_t)b * HW + p;
#pragma unroll
    for (int q = 0; q < TJ; ++q) {
      const int j = j0 + tx * TJ + q;
      if (j >= F) continue;
      const T* z = zx + step_row * F4 + j;
      const float zi = to_f32(z[0]) + acc[i][0][q];
      const float zf = to_f32(z[F]) + acc[i][1][q];
      const float zc = to_f32(z[2 * (size_t)F]) + acc[i][2][q];
      const float zo = to_f32(z[3 * (size_t)F]) + acc[i][3][q];
      const float c_prev = t > 0 ? to_f32(c[c_row * F + j]) : 0.0f;
      const float c_new = __fadd_rn(__fmul_rn(gate(zf, hard), c_prev),
                                    __fmul_rn(gate(zi, hard), tanhf(zc)));
      const float h_new = __fmul_rn(gate(zo, hard), tanhf(c_new));
      c[c_row * F + j] = from_f32<T>(c_new);
      y[step_row * F + j] = from_f32<T>(h_new);
    }
  }
}

template <typename T>
int launch(const void* zx, const void* rk, void* y, void* c, int B, int Tn,
           int H, int W, int F, int t, int hard_sig, void* stream) {
  const long long M = (long long)B * H * W;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((F + BJ - 1) / BJ));
  convlstm_step_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(zx), static_cast<const T*>(rk),
      static_cast<T*>(y), static_cast<T*>(c), B, Tn, H, W, F, t,
      hard_sig != 0);
  return (int)cudaGetLastError();
}

}  // namespace

// One recurrence step t.  dtype: 0 = float32, 1 = bfloat16.  Returns the
// cudaGetLastError() code of the launch (0 on success); an unknown dtype
// returns cudaErrorInvalidValue without launching.
extern "C" int windtpu_convlstm_step(int dtype, const void* zx, const void* rk,
                                     void* y, void* c, int B, int T, int H,
                                     int W, int F, int t, int hard_sig,
                                     void* stream) {
  if (dtype == 0) {
    return launch<float>(zx, rk, y, c, B, T, H, W, F, t, hard_sig, stream);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(zx, rk, y, c, B, T, H, W, F, t, hard_sig,
                                 stream);
  }
  return (int)cudaErrorInvalidValue;
}
