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
// reproduces the TPU kernel's rounding points.  Step 0 does no product.
//
// Layouts (all contiguous): zx (B, T, H, W, 4F) in the I/O type; y (B, T, H,
// W, F), which also holds h_{t-1} for step t; c (B, H, W, F), scratch owned
// by the caller.  The caller loops over t.  Both routes take the recurrent
// kernel as the packed slab of ops/convlstm.py:pack_recurrent_kernel,
// (ceil(F/BJ), 9*Fp, 4*BJ) in the I/O type, with Fp = F rounded up to the
// route's stage depth (KC = 32 for bf16, BK = 16 for f32): block jb of BJ
// channels reads one contiguous (9*Fp x 4*BJ) operand, rows tap-major then
// channel (zero rows for channels >= F), columns [g][j] (zero columns for
// channels >= F).
//
// What bounds it.  At the generator's shape (B=16, T=24, 24x24, F=128, bf16)
// one step is a GEMM of M = B*H*W = 9216 pixels, N = 4F = 512 gate columns
// and K = 9F = 1152: 10.9 GFLOP, and a sequence (T-1 = 23 products) 250.0
// GFLOP against 284 MB of compulsory traffic (zx read once, y written once,
// rk once): 0.253 ms at 989 TFLOP/s bf16 versus 0.085 ms at 3.35 TB/s.  It
// is bound by operations, at 0.253 ms per sequence.
//
// What the design does about it (bf16, the serving and training type).
// The product runs on the tensor cores: mma.sync.m16n8k16 with bf16
// operands and f32 accumulators, fed by ldmatrix from shared memory.  A and
// B are staged as bf16 (no widening) in a ring of STAGES = 3 buffers filled
// by 16-byte cp.async copies, so the loads of stages k+1 and k+2 are in
// flight while stage k is multiplied.  One stage is one tap and KC = 32
// channels: the A tile is the im2col gather of h_{t-1} (y[:, t-1], 2.4 MB,
// L2-resident) at that tap, with cp.async's zero-fill for taps outside the
// image (SAME padding), for channels >= F and for pixels >= M; the B tile is
// KC contiguous rows of the packed slab.  Where F is not a multiple of 8 a
// 16-byte copy would cross a pixel, so the A tile is gathered element by
// element instead (same kernel, a template flag); B is always 16-byte
// aligned.  Because BJ is a multiple of 8, column g*BJ + j of an m16n8
// accumulator sits in the same thread as column j, so each thread holds the
// four gates of its (pixel, channel) and the gate math runs in the epilogue
// with the f32 __fmul_rn/__fadd_rn arithmetic of the f32 route.  Shared-
// memory rows are padded by 16 bytes, which makes the ldmatrix rows of a
// phase fall in distinct banks.  Where F % 8 == 0 the epilogue reads zx and
// c and writes c and y as bf16 pairs, all loads of an m16 tile first.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit: 1.17 to 1.29 ms per downscale sequence (194 to 211 TFLOP/s;
// cuDNN's 23 convs 0.72 to 0.78 ms) and 0.5 to 1.2 ms at the training
// shape (2, 24, 24, 24, 128), where the 24 launches
// of 20 to 50 us each run at the host's launch rate; the bounds are 0.253
// and 0.0316 ms.
//
// The tile follows the shape (ops/convlstm.py:choose_tile): the large tile,
// BM = 144 pixels x BJ = 32 channels (128 gate columns, 6 warps of 48 x 64,
// two blocks per SM at up to 168 registers, 3 * (144 * 40 + 32 * 136) * 2 =
// 60,672 B of dynamic shared memory), where it gives at least one
// block per SM (downscale: 64 x 4 = 256 blocks, one wave of the 264 that
// fit on 132 SMs; 128 pixels would give 288, a wave and a tail); otherwise
// the small tile, BM = 64 x BJ = 16 (4 warps of 32 x 32, 29,184 B;
// training, M = 1152: 18 x 8 = 144 blocks instead of 32).  The wrapper
// passes the tile's BM, BJ and KC, and the C entry refuses a tile it does
// not build.
//
// Why mma.sync and not wgmma.  wgmma (m64nNk16 from shared memory) is the
// only way to the full 989 TFLOP/s, but its 64-row granularity does not cut
// the 9216-pixel GEMM into one wave on 132 SMs with few enough registers: a
// wgmma form with one warpgroup per 64 x 128 tile (64-byte swizzle, a
// 4-slot ring) was right but no faster on the H100, since its 64-row tile
// re-reads the packed slab from L2 for each of 144 pixel tiles per step.
// mma.sync with ldmatrix takes a padded row-major tile of any height.
// Left for later: halo reuse across the nine taps (each h_{t-1} row is
// gathered nine times, from L2), wgmma with two consumer warpgroups and a
// tile schedule that fills the card, a persistent kernel that keeps the
// state in L2 across steps, and warp specialisation (a producer warp for
// the copies).
//
// The f32 route (the parity type: every train_main, whose ModelConfig
// computes in f32, the f32 downscale and the f32 remat passes).
//
// What bounds it.  It stays in full f32 on the CUDA cores: 1xTF32 on the
// tensor cores keeps about three decimal digits of each operand and breaks
// the 1e-4 parity with the plain version that the tests and the smoke hold
// (a 3xTF32 split, which would keep it, is left for later).  So it is bound
// by operations at the 67 TFLOP/s f32 peak: at train_main's shape (B=16,
// T=6, 8x8, F=128) one step is a GEMM of M = 1024, N = 512, K = 1152, 1.21
// GFLOP, 18 us at that peak, 0.090 ms for the 5 products of a sequence.
//
// What the design does about it.  Such a GEMM is too small to fill 132 SMs
// with large tiles (the first f32 kernel's 64 x 64-channel tile gave 32
// blocks at train_main's shape), so the tile and a split over the taps
// follow the shape (ops/convlstm.py:choose_tile_f32): BM = 64 pixels x BJ =
// 32 channels (128 gate columns, 128 threads) where that gives at least one
// block per SM (the downscale: 576), else BM = 32 x BJ = 32 (64 threads)
// split 3 (train_main 384 blocks, each of its two ranks 192, the
// perceptual train_main 432):
//   - split 3: a cluster of 3 blocks shares one output tile, and rank r
//     multiplies tap row dy = r - 1 (taps 3r .. 3r + 2, K = 3F of the 9F).
//     Ranks 1 and 2 leave their f32 partial sums in their own shared memory
//     (over the ring, which they no longer need); after cluster.sync() rank
//     0 reads them through distributed shared memory and adds them in the
//     fixed order rank 0 + rank 1 + rank 2, then runs the gate epilogue
//     alone.  No atomics: the result is bitwise repeatable;
//   - a 4 pixel x (4 gates x 4 channels) register tile per thread, so each k
//     step is 64 FFMAs against one 16-byte A load and four 16-byte B loads
//     from shared memory.  A thread's pixels are ty + i * (BM / 4): the four
//     rows a warp reads at once are consecutive and fall in distinct banks
//     (A rows are padded by 4 floats).
// Staging is a ring of STAGES_F32 = 3 buffers filled by cp.async, so the
// loads of the next two stages are in flight while one is multiplied.  One
// stage is one tap and BK = 16 channels: the A tile is the im2col gather of
// h_{t-1} at that tap, 16-byte copies of 4 channels where F % 4 == 0 (with
// cp.async's zero-fill for SAME padding, channels >= F and pixels >= M),
// else 4-byte copies, element by element (a template flag); the B tile is
// BK contiguous rows of the packed f32 slab, 16-byte copies.  The gate math
// is the same __fmul_rn/__fadd_rn cell() as the bf16 route's, with h and c
// stored in f32; where F % 4 == 0 the epilogue reads zx and c and writes c
// and y as float4.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit (cuDNN's T-1 recurrent convs in f32, TF32 off, in the same run):
// train_main 0.281 ms per sequence (cuDNN 0.327, the first f32 kernel
// 0.863), one of its ranks 0.192 (0.224), the perceptual train_main 1.271
// (3.187, was 4.056), the downscale shape 7.41 (8.87, was 12.03); 16 to 34
// TFLOP/s, 23 to 50% of the bound.  ptxas: 168 registers and no spills
// (143 for the small tile unsplit, 128 for the large tile where F % 4 !=
// 0), with __launch_bounds__ asking for 3 blocks of 128 threads or 6 of 64
// per SM.
// What holds it there is the FFMA stream itself (python3 -m
// windtpu_torch.ops.convlstm_variants): halving the FFMAs nearly halves
// the time, while cutting three quarters of the B loads saves 8 to 17%;
// about half the FFMAs read two registers of one parity (a register-bank
// conflict), 0.62 to 0.76 of them at 128 registers, where the kernel ran 5
// to 11% slower.  A cluster of 6 (tap rows x channel halves), BK 8 or 32,
// and 2 or 4 stages were no faster.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

// ---- Shared by both routes ----

// Keras hard_sigmoid clip(0.2 x + 0.5, 0, 1), or the logistic sigmoid.
// Explicit _rn operations keep the compiler from contracting into an FMA,
// so the rounding matches the plain version's separate multiply and add.
__device__ __forceinline__ float gate(float x, bool hard) {
  if (hard) {
    return fminf(fmaxf(__fadd_rn(__fmul_rn(0.2f, x), 0.5f), 0.0f), 1.0f);
  }
  return 1.0f / (1.0f + expf(-x));
}

// The cell update from the four pre-activations and c_{t-1}, in f32.
__device__ __forceinline__ void cell(float zi, float zf, float zc, float zo,
                                     float c_prev, bool hard, float& c_new,
                                     float& h_new) {
  c_new = __fadd_rn(__fmul_rn(gate(zf, hard), c_prev),
                    __fmul_rn(gate(zi, hard), tanhf(zc)));
  h_new = __fmul_rn(gate(zo, hard), tanhf(c_new));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte copy; src_bytes = 0 writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
// 4-byte copy; src_bytes = 0 writes 4 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}


// ---- The bf16 route: tensor cores ----

constexpr int KC = 32;      // depth per stage: one tap, KC channels
constexpr int STAGES = 3;   // cp.async ring
constexpr int PAD = 8;      // bf16 elements of padding per shared row

template <int BM_, int BJ_, int WM_, int WN_>
struct Tile {
  static constexpr int BM = BM_;             // pixels per block
  static constexpr int BJ = BJ_;             // channels per block
  static constexpr int BN = 4 * BJ_;         // gate columns per block
  static constexpr int WM = WM_;             // warps along the pixels
  static constexpr int THREADS = 32 * WM_ * WN_;
  static constexpr int MIN_BLOCKS = 512 / THREADS;  // blocks per SM
  static constexpr int WROWS = BM_ / WM_;    // pixels per warp
  static constexpr int MT = WROWS / 16;      // m16 tiles per warp
  static constexpr int JW = BJ_ / WN_;       // channels per warp
  static constexpr int JT = JW / 8;          // n8 tiles per gate and warp
  static constexpr int AS = KC + PAD;        // A row stride (elements)
  static constexpr int BS = BN + PAD;        // B row stride (elements)
  static constexpr int A_ELEMS = BM_ * AS;
  static constexpr int STAGE_ELEMS = A_ELEMS + KC * BS;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE_ELEMS * 2;
  static constexpr int A_ITERS = BM_ * (KC / 8) / THREADS;  // 16-B copies
  static constexpr int B_COPIES = KC * BN / 8;
  static constexpr int B_ITERS = (B_COPIES + THREADS - 1) / THREADS;
  static_assert(WROWS % 16 == 0 && JW % 8 == 0, "warp tile");
  static_assert(BM_ * (KC / 8) % THREADS == 0, "A copies per thread");
  static_assert((AS * 2) % 16 == 0 && ((AS * 2 / 16) & 1), "A row stride");
  static_assert((BS * 2) % 16 == 0 && ((BS * 2 / 16) & 1), "B row stride");
};
using LargeTile = Tile<144, 32, 3, 2>;   // 192 threads
using SmallTile = Tile<64, 16, 2, 2>;    // 128 threads

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, "
               "[%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
                 "r"(b[1]));
}

// VEC: F % 8 == 0, so the A gather is 16-byte copies of 8 channels.
template <class C, bool VEC>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
convlstm_step_tc(const __nv_bfloat16* __restrict__ zx,
                 const __nv_bfloat16* __restrict__ wpack,
                 __nv_bfloat16* __restrict__ y, __nv_bfloat16* __restrict__ c,
                 int B, int Tn, int H, int W, int F, int Fp, int t,
                 bool hard) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp % C::WM;
  const int wn = warp / C::WM;
  const int HW = H * W;
  const int M = B * HW;
  const int m0 = blockIdx.x * C::BM;
  const int j0 = blockIdx.y * C::BJ;
  const int chunks = Fp / KC;
  const int KT = t > 0 ? 9 * chunks : 0;
  const __nv_bfloat16* wblk = wpack + (size_t)blockIdx.y * 9 * Fp * C::BN;

  float acc[C::MT][4 * C::JT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int n = 0; n < 4 * C::JT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.0f;

  const size_t F4 = 4 * (size_t)F;

  if (KT > 0) {
    // This thread's A copies: row r = (tid + it*THREADS) / (KC/8), fixed
    // across stages, so its pixel is decoded once.
    int a_py[C::A_ITERS], a_px[C::A_ITERS];
    size_t a_base[C::A_ITERS];
#pragma unroll
    for (int it = 0; it < C::A_ITERS; ++it) {
      const int m = m0 + (tid + it * C::THREADS) / (KC / 8);
      const int mm = m < M ? m : 0;
      const int b = mm / HW;
      const int p = mm % HW;
      a_py[it] = m < M ? p / W : -100;   // -100: never inside the image
      a_px[it] = p % W;
      a_base[it] = ((size_t)b * Tn + (t - 1)) * HW;
    }

    auto load_stage = [&](int kt, int slot) {
      __nv_bfloat16* As = smem + slot * C::STAGE_ELEMS;
      __nv_bfloat16* Bs = As + C::A_ELEMS;
      const int tap = kt / chunks;
      const int c0 = (kt % chunks) * KC;
      const int dy = tap / 3 - 1;
      const int dx = tap % 3 - 1;
      const __nv_bfloat16* bsrc = wblk + (size_t)kt * KC * C::BN;
#pragma unroll
      for (int it = 0; it < C::B_ITERS; ++it) {
        const int i = tid + it * C::THREADS;
        if (C::B_COPIES % C::THREADS != 0 && i >= C::B_COPIES) break;
        const int r = i / (C::BN / 8);
        const int q = i % (C::BN / 8);
        cp_async16(smem_u32(Bs + r * C::BS + q * 8),
                   bsrc + (size_t)r * C::BN + q * 8, 16);
      }
      if constexpr (VEC) {
#pragma unroll
        for (int it = 0; it < C::A_ITERS; ++it) {
          const int i = tid + it * C::THREADS;
          const int r = i / (KC / 8);
          const int ch = c0 + (i % (KC / 8)) * 8;
          const int sy = a_py[it] + dy;
          const int sx = a_px[it] + dx;
          const bool in = ch < F && sy >= 0 && sy < H && sx >= 0 && sx < W;
          const __nv_bfloat16* src =
              in ? y + (a_base[it] + (size_t)sy * W + sx) * F + ch : y;
          cp_async16(smem_u32(As + r * C::AS + (i % (KC / 8)) * 8), src,
                     in ? 16 : 0);
        }
      } else {
        for (int i = tid; i < C::BM * KC; i += C::THREADS) {
          const int r = i / KC;
          const int ch = c0 + i % KC;
          const int m = m0 + r;
          __nv_bfloat16 v = __float2bfloat16_rn(0.0f);
          if (m < M && ch < F) {
            const int b = m / HW;
            const int p = m % HW;
            const int sy = p / W + dy;
            const int sx = p % W + dx;
            if (sy >= 0 && sy < H && sx >= 0 && sx < W) {
              v = y[(((size_t)b * Tn + (t - 1)) * HW + (size_t)sy * W + sx) *
                        F + ch];
            }
          }
          As[r * C::AS + i % KC] = v;
        }
      }
    };

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < KT) load_stage(s, s);
      cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
      // Stage kt has landed; every thread is done with stage kt - 1, whose
      // slot the prefetch below refills.
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      if (kt + STAGES - 1 < KT) {
        load_stage(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
      }
      cp_async_commit();
      const __nv_bfloat16* As = smem + (kt % STAGES) * C::STAGE_ELEMS;
      const __nv_bfloat16* Bs = As + C::A_ELEMS;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        uint32_t af[C::MT][4];
#pragma unroll
        for (int mi = 0; mi < C::MT; ++mi) {
          const int row = wm * C::WROWS + mi * 16 + (lane & 15);
          ldmatrix_x4(af[mi],
                      smem_u32(As + row * C::AS + kk + (lane >> 4) * 8));
        }
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const __nv_bfloat16* brow =
              Bs + (kk + (lane & 15)) * C::BS + g * C::BJ + wn * C::JW;
          uint32_t bf[C::JT][2];
          if constexpr (C::JT % 2 == 0) {
            // Two n8 tiles per ldmatrix: lanes 16-31 address the second.
#pragma unroll
            for (int jt = 0; jt < C::JT; jt += 2) {
              uint32_t b4[4];
              ldmatrix_x4_trans(b4, smem_u32(brow + jt * 8 + (lane >> 4) * 8));
              bf[jt][0] = b4[0];
              bf[jt][1] = b4[1];
              bf[jt + 1][0] = b4[2];
              bf[jt + 1][1] = b4[3];
            }
          } else {
#pragma unroll
            for (int jt = 0; jt < C::JT; ++jt) {
              ldmatrix_x2_trans(bf[jt], smem_u32(brow + jt * 8));
            }
          }
#pragma unroll
          for (int jt = 0; jt < C::JT; ++jt) {
#pragma unroll
            for (int mi = 0; mi < C::MT; ++mi) {
              mma_bf16(acc[mi][g * C::JT + jt], af[mi], bf[jt]);
            }
          }
        }
      }
    }
    cp_async_wait<0>();
  }

  // Epilogue: accumulator element (half, e) of n8 tile (g, jt) is pixel row
  // lane/4 + 8*half and channel 2*(lane%4) + e of that tile, the same
  // channel for the four gates.  With F % 8 == 0 the channel pair (e = 0, 1)
  // is read and written as one bf16x2, and each m16 tile's loads are all
  // issued before its gate math.
#pragma unroll
  for (int mi = 0; mi < C::MT; ++mi) {
    size_t step_row[2], c_row[2];
    bool row_ok[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * C::WROWS + mi * 16 + (lane >> 2) + 8 * half;
      row_ok[half] = m < M;
      const int mm = row_ok[half] ? m : 0;
      const int b = mm / HW;
      step_row[half] = ((size_t)b * Tn + t) * HW + (mm - b * HW);
      c_row[half] = (size_t)mm;
    }
    if constexpr (VEC) {
      const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.0f, 0.0f);
      __nv_bfloat162 zv[2][C::JT][4], cv[2][C::JT];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int jt = 0; jt < C::JT; ++jt) {
          const int j = j0 + wn * C::JW + jt * 8 + 2 * (lane & 3);
          const bool in = row_ok[half] && j < F;
          const __nv_bfloat16* z = zx + step_row[half] * F4 + j;
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            zv[half][jt][g] =
                in ? *reinterpret_cast<const __nv_bfloat162*>(z + g * F)
                   : zero2;
          }
          cv[half][jt] =
              in && t > 0 ? *reinterpret_cast<const __nv_bfloat162*>(
                                c + c_row[half] * F + j)
                          : zero2;
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int jt = 0; jt < C::JT; ++jt) {
          const int j = j0 + wn * C::JW + jt * 8 + 2 * (lane & 3);
          if (!row_ok[half] || j >= F) continue;
          float cn[2], hn[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int q = 2 * half + e;
            float zg[4];
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              zg[g] = (e ? __high2float(zv[half][jt][g])
                         : __low2float(zv[half][jt][g])) +
                      acc[mi][g * C::JT + jt][q];
            }
            const float c_prev = e ? __high2float(cv[half][jt])
                                   : __low2float(cv[half][jt]);
            cell(zg[0], zg[1], zg[2], zg[3], c_prev, hard, cn[e], hn[e]);
          }
          *reinterpret_cast<__nv_bfloat162*>(c + c_row[half] * F + j) =
              __floats2bfloat162_rn(cn[0], cn[1]);
          *reinterpret_cast<__nv_bfloat162*>(y + step_row[half] * F + j) =
              __floats2bfloat162_rn(hn[0], hn[1]);
        }
      }
    } else {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (!row_ok[half]) continue;
#pragma unroll
        for (int jt = 0; jt < C::JT; ++jt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = j0 + wn * C::JW + jt * 8 + 2 * (lane & 3) + e;
            if (j >= F) continue;
            const int q = 2 * half + e;
            const __nv_bfloat16* z = zx + step_row[half] * F4 + j;
            const float c_prev =
                t > 0 ? __bfloat162float(c[c_row[half] * F + j]) : 0.0f;
            float cn, hn;
            cell(__bfloat162float(z[0]) + acc[mi][0 * C::JT + jt][q],
                 __bfloat162float(z[F]) + acc[mi][1 * C::JT + jt][q],
                 __bfloat162float(z[2 * (size_t)F]) +
                     acc[mi][2 * C::JT + jt][q],
                 __bfloat162float(z[3 * (size_t)F]) +
                     acc[mi][3 * C::JT + jt][q],
                 c_prev, hard, cn, hn);
            c[c_row[half] * F + j] = __float2bfloat16_rn(cn);
            y[step_row[half] * F + j] = __float2bfloat16_rn(hn);
          }
        }
      }
    }
  }
}

// ---- The f32 route: CUDA cores (the parity type) ----

constexpr int BK = 16;          // depth per stage: one tap, BK channels
constexpr int STAGES_F32 = 3;   // cp.async ring
constexpr int TM = 4;           // pixels per thread
constexpr int TJ = 4;           // channels per thread (per gate)
constexpr int A_PAD = 4;        // floats of padding per shared A row

template <int BM_, int BJ_>
struct F32Tile {
  static constexpr int BM = BM_;              // pixels per output tile
  static constexpr int BJ = BJ_;              // channels per output tile
  static constexpr int BN = 4 * BJ_;          // gate columns per tile
  static constexpr int TX = BJ_ / TJ;         // channel groups
  static constexpr int TY = BM_ / TM;         // pixel groups
  static constexpr int THREADS = TX * TY;
  static constexpr int MIN_BLOCKS = 384 / THREADS;  // at most 170 registers
  static constexpr int AS = BK + A_PAD;       // A row stride (floats)
  static constexpr int A_ELEMS = BM_ * AS;
  static constexpr int STAGE_ELEMS = A_ELEMS + BK * BN;
  static constexpr int RING_ELEMS = STAGES_F32 * STAGE_ELEMS;
  static constexpr int PARTIAL_ELEMS = BM_ * BN;   // one rank's partial sums
  static constexpr size_t SMEM =
      4 * (size_t)(RING_ELEMS > PARTIAL_ELEMS ? RING_ELEMS : PARTIAL_ELEMS);
  static constexpr int A_ITERS = BM_ * (BK / 4) / THREADS;  // 16-B copies
  static constexpr int B_ITERS = BK * BN / 4 / THREADS;
  static_assert(TX == 8, "a quarter warp reads one 128-byte B row segment");
  static_assert(THREADS % 32 == 0 && TY % 4 == 0, "warps of four pixel rows");
  static_assert(BM_ * (BK / 4) % THREADS == 0, "A copies per thread");
  static_assert(BK * BN / 4 % THREADS == 0, "B copies per thread");
};
using F32Large = F32Tile<64, 32>;   // 128 threads
using F32Small = F32Tile<32, 32>;   // 64 threads

__device__ __forceinline__ float lane4(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// SPLIT: blocks per cluster that share one output tile, 1 or 3 (rank r
// then multiplies tap row r, taps 3r .. 3r + 2).  VEC: F % 4 == 0, so the A
// gather is 16-byte copies of 4 channels and the epilogue moves float4s.
template <class C, int SPLIT, bool VEC>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
convlstm_step_f32(const float* __restrict__ zx,
                  const float* __restrict__ wpack, float* __restrict__ y,
                  float* __restrict__ c, int B, int Tn, int H, int W, int F,
                  int Fp, int t, bool hard) {
  static_assert(SPLIT == 1 || SPLIT == 3, "taps split by whole rows");
  constexpr int TAPS = 9 / SPLIT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int tid = threadIdx.x;
  const int tx = tid % C::TX;
  const int ty = tid / C::TX;
  int rank = 0;
  if constexpr (SPLIT > 1) {
    rank = (int)cooperative_groups::this_cluster().block_rank();
  }
  const int HW = H * W;
  const int M = B * HW;
  const int m0 = (blockIdx.x / SPLIT) * C::BM;
  const int j0 = blockIdx.y * C::BJ;
  const int chunks = Fp / BK;
  const int KT = t > 0 ? TAPS * chunks : 0;
  const int tap0 = rank * TAPS;
  // This rank's rows of block blockIdx.y's slab: taps tap0 .. tap0+TAPS-1,
  // stage kt at row tap0 * Fp + kt * BK.
  const float* wblk =
      wpack + ((size_t)blockIdx.y * 9 + tap0) * (size_t)Fp * C::BN;

  float acc[TM][4][TJ];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int q = 0; q < TJ; ++q) acc[i][g][q] = 0.0f;

  if (KT > 0) {
    // This thread's 16-byte A copies: row r = (tid + it*THREADS) / (BK/4),
    // fixed across stages, so its pixel is decoded once.
    int a_py[C::A_ITERS], a_px[C::A_ITERS];
    size_t a_base[C::A_ITERS];
#pragma unroll
    for (int it = 0; it < C::A_ITERS; ++it) {
      const int m = m0 + (tid + it * C::THREADS) / (BK / 4);
      const int mm = m < M ? m : 0;
      const int b = mm / HW;
      const int p = mm % HW;
      a_py[it] = m < M ? p / W : -100;   // -100: never inside the image
      a_px[it] = p % W;
      a_base[it] = ((size_t)b * Tn + (t - 1)) * HW;
    }

    auto load_stage = [&](int kt, int slot) {
      float* As = smem + slot * C::STAGE_ELEMS;
      float* Bs = As + C::A_ELEMS;
      const int tap = tap0 + kt / chunks;
      const int c0 = (kt % chunks) * BK;
      const int dy = tap / 3 - 1;
      const int dx = tap % 3 - 1;
      const float* bsrc = wblk + (size_t)kt * BK * C::BN;
#pragma unroll
      for (int it = 0; it < C::B_ITERS; ++it) {
        const int i = tid + it * C::THREADS;
        cp_async16(smem_u32(Bs + i * 4), bsrc + (size_t)i * 4, 16);
      }
      if constexpr (VEC) {
#pragma unroll
        for (int it = 0; it < C::A_ITERS; ++it) {
          const int i = tid + it * C::THREADS;
          const int r = i / (BK / 4);
          const int ch = c0 + (i % (BK / 4)) * 4;
          const int sy = a_py[it] + dy;
          const int sx = a_px[it] + dx;
          const bool in = ch < F && sy >= 0 && sy < H && sx >= 0 && sx < W;
          const float* src =
              in ? y + (a_base[it] + (size_t)sy * W + sx) * F + ch : y;
          cp_async16(smem_u32(As + r * C::AS + (i % (BK / 4)) * 4), src,
                     in ? 16 : 0);
        }
      } else {
        for (int i = tid; i < C::BM * BK; i += C::THREADS) {
          const int r = i / BK;
          const int ch = c0 + i % BK;
          const int m = m0 + r;
          const float* src = y;
          bool in = false;
          if (m < M && ch < F) {
            const int b = m / HW;
            const int p = m % HW;
            const int sy = p / W + dy;
            const int sx = p % W + dx;
            in = sy >= 0 && sy < H && sx >= 0 && sx < W;
            if (in) {
              src = y + (((size_t)b * Tn + (t - 1)) * HW + (size_t)sy * W +
                         sx) * F + ch;
            }
          }
          cp_async4(smem_u32(As + r * C::AS + i % BK), src, in ? 4 : 0);
        }
      }
    };

#pragma unroll
    for (int s = 0; s < STAGES_F32 - 1; ++s) {
      if (s < KT) load_stage(s, s);
      cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
      // Stage kt has landed; every thread is done with stage kt - 1, whose
      // slot the prefetch below refills.
      cp_async_wait<STAGES_F32 - 2>();
      __syncthreads();
      if (kt + STAGES_F32 - 1 < KT) {
        load_stage(kt + STAGES_F32 - 1, (kt + STAGES_F32 - 1) % STAGES_F32);
      }
      cp_async_commit();
      const float* As = smem + (kt % STAGES_F32) * C::STAGE_ELEMS;
      const float* Bs = As + C::A_ELEMS;
#pragma unroll
      for (int kq = 0; kq < BK; kq += 4) {
        float4 a4[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          a4[i] = *reinterpret_cast<const float4*>(
              As + (ty + i * C::TY) * C::AS + kq);
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          float4 bv[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            bv[g] = *reinterpret_cast<const float4*>(
                Bs + (kq + s) * C::BN + g * C::BJ + tx * TJ);
          }
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float a = lane4(a4[i], s);
#pragma unroll
            for (int g = 0; g < 4; ++g)
#pragma unroll
              for (int q = 0; q < TJ; ++q)
                acc[i][g][q] = fmaf(a, lane4(bv[g], q), acc[i][g][q]);
          }
        }
      }
    }
    cp_async_wait<0>();
  }

  if constexpr (SPLIT > 1) {
    // Ranks 1.. leave their partial sums over the ring (every thread is done
    // with it after this barrier), as float4 e of thread tid at e*THREADS +
    // tid; rank 0 adds them in rank order and alone runs the epilogue.
    auto cluster = cooperative_groups::this_cluster();
    float4* part = reinterpret_cast<float4*>(smem);
    __syncthreads();
    if (rank != 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          part[(i * 4 + g) * C::THREADS + tid] = make_float4(
              acc[i][g][0], acc[i][g][1], acc[i][g][2], acc[i][g][3]);
    }
    cluster.sync();
    if (rank == 0) {
#pragma unroll
      for (int r = 1; r < SPLIT; ++r) {
        const float4* remote = cluster.map_shared_rank(part, r);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const float4 v = remote[(i * 4 + g) * C::THREADS + tid];
#pragma unroll
            for (int q = 0; q < TJ; ++q) acc[i][g][q] += lane4(v, q);
          }
      }
    }
    // Ranks 1.. keep their shared memory until rank 0 has read it.
    cluster.sync();
    if (rank != 0) return;
  }

  // Epilogue: the four gates of each (pixel, channel) are in this thread.
  const size_t F4 = 4 * (size_t)F;
  const int j = j0 + tx * TJ;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * C::TY;
    if (m >= M) continue;
    const int b = m / HW;
    const size_t step_row = ((size_t)b * Tn + t) * HW + (m - b * HW);
    const size_t c_row = (size_t)m;
    const float* z = zx + step_row * F4 + j;
    if constexpr (VEC) {
      if (j >= F) continue;   // F % 4 == 0: all four channels or none
      float4 zg[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        zg[g] = *reinterpret_cast<const float4*>(z + g * (size_t)F);
      }
      const float4 cp =
          t > 0 ? *reinterpret_cast<const float4*>(c + c_row * F + j)
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float cn[TJ], hn[TJ];
#pragma unroll
      for (int q = 0; q < TJ; ++q) {
        cell(lane4(zg[0], q) + acc[i][0][q], lane4(zg[1], q) + acc[i][1][q],
             lane4(zg[2], q) + acc[i][2][q], lane4(zg[3], q) + acc[i][3][q],
             lane4(cp, q), hard, cn[q], hn[q]);
      }
      *reinterpret_cast<float4*>(c + c_row * F + j) =
          make_float4(cn[0], cn[1], cn[2], cn[3]);
      *reinterpret_cast<float4*>(y + step_row * F + j) =
          make_float4(hn[0], hn[1], hn[2], hn[3]);
    } else {
#pragma unroll
      for (int q = 0; q < TJ; ++q) {
        if (j + q >= F) continue;
        const float c_prev = t > 0 ? c[c_row * F + j + q] : 0.0f;
        cell(z[q] + acc[i][0][q], z[F + q] + acc[i][1][q],
             z[2 * (size_t)F + q] + acc[i][2][q],
             z[3 * (size_t)F + q] + acc[i][3][q], c_prev, hard,
             c[c_row * F + j + q], y[step_row * F + j + q]);
      }
    }
  }
}

// cudaFuncSetAttribute once per kernel and device (done is the launcher's
// own flag array): a host call that each of a sequence's launches would
// otherwise pay.
cudaError_t opt_in(bool (&done)[64], const void* kernel, size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <class C, bool VEC>
int launch_tc(const void* zx, const void* wpack, void* y, void* c, int B,
              int Tn, int H, int W, int F, int t, int hard_sig,
              void* stream) {
  auto kernel = convlstm_step_tc<C, VEC>;
  static bool done[64] = {};
  cudaError_t err =
      opt_in(done, reinterpret_cast<const void*>(kernel), C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int M = B * H * W;
  const int Fp = (F + KC - 1) / KC * KC;
  const dim3 grid((unsigned)((M + C::BM - 1) / C::BM),
                  (unsigned)((F + C::BJ - 1) / C::BJ));
  kernel<<<grid, C::THREADS, C::SMEM, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(zx),
      static_cast<const __nv_bfloat16*>(wpack),
      static_cast<__nv_bfloat16*>(y), static_cast<__nv_bfloat16*>(c), B, Tn,
      H, W, F, Fp, t, hard_sig != 0);
  return (int)cudaGetLastError();
}

template <class C>
int launch_bf16(const void* zx, const void* wpack, void* y, void* c, int B,
                int Tn, int H, int W, int F, int t, int hard_sig,
                void* stream) {
  if (F % 8 == 0) {
    return launch_tc<C, true>(zx, wpack, y, c, B, Tn, H, W, F, t, hard_sig,
                              stream);
  }
  return launch_tc<C, false>(zx, wpack, y, c, B, Tn, H, W, F, t, hard_sig,
                             stream);
}

// One launch of the f32 route: ceil(M/BM) clusters of SPLIT blocks along x,
// ceil(F/BJ) channel tiles along y.
template <class C, int SPLIT, bool VEC>
int launch_cuda_cores(const void* zx, const void* wpack, void* y, void* c,
                      int B, int Tn, int H, int W, int F, int t, int hard_sig,
                      void* stream) {
  auto kernel = convlstm_step_f32<C, SPLIT, VEC>;
  static bool done[64] = {};
  cudaError_t err =
      opt_in(done, reinterpret_cast<const void*>(kernel), C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int M = B * H * W;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = SPLIT;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)((M + C::BM - 1) / C::BM * SPLIT),
                        (unsigned)((F + C::BJ - 1) / C::BJ));
  config.blockDim = dim3(C::THREADS);
  config.dynamicSmemBytes = C::SMEM;
  config.stream = (cudaStream_t)stream;
  config.attrs = cluster;
  config.numAttrs = SPLIT > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&config, kernel, static_cast<const float*>(zx),
                           static_cast<const float*>(wpack),
                           static_cast<float*>(y), static_cast<float*>(c), B,
                           Tn, H, W, F, (F + BK - 1) / BK * BK, t,
                           hard_sig != 0);
  const cudaError_t last = cudaGetLastError();   // and clears err
  return (int)(err != cudaSuccess ? err : last);
}

template <class C>
int launch_f32(const void* zx, const void* wpack, void* y, void* c, int B,
               int Tn, int H, int W, int F, int t, int hard_sig, int split,
               void* stream) {
  const bool vec = F % 4 == 0;
  if (split == 1) {
    return vec ? launch_cuda_cores<C, 1, true>(zx, wpack, y, c, B, Tn, H, W,
                                               F, t, hard_sig, stream)
               : launch_cuda_cores<C, 1, false>(zx, wpack, y, c, B, Tn, H,
                                                W, F, t, hard_sig, stream);
  }
  if (split == 3) {
    return vec ? launch_cuda_cores<C, 3, true>(zx, wpack, y, c, B, Tn, H, W,
                                               F, t, hard_sig, stream)
               : launch_cuda_cores<C, 3, false>(zx, wpack, y, c, B, Tn, H,
                                                W, F, t, hard_sig, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One recurrence step t.  dtype: 0 = float32 (CUDA cores), 1 = bfloat16
// (tensor cores); rk is the route's packed slab.  bm, bj, kc and split name
// the tile the caller chose and packed the slab for (ops/convlstm.py):
// bf16 (TILES, K_CHUNK) BM 144 x BJ 32 or BM 64 x BJ 16, KC 32, split 1;
// f32 (F32_TILES, F32_CHUNK) BM 64 or 32 x BJ 32, KC 16, split 1 or 3
// blocks per cluster.  Returns the launch's error code (0 on success); an
// unknown dtype, a tile or split this file does not build or another KC, or
// more than 2^31 - 1 pixels, returns cudaErrorInvalidValue without
// launching.
extern "C" int windtpu_convlstm_step(int dtype, const void* zx, const void* rk,
                                     void* y, void* c, int B, int T, int H,
                                     int W, int F, int t, int hard_sig,
                                     int bm, int bj, int kc, int split,
                                     void* stream) {
  if ((long long)B * H * W > 2147483647LL) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && kc == BK) {
    if (bm == F32Large::BM && bj == F32Large::BJ) {
      return launch_f32<F32Large>(zx, rk, y, c, B, T, H, W, F, t, hard_sig,
                                  split, stream);
    }
    if (bm == F32Small::BM && bj == F32Small::BJ) {
      return launch_f32<F32Small>(zx, rk, y, c, B, T, H, W, F, t, hard_sig,
                                  split, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != 1 || kc != KC || split != 1) return (int)cudaErrorInvalidValue;
  if (bm == LargeTile::BM && bj == LargeTile::BJ) {
    return launch_bf16<LargeTile>(zx, rk, y, c, B, T, H, W, F, t, hard_sig,
                                  stream);
  }
  if (bm == SmallTile::BM && bj == SmallTile::BJ) {
    return launch_bf16<SmallTile>(zx, rk, y, c, B, T, H, W, F, t, hard_sig,
                                  stream);
  }
  return (int)cudaErrorInvalidValue;
}
