// ConvLSTM recurrence for Hopper (sm_90a): one launch per time step, all T
// launches of a sequence enqueued by one host call.
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
// W, F); c (B, H, W, F), scratch owned by the caller.  The f32 route reads
// h_{t-1} from y[:, t-1]; the bf16 route from hbuf (2, B*H*W, Fp), a
// scratch copy of h that step t writes into half t % 2 (channels >= F stay
// zero), owned by the caller.  The TPU kernel runs the whole sequence in
// one pallas_call; here windtpu_convlstm_seq enqueues the T launches, step
// t + 1 with programmatic dependent launch: it waits in griddepcontrol.wait
// before it touches what step t wrote.  Both routes take the recurrent
// kernel as a packed slab (ops/convlstm.py:pack_recurrent_kernel): block
// jb of BJ channels reads the 9 taps x Fp channels (rows, Fp = F rounded up
// to the route's stage depth, zero rows for channels >= F) by 4*BJ gate
// columns [g][j] (zero columns for channels >= F) of its own channels.  The
// f32 route stores it (ceil(F/BJ), 9*Fp, 4*BJ), column-contiguous; the
// bf16 route (ceil(F/BJ), 9, 4*BJ, Fp), channel-contiguous ("K-major"), the
// layout wgmma reads.
//
// What bounds it.  At the generator's shape (B=16, T=24, 24x24, F=128, bf16)
// one step is a GEMM of M = B*H*W = 9216 pixels, N = 4F = 512 gate columns
// and K = 9F = 1152: 10.9 GFLOP, and a sequence (T-1 = 23 products) 250.0
// GFLOP against 284 MB of compulsory traffic (zx read once, y written once,
// rk once): 0.253 ms at 989 TFLOP/s bf16 versus 0.085 ms at 3.35 TB/s.  It
// is bound by operations, at 0.253 ms per sequence.  Inside a step what
// held the earlier bf16 kernel (PR 3: mma.sync.m16n8k16 from an im2col
// gather, one tap per cp.async stage) was the traffic from L2: each block of
// 144 pixels x 128 gate columns gathered its A operand nine times (332 KB)
// and read its 295 KB slab block, about 160 MB per step; it ran at 21% of
// the bound, 1.6x to 3x slower than cuDNN's convs.
//
// What the design does about it (bf16, the serving and training type).
//   - wgmma.mma_async m64nNk16 (bf16 in, f32 accumulators), A from
//     registers, B (the slab) from shared memory in the 128-byte-swizzled
//     K-major layout TMA writes.  A consumer warpgroup owns 64 pixels x
//     BN = 4*BJ gate columns of a tile.  wgmma's accumulator gives each
//     thread the same column pairs of each 8-column group as mma.sync's
//     m16n8, so with BJ a multiple of 8 the four gates of a (pixel,
//     channel) sit in one thread and the f32 gate epilogue (cell(),
//     __fmul_rn/__fadd_rn) is the earlier kernel's.
//   - Halo reuse: A is not gathered per tap.  Per chunk of KC = 64
//     channels the block stages the rows of hbuf its pixels touch under the
//     nine taps, once: one window of BM + 2W + 2 consecutive pixel rows
//     (from m0 - W - 1) where that fits the 3P rows reserved for it (P = BM
//     + 2 rounded up to 8, so W <= 139 at BM = 128), else three windows of
//     P rows, one per tap row.  Tap (dy, dx) of pixel m is window row
//     (dy + 1) * S + (m - m0) + 1 + dx (S = W, or P for three windows), read
//     by ldmatrix with a per-lane row address: the nine taps are nine
//     shifted reads of one staged tile.  A lane whose pixel's tap falls
//     outside the image (SAME padding, across row and image ends, where the
//     window holds a neighbour's pixels) or whose row is past M points at a
//     row of zeros instead.  Windows arrive by TMA (3-D map over hbuf, zero
//     fill outside it), 128-byte swizzled.
//   - The slab is shared by a cluster of CL = 2 blocks (1 and 4 built) that
//     take neighbouring pixel tiles of the same gate columns: each block's
//     producer loads BN / CL rows of every slab stage and multicasts them
//     to all CL blocks, so the slab leaves L2 once per cluster.  A stage's
//     empty barrier counts the releases of every consumer warp of the
//     cluster.
//   - Warp specialisation: a producer warpgroup (one thread starting the
//     slab stages, one the halo windows; setmaxnreg gives it 40 registers
//     and the two consumer warpgroups of the 128-pixel tile 232) keeps a
//     ring of STAGES = 4 slab stages (one tap x KC channels, BN x 128 B)
//     and A_SLOTS = 2 halo windows in flight on mbarriers.
//   - Persistent: a grid of as many clusters as fit at once walks over the
//     step's tiles, and the rings run on from one tile into the next.
//   - No atomics, a fixed order of the K loop: bitwise repeatable.
// Every F runs: hbuf pads the channels to a multiple of KC (zeros), so the
// windows are TMA boxes whatever F % 8; the epilogue moves bf16 pairs where
// F % 8 == 0 and single values otherwise (a template flag).
//
// The tile follows the shape (ops/convlstm.py:choose_tile): BM = 128 x BJ =
// 32 (two consumer warpgroups of m64n128, 384 threads, 171 KB of shared
// memory, one block per SM) where that gives at least one tile per SM, else
// BM = 64 x BJ = 16 (one of m64n64, 256 threads, 89 KB, two blocks per SM).
// Per step, tiles over resident blocks and bytes read from L2 into shared
// memory (bf16_l2_bytes: slab once per cluster, windows once per block and
// chunk), at the three bf16 path shapes:
//   downscale (16, 24, 24, 24, 128), M = 9216: 288 tiles over 132 blocks,
//     2.18 waves; 62.5 MB (PR 3's kernel: about 160 MB);
//   ensemble (64, 24, 24, 24, 128), M = 36864: 1152 over 132, 8.73 waves;
//     250.1 MB;
//   training (2, 24, 24, 24, 128), M = 1152: 144 tiles of 64 x 16 over 144
//     blocks; 15.9 MB.
// The wrapper passes BM, BJ, KC and CL, and the C entry refuses a tile it
// does not build.
//
// Measured by chip_smoke.py (NVIDIA H100 80GB HBM3, 700 W power limit), ms
// per sequence against cuDNN's T-1 recurrent convs in the same run: the
// downscale shape 0.938 (cuDNN 0.727, ratio 1.29; PR 3's kernel 1.185,
// 1.62), the ensemble shape 2.919 (1.516, 1.93; PR 3 4.520, 3.02), the
// training shape 0.267 (0.470, 0.57; PR 3 0.502); 27%, 35% and 12% of the
// bound.  What holds it there (python3 -m windtpu_torch.ops.convlstm_variants
// bf16, same card, downscale shape, 0.95 ms as is): not L2 bytes (cutting
// the slab loads 0.93, the halo windows 0.92; clusters of 1, 2, 4 within
// 1%), and only half the products (cutting them 0.74); the whole K loop cut
// leaves 0.45 ms, the epilogue and the per-step start, and cutting the gate
// math and stores 0.75.  Each tap pays a barrier round trip, its ldmatrix
// and a full wgmma.wait_group 0: with register A operands, keeping a tap's
// products in flight while the next tap's fragments load (wait_group 1)
// made ptxas serialise every wgmma (C7513: "non wgmma instructions
// defining input registers ... between start and end of the pipeline
// stage"), and that build was about 10% slower.  Tried and dropped: the
// gate epilogue in its own warpgroup from f32 sums in shared memory (1.18
// ms), the epilogue's zx and c staged by cp.async warps (1.17), consumer
// warpgroups taking alternate tiles (1.00), 64-pixel blocks two per SM
// (1.03), the epilogue's loads started before the K loop (0.92, no gain),
// an L2 prefetch of zx and c (no gain), and A from shared memory by
// descriptor (products then stay in flight without serialising) with the
// consumers taking alternate tiles: 0.938, 2.68 and 0.35 ms at the three
// shapes in a timing build without the padding masks.  Per downscale step
// the K loop takes about 20 us, the epilogue 13 and the start 5 to 10 (a
// sequence of empty kernels: 0.13 to 0.33 ms).
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
#include <cuda.h>   // CUtensorMap; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
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

// Programmatic dependent launch: let the next step's blocks be scheduled
// once every block of this step has started, and wait until the previous
// step has finished and its writes are visible.  Both are no-ops in a
// launch without the attribute.
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}


// ---- The bf16 route: wgmma on the tensor cores ----

constexpr int KC = 64;          // channels per stage: one 128-byte row
constexpr int ROW_BYTES = KC * 2;
constexpr int STAGES = 4;       // slab ring: one tap x KC channels a stage
constexpr int A_SLOTS = 2;      // halo windows: one channel chunk each
// A wait on a barrier longer than this (about 10 s) traps: a fault in the
// pipeline ends the launch with an error instead of hanging the card.
constexpr long long WATCHDOG_CYCLES = 20000000000LL;

template <int CW_, int BJ_>
struct Tile {
  static constexpr int CW = CW_;                   // consumer warpgroups
  static constexpr int BM = 64 * CW_;              // pixels per block
  static constexpr int BJ = BJ_;                   // channels per block
  static constexpr int BN = 4 * BJ_;               // gate columns per block
  static constexpr int JT = BJ_ / 8;               // n8 tiles per gate
  static constexpr int ACC = BN / 2;               // f32 accumulators each
  static constexpr int THREADS = 128 * (CW_ + 1);  // + a producer warpgroup
  static constexpr int MIN_BLOCKS = CW_ == 1 ? 2 : 1;
  static constexpr int P = (BM + 2 + 7) / 8 * 8;   // rows of a halo window
  static constexpr int A_BYTES = 3 * P * ROW_BYTES;
  static constexpr int B_BYTES = BN * ROW_BYTES;
  // Windows, slab stages, mbarriers, then one 128-byte row of zeros.
  static constexpr int BAR_BYTES =
      (8 * 2 * (A_SLOTS + STAGES) + 127) / 128 * 128;
  static constexpr size_t SMEM = 1024 + (size_t)A_SLOTS * A_BYTES +
                                 (size_t)STAGES * B_BYTES + BAR_BYTES +
                                 ROW_BYTES;
  static_assert(BN == 64 || BN == 128, "wgmma_n64 or wgmma_n128");
  static_assert(A_BYTES % 1024 == 0 && B_BYTES % 1024 == 0,
                "swizzle atoms stay 1024-byte aligned");
};
using LargeTile = Tile<2, 32>;    // 128 px x 32 channels, 384 threads
using SmallTile = Tile<1, 16>;    // 64 px x 16 channels, 256 threads

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_nctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n"
               "barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// Arrive on the barrier at the same offset in block `cta` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t cta) {
  asm volatile("{\n.reg .b32 remote;\n"
               "mapa.shared::cluster.u32 remote, %0, %1;\n"
               "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n"
               :: "r"(bar), "r"(cta) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile("{\n.reg .pred p;\n"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
               "selp.b32 %0, 1, 0, p;\n}\n"
               : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > WATCHDOG_CYCLES) __trap();
  }
}
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// TMA: box (c0, c1, c2) of a 3-D tensor map into shared memory at dst,
// completing `bytes` on the barrier; the multicast form writes the same box
// at the same offset of every block in `mask` and completes on each one's
// barrier at the same offset.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
               "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
                  "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}
__device__ __forceinline__ void tma_load_3d_multicast(uint32_t dst,
                                                      const CUtensorMap* map,
                                                      uint32_t bar, int c0,
                                                      int c1, int c2,
                                                      uint16_t mask) {
  asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
               "complete_tx::bytes.multicast::cluster [%0], [%1, {%4, %5, "
               "%6}], [%2], %3;\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
                  "h"(mask), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// Shared-memory descriptor of a K-major operand in the 128-byte swizzle:
// rows of 128 B (64 bf16 of K), 8-row atoms 1024 B apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keeps the compiler from moving accumulator accesses across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
__device__ __forceinline__ void fence_desc(uint64_t (&d)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+l"(d[i]) :: "memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j]) :: "memory");
}

// D (64 x N, f32) += A (64 x 16, bf16, registers) * B (16 x N, bf16, shared
// memory at desc, K-major).
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <int N>
__device__ __forceinline__ void wgmma_tile(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  if constexpr (N == 128) {
    wgmma_n128(d, a, desc);
  } else {
    wgmma_n64(d, a, desc);
  }
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// One step t, persistent: cluster q of the grid's clusters takes output
// tiles u = q, q + clusters, ... of the step's `groups` x ceil(F/BJ);
// tile u is channel tile u % ceil(F/BJ) of pixel group u / ceil(F/BJ),
// whose CL blocks take its CL pixel tiles of BM (pixel tiles past M read
// zeros and store nothing).  The rings run on across tiles, so the next
// tile's loads overlap this tile's epilogue.  h_map: hbuf as (Fp, M, 2),
// box (KC, P, 1); w_map: the slab as (Fp, BN, ceil(F/BJ) * 9), box (KC,
// BN / CL, 1); both 128-byte swizzled.  VEC: F % 8 == 0, so the epilogue
// moves bf16 pairs.
template <class C, bool VEC>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
convlstm_step_wgmma(const __grid_constant__ CUtensorMap h_map,
                    const __grid_constant__ CUtensorMap w_map,
                    const __nv_bfloat16* __restrict__ zx,
                    __nv_bfloat16* __restrict__ y,
                    __nv_bfloat16* __restrict__ c,
                    __nv_bfloat16* __restrict__ hbuf, int B, int Tn, int H,
                    int W, int F, int Fp, int t, bool hard, int groups) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sA = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sB = sA + A_SLOTS * C::A_BYTES;
  const uint32_t bars = sB + STAGES * C::B_BYTES;
  auto full_a = [&](int i) { return bars + 8 * i; };
  auto empty_a = [&](int i) { return bars + 8 * (A_SLOTS + i); };
  auto full_b = [&](int s) { return bars + 8 * (2 * A_SLOTS + s); };
  auto empty_b = [&](int s) {
    return bars + 8 * (2 * A_SLOTS + STAGES + s);
  };
  const uint32_t zero_row = bars + C::BAR_BYTES;   // what taps outside read

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int HW = H * W;
  const int M = B * HW;
  const int nb = (F + C::BJ - 1) / C::BJ;
  const int chunks = Fp / KC;
  const int KT = t > 0 ? 9 * chunks : 0;   // k-iterations: chunk, then tap
  const uint32_t cl = cluster_nctarank();
  const uint32_t rank = cluster_ctarank();
  const int cluster = blockIdx.x / cl;
  const int clusters = gridDim.x / cl;
  const int tiles = groups * nb;
  // One halo window where the three tap rows' pixel rows fit in it.
  const bool one_window = 2 * W + C::BM + 2 <= 3 * C::P;
  const int S = one_window ? W : C::P;     // window rows between tap rows
  auto tile_m0 = [&](int u) {
    return ((u / nb) * (int)cl + (int)rank) * C::BM;
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < A_SLOTS; ++i) {
      mbar_init(full_a(i), 1);
      mbar_init(empty_a(i), 4 * C::CW);
    }
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_b(s), 1);
      mbar_init(empty_b(s), 4 * C::CW * cl);
    }
    fence_mbarrier_init();
  }
  if (tid < ROW_BYTES / 16) {
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n"
                 :: "r"(zero_row + 16 * tid), "r"(0) : "memory");
  }
  griddep_launch_dependents();
  // Every block's barriers (and its zero row) exist before a peer
  // multicasts into it.
  cluster_sync();

  if (wg == C::CW) {
    // Producer warpgroup.  It never reconverges with the consumers.
    if constexpr (C::CW == 2) setmaxnreg_dec<40>();
    const int warp = (tid / 32) % 4;
    if (KT > 0 && warp == 0 && tid % 32 == 0) {
      // The slab: stage kt of a tile is tap kt % 9 of chunk kt / 9, BN
      // rows of 128 B; this block loads rows [rank, rank + 1) * BN / CL of
      // it for all CL blocks.
      const int rows = C::BN / (int)cl;
      const uint16_t mask = (uint16_t)((1u << cl) - 1u);
      int it = 0;
      for (int u = cluster; u < tiles; u += clusters) {
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(empty_b(s), (it / STAGES - 1) & 1);
          mbar_expect_tx(full_b(s), C::B_BYTES);
          const uint32_t dst = sB + s * C::B_BYTES + rank * rows * ROW_BYTES;
          const int c0 = (kt / 9) * KC;
          const int n0 = (int)rank * rows;
          const int z = (u % nb) * 9 + kt % 9;
          if (cl > 1) {
            tma_load_3d_multicast(dst, &w_map, full_b(s), c0, n0, z, mask);
          } else {
            tma_load_3d(dst, &w_map, full_b(s), c0, n0, z);
          }
        }
      }
      // The cluster's consumers still release the last stages into this
      // block's barriers: stay until they have.
      for (int i = it > STAGES ? it - STAGES : 0; i < it; ++i) {
        mbar_wait(empty_b(i % STAGES), (i / STAGES) & 1);
      }
    } else if (KT > 0 && warp == 1 && tid % 32 == 0) {
      // The halo windows of h_{t-1}, written by the previous step.
      const int boxes =
          one_window ? (2 * W + C::BM + 2 + C::P - 1) / C::P : 3;
      griddep_wait();
      int ia = 0;
      for (int u = cluster; u < tiles; u += clusters) {
        const int m0 = tile_m0(u);
        for (int ch = 0; ch < chunks; ++ch, ++ia) {
          const int s = ia % A_SLOTS;
          if (ia >= A_SLOTS) mbar_wait(empty_a(s), (ia / A_SLOTS - 1) & 1);
          mbar_expect_tx(full_a(s), boxes * C::P * ROW_BYTES);
          for (int i = 0; i < boxes; ++i) {
            const int row =
                one_window ? m0 - W - 1 + i * C::P : m0 + (i - 1) * W - 1;
            tma_load_3d(sA + s * C::A_BYTES + i * C::P * ROW_BYTES, &h_map,
                        full_a(s), ch * KC, row, (t - 1) & 1);
          }
        }
      }
    }
  } else {
    // Consumer warpgroup wg: pixels m0 + 64 wg .. + 63 of each tile.
    if constexpr (C::CW == 2) setmaxnreg_inc<232>();
    const int warp = (tid / 32) % 4;
    const int lane = tid % 32;
    const int wrow = wg * 64 + warp * 16;   // this warp's first pixel row
    const size_t F4 = 4 * (size_t)F;
    __nv_bfloat16* hout = hbuf + (size_t)(t & 1) * M * Fp;
    int it = 0;   // slab stages consumed
    int ia = 0;   // halo windows consumed
    for (int u = cluster; u < tiles; u += clusters) {
      const int m0 = tile_m0(u);
      const int j0 = (u % nb) * C::BJ;
      float acc[C::ACC];
#pragma unroll
      for (int i = 0; i < C::ACC; ++i) acc[i] = 0.0f;

      if (KT > 0) {
        // ldmatrix: lane l addresses pixel row wrow + (l & 15), 16-byte
        // chunk (l >> 4) of each k16 step.
        const int lrow = wrow + (lane & 15) + 1;
        const int lm = m0 + lrow - 1;
        const int lp = (lm < M ? lm : 0) % HW;
        const int ly = lm < M ? lp / W : -2;    // -2: outside for every dy
        const int lx = lp % W;
        fence_acc(acc);
        for (int ch = 0; ch < chunks; ++ch, ++ia) {
          const int as = ia % A_SLOTS;
          mbar_wait(full_a(as), (ia / A_SLOTS) & 1);
#pragma unroll
          for (int tap = 0; tap < 9; ++tap, ++it) {
            const int s = it % STAGES;
            mbar_wait(full_b(s), (it / STAGES) & 1);
            // SAME padding, row and image ends, rows past M: a lane whose
            // pixel row's tap falls outside the image points ldmatrix at
            // the zero row, so that row of the fragment is zero.  (A
            // select on the fragment registers lands between the wgmmas
            // instead, and ptxas then serialises them.)
            const int dy = tap / 3 - 1;
            const int dx = tap % 3 - 1;
            const int row = (dy + 1) * S + lrow + dx;
            const bool inside = (unsigned)(ly + dy) < (unsigned)H &&
                                (unsigned)(lx + dx) < (unsigned)W;
            const uint32_t arow = sA + as * C::A_BYTES + row * ROW_BYTES;
            uint32_t a[4][4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const int chunk = (2 * kk + (lane >> 4)) ^ (row & 7);
              ldmatrix_x4(a[kk], inside ? arow + chunk * 16 : zero_row);
            }
            const uint32_t bst = sB + s * C::B_BYTES;
            uint64_t desc[4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              desc[kk] = sw128_desc(bst + kk * 32);
            }
            // Every operand is in its register before the products start.
            fence_regs(a);
            fence_desc(desc);
            fence_acc(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              wgmma_tile<C::BN>(acc, a[kk], desc[kk]);
            }
            wgmma_commit();
            // The other consumer warpgroup's products keep the tensor
            // cores busy while this one waits.
            wgmma_wait<0>();
            fence_acc(acc);
            // Free the slab stage in every block of the cluster (lane r:
            // block r's barrier), and the window after the chunk's last tap.
            if ((uint32_t)lane < cl) mbar_arrive_cluster(empty_b(s), lane);
            if (tap == 8 && lane == 0) mbar_arrive(empty_a(as));
          }
        }
      }

      // Epilogue: accumulator element (half, e) of n8 tile (g, jt) is
      // pixel row lane/4 + 8*half and channel 2*(lane%4) + e of that tile,
      // the same channel for the four gates.  It reads c and writes c and
      // y, and h into hbuf's half t % 2: what the previous step wrote, so
      // wait for it first.
      griddep_wait();
      bool in_m[2];
      size_t step_row[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wrow + lane / 4 + 8 * half;
        in_m[half] = m < M;
        const int mm = in_m[half] ? m : 0;
        const int b = mm / HW;
        step_row[half] = ((size_t)b * Tn + t) * HW + (mm - b * HW);
      }
      if constexpr (VEC) {
        const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.0f, 0.0f);
        __nv_bfloat162 zv[2][C::JT][4], cv[2][C::JT];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const size_t m = (size_t)(m0 + wrow + lane / 4 + 8 * half);
#pragma unroll
          for (int jt = 0; jt < C::JT; ++jt) {
            const int j = j0 + jt * 8 + 2 * (lane & 3);
            const bool in = in_m[half] && j < F;
            const __nv_bfloat16* z = zx + step_row[half] * F4 + j;
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              zv[half][jt][g] =
                  in ? *reinterpret_cast<const __nv_bfloat162*>(z + g * F)
                     : zero2;
            }
            cv[half][jt] = in && t > 0
                               ? *reinterpret_cast<const __nv_bfloat162*>(
                                     c + m * F + j)
                               : zero2;
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const size_t m = (size_t)(m0 + wrow + lane / 4 + 8 * half);
#pragma unroll
          for (int jt = 0; jt < C::JT; ++jt) {
            const int j = j0 + jt * 8 + 2 * (lane & 3);
            if (!in_m[half] || j >= F) continue;
            float cn[2], hn[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float zg[4];
#pragma unroll
              for (int g = 0; g < 4; ++g) {
                zg[g] = (e ? __high2float(zv[half][jt][g])
                           : __low2float(zv[half][jt][g])) +
                        acc[4 * (g * C::JT + jt) + 2 * half + e];
              }
              const float c_prev = e ? __high2float(cv[half][jt])
                                     : __low2float(cv[half][jt]);
              cell(zg[0], zg[1], zg[2], zg[3], c_prev, hard, cn[e], hn[e]);
            }
            const __nv_bfloat162 h2 = __floats2bfloat162_rn(hn[0], hn[1]);
            *reinterpret_cast<__nv_bfloat162*>(c + m * F + j) =
                __floats2bfloat162_rn(cn[0], cn[1]);
            *reinterpret_cast<__nv_bfloat162*>(y + step_row[half] * F + j) =
                h2;
            *reinterpret_cast<__nv_bfloat162*>(hout + m * Fp + j) = h2;
          }
        }
      } else {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (!in_m[half]) continue;
          const size_t m = (size_t)(m0 + wrow + lane / 4 + 8 * half);
#pragma unroll
          for (int jt = 0; jt < C::JT; ++jt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = j0 + jt * 8 + 2 * (lane & 3) + e;
              if (j >= F) continue;
              const int q = 2 * half + e;
              const __nv_bfloat16* z = zx + step_row[half] * F4 + j;
              const float c_prev =
                  t > 0 ? __bfloat162float(c[m * F + j]) : 0.0f;
              float cn, hn;
              cell(__bfloat162float(z[0]) + acc[4 * (0 * C::JT + jt) + q],
                   __bfloat162float(z[F]) + acc[4 * (1 * C::JT + jt) + q],
                   __bfloat162float(z[2 * (size_t)F]) +
                       acc[4 * (2 * C::JT + jt) + q],
                   __bfloat162float(z[3 * (size_t)F]) +
                       acc[4 * (3 * C::JT + jt) + q],
                   c_prev, hard, cn, hn);
              const __nv_bfloat16 h1 = __float2bfloat16_rn(hn);
              c[m * F + j] = __float2bfloat16_rn(cn);
              y[step_row[half] * F + j] = h1;
              hout[m * Fp + j] = h1;
            }
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
  // Step t reads y[:, t-1] and c from the previous step at once.  (The
  // next step is released when this one's blocks exit: released at their
  // start, its waiting blocks slowed this route by a quarter at
  // train_main's shape.)
  griddep_wait();
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
// own flag array).
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

// The T launches of a sequence: step 0 as an ordinary launch (it waits for
// all earlier work on the stream), steps 1 .. T-1 with programmatic stream
// serialization.  `launch(config, t)` enqueues step t.  On an error, the step
// that failed goes to *failed.
template <class Launch>
int launch_steps(cudaLaunchConfig_t config, cudaLaunchAttribute* attrs,
                 int nattrs, int Tn, int* failed, Launch launch) {
  attrs[nattrs].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[nattrs].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attrs;
  for (int t = 0; t < Tn; ++t) {
    config.numAttrs = nattrs + (t > 0 ? 1 : 0);
    cudaError_t err = launch(config, t);
    const cudaError_t last = cudaGetLastError();   // and clears err
    if (err == cudaSuccess) err = last;
    if (err != cudaSuccess) {
      *failed = t;
      return (int)err;
    }
  }
  return 0;
}

cudaLaunchAttribute cluster_attr(int blocks) {
  cudaLaunchAttribute a;
  a.id = cudaLaunchAttributeClusterDimension;
  a.val.clusterDim.x = blocks;
  a.val.clusterDim.y = 1;
  a.val.clusterDim.z = 1;
  return a;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a libcuda entry point, fetched through the runtime so
// the library links against the runtime alone.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A 3-D bf16 map, 128-byte swizzle, zero fill outside the tensor: dims
// innermost first, byte strides of dims 1 and 2, box (b0, b1, 1).
bool encode_map(CUtensorMap* map, const void* ptr, uint64_t d0, uint64_t d1,
                uint64_t d2, uint64_t s1, uint64_t s2, uint32_t b0,
                uint32_t b1) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {s1, s2};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A bf16 sequence: as many clusters of cl blocks as fit on the card at
// once (at most one per output tile), each walking over the step's tiles.
template <class C, bool VEC>
int launch_wgmma(const void* zx, const void* slab, void* y, void* c,
                 void* hbuf, int B, int Tn, int H, int W, int F,
                 int hard_sig, int cl, void* stream, int* failed) {
  auto kernel = convlstm_step_wgmma<C, VEC>;
  static bool done[64] = {};
  cudaError_t err =
      opt_in(done, reinterpret_cast<const void*>(kernel), C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int M = B * H * W;
  const int Fp = (F + KC - 1) / KC * KC;
  const int nb = (F + C::BJ - 1) / C::BJ;
  const int groups = ((M + C::BM - 1) / C::BM + cl - 1) / cl;
  CUtensorMap h_map, w_map;
  if (!encode_map(&h_map, hbuf, Fp, M, 2, 2ull * Fp, 2ull * M * Fp, KC,
                  C::P) ||
      !encode_map(&w_map, slab, Fp, C::BN, 9ull * nb, 2ull * Fp,
                  2ull * C::BN * Fp, KC, C::BN / cl)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaLaunchAttribute attrs[2] = {cluster_attr(cl)};
  cudaLaunchConfig_t config = {};
  config.blockDim = dim3(C::THREADS);
  config.dynamicSmemBytes = C::SMEM;
  config.stream = (cudaStream_t)stream;
  config.attrs = attrs;
  config.numAttrs = 1;
  // Clusters resident at once, per device and cluster size (a host query
  // each sequence would otherwise pay).
  static int resident_on[64][5] = {};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int resident = dev < 64 ? resident_on[dev][cl] : 0;
  if (resident == 0) {
    config.gridDim = dim3((unsigned)(groups * nb * cl));
    err = cudaOccupancyMaxActiveClusters(&resident, kernel, &config);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) resident_on[dev][cl] = resident;
  }
  config.gridDim =
      dim3((unsigned)(std::max(1, std::min(resident, groups * nb)) * cl));
  return launch_steps(
      config, attrs, 1, Tn, failed, [&](const cudaLaunchConfig_t& cfg, int t) {
        return cudaLaunchKernelEx(
            &cfg, kernel, h_map, w_map, static_cast<const __nv_bfloat16*>(zx),
            static_cast<__nv_bfloat16*>(y), static_cast<__nv_bfloat16*>(c),
            static_cast<__nv_bfloat16*>(hbuf), B, Tn, H, W, F, Fp, t,
            hard_sig != 0, groups);
      });
}

template <class C>
int launch_bf16(const void* zx, const void* slab, void* y, void* c,
                void* hbuf, int B, int Tn, int H, int W, int F, int hard_sig,
                int cl, void* stream, int* failed) {
  if (F % 8 == 0) {
    return launch_wgmma<C, true>(zx, slab, y, c, hbuf, B, Tn, H, W, F,
                                 hard_sig, cl, stream, failed);
  }
  return launch_wgmma<C, false>(zx, slab, y, c, hbuf, B, Tn, H, W, F,
                                hard_sig, cl, stream, failed);
}

// An f32 sequence: ceil(M/BM) clusters of SPLIT blocks along x, ceil(F/BJ)
// channel tiles along y.
template <class C, int SPLIT, bool VEC>
int launch_cuda_cores(const void* zx, const void* wpack, void* y, void* c,
                      int B, int Tn, int H, int W, int F, int hard_sig,
                      void* stream, int* failed) {
  auto kernel = convlstm_step_f32<C, SPLIT, VEC>;
  static bool done[64] = {};
  cudaError_t err =
      opt_in(done, reinterpret_cast<const void*>(kernel), C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int M = B * H * W;
  cudaLaunchAttribute attrs[2];
  int nattrs = 0;
  if (SPLIT > 1) attrs[nattrs++] = cluster_attr(SPLIT);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)((M + C::BM - 1) / C::BM * SPLIT),
                        (unsigned)((F + C::BJ - 1) / C::BJ));
  config.blockDim = dim3(C::THREADS);
  config.dynamicSmemBytes = C::SMEM;
  config.stream = (cudaStream_t)stream;
  return launch_steps(
      config, attrs, nattrs, Tn, failed,
      [&](const cudaLaunchConfig_t& cfg, int t) {
        return cudaLaunchKernelEx(
            &cfg, kernel, static_cast<const float*>(zx),
            static_cast<const float*>(wpack), static_cast<float*>(y),
            static_cast<float*>(c), B, Tn, H, W, F, (F + BK - 1) / BK * BK,
            t, hard_sig != 0);
      });
}

template <class C>
int launch_f32(const void* zx, const void* wpack, void* y, void* c, int B,
               int Tn, int H, int W, int F, int hard_sig, int split,
               void* stream, int* failed) {
  const bool vec = F % 4 == 0;
  if (split == 1) {
    return vec ? launch_cuda_cores<C, 1, true>(zx, wpack, y, c, B, Tn, H, W,
                                               F, hard_sig, stream, failed)
               : launch_cuda_cores<C, 1, false>(zx, wpack, y, c, B, Tn, H,
                                                W, F, hard_sig, stream,
                                                failed);
  }
  if (split == 3) {
    return vec ? launch_cuda_cores<C, 3, true>(zx, wpack, y, c, B, Tn, H, W,
                                               F, hard_sig, stream, failed)
               : launch_cuda_cores<C, 3, false>(zx, wpack, y, c, B, Tn, H,
                                                W, F, hard_sig, stream,
                                                failed);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// A whole sequence, t = 0 .. T-1, T launches on `stream`.  dtype: 0 =
// float32 (CUDA cores), 1 = bfloat16 (wgmma); rk is the route's packed
// slab.  bm, bj, kc and cluster name the tile the caller chose and packed
// the slab for (ops/convlstm.py): bf16 (TILES, K_CHUNK) BM 128 x BJ 32, BM
// 128 x BJ 16 or BM 64 x BJ 16, KC 64, clusters of 1, 2 or 4 blocks sharing
// the slab, and hbuf the (2, B*H*W, Fp) scratch copy of h (channels >= F
// zero); f32 (F32_TILES, F32_CHUNK) BM 64 or 32 x BJ 32, KC 16, clusters of
// 1 or 3 blocks splitting the taps, hbuf unused.  Returns 0, or the first
// failing launch's error code with its step in *failed_step; an unknown
// dtype, a tile, KC or cluster this file does not build, or more than
// 2^31 - 1 pixels returns cudaErrorInvalidValue before any launch (step 0).
extern "C" int windtpu_convlstm_seq(int dtype, const void* zx, const void* rk,
                                    void* y, void* c, void* hbuf, int B,
                                    int T, int H, int W, int F, int hard_sig,
                                    int bm, int bj, int kc, int cluster,
                                    void* stream, int* failed_step) {
  *failed_step = 0;
  if ((long long)B * H * W > 2147483647LL) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && kc == BK) {
    if (bm == F32Large::BM && bj == F32Large::BJ) {
      return launch_f32<F32Large>(zx, rk, y, c, B, T, H, W, F, hard_sig,
                                  cluster, stream, failed_step);
    }
    if (bm == F32Small::BM && bj == F32Small::BJ) {
      return launch_f32<F32Small>(zx, rk, y, c, B, T, H, W, F, hard_sig,
                                  cluster, stream, failed_step);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != 1 || kc != KC || hbuf == nullptr ||
      (cluster != 1 && cluster != 2 && cluster != 4)) {
    return (int)cudaErrorInvalidValue;
  }
  if (bm == LargeTile::BM && bj == LargeTile::BJ) {
    return launch_bf16<LargeTile>(zx, rk, y, c, hbuf, B, T, H, W, F,
                                  hard_sig, cluster, stream, failed_step);
  }
  if (bm == SmallTile::BM && bj == SmallTile::BJ) {
    return launch_bf16<SmallTile>(zx, rk, y, c, hbuf, B, T, H, W, F,
                                  hard_sig, cluster, stream, failed_step);
  }
  return (int)cudaErrorInvalidValue;
}
