// Layer2's bf16 3x3 convolutions on Hopper's warpgroup tensor cores
// (sm_90a `wgmma`): prep -> 3x3 convolution (and the 1x1 projection) ->
// + bias -> bf16 output, with the optional per-(image, channel) fp32 sum
// and sum of squares of the fp32 output.
//
// Replaces the bf16 forms (dt=bfloat16) of the TPU kernels
//   raftstereo_tpu/ops/pallas_layer2.py `_l2_entry_kernel` (row 15: the
//   3x3 stride-2 64->96 conv and the 1x1 stride-2 projection of the same
//   post-relu input, mode kNone, two outputs) and
//   raftstereo_tpu/ops/pallas_layer2.py `_l2_conv_kernel` /
//   `_l2_conv_res_kernel` (row 16: the 3x3 stride-1 96->96 convs, modes
//   kPrep t = relu(x*s + t) and kResProj t = relu((r*rs + rt) + relu(x*s
//   + t))),
// each with and without its sums.  Their fp32 forms stay on
// enc_conv_tc.cu.  Function, NCHW, per output pixel (oy, ox), channel co:
//   y  = bias + sum_{ci,dy,dx} w[co,ci,dy,dx] * t[ci, S*oy+dy-1, S*ox+dx-1]
//   yp = bp + sum_ci wp[co,ci] * t[ci, 2*oy, 2*ox]      (row 15 only)
// with t the prepped input, zero outside the image AFTER the prep, rounded
// where the TPU kernels round (enc_bf16.cuh `prep_bf16`: each affine cast
// to bf16, each product and sum of the prep rounded to bf16); the
// products of bf16 values exact, summed in fp32, the bf16 bias added in
// fp32, the sums taken of that fp32 output, which is stored rounded to
// bf16 once.
//
// Design.  An implicit GEMM, pixels x 96 outputs, K = input channels x
// taps, walked in k-steps of 16 channels (kKC), all taps per k-step.
//   - Persistent blocks: one 512-thread block an SM walks output tiles
//     t = blockIdx.x, + gridDim.x, ... over all images in a fixed order.
//     A tile is TH output rows x 64 columns (kTW): row 16 4 x 64, row 15
//     2 x 64.  The whole weight set stays in shared memory for the call
//     (row 16: 9 taps x 6 k-steps x 3 KB = 162 KB; row 15: 10 x 4 x 3 KB
//     = 120 KB), loaded once by `cp.async.bulk` onto an mbarrier in the
//     layout of `cuda_encoder.wg_pack`: per (k-step, tap) two halves
//     (channels 0-7 | 8-15) of 96 rows of 16 bytes, which is the K-major
//     no-swizzle layout `wgmma` reads (core matrices of 8 outputs, SBO
//     128 bytes, LBO 96 * 16 bytes).  The first bf16 form (enc_conv_tc.cu's
//     `mma.sync` kernel) re-read the pack from L2 for every 128-pixel
//     block (358 MB a serving call for row 16).
//   - Two producer warpgroups (warps 0-7, `setmaxnreg` down to
//     prod_regs) fill a ring of kStages stages of the haloed input tile,
//     one k-step each, taking the stages in turns, so that one's loads
//     are in flight while the other preps.  A producer loads x (and r)
//     along W in 16-byte vectors (8 pixels of one channel a lane; 2-byte
//     loads where W is not a multiple of 8 or a pointer is not 16-byte
//     aligned) before it waits for its stage to be free, then preps in
//     bf16x2 (the JAX rounding points, 3 instructions a pair: see mul2),
//     masks, and transposes each 8-channel x 32-pixel unit of a warp
//     into pixel rows with one `stmatrix.x4.trans` (8 channels of a pixel
//     = one 16-byte row; the lanes' registers rotated by lane % 4 so that
//     each 8x8 matrix's 8 rows fall in 8 distinct bank groups).  The
//     halo's edge columns take scalar loads and a 16-byte store.  Stride
//     1: a stage is two planes (the channel halves) of (TH + 2) rows x 66
//     pixels.  Stride 2: each half as four (row, column) parity planes of
//     (TH + 1) x 65 pixels, so that each tap's window is again 64
//     consecutive pixels of one plane.  A full mbarrier (128 producer
//     arrivals, after `fence.proxy.async`) and an empty one (256 consumer
//     arrivals) per stage replace the block-wide barrier that ended each
//     of the first form's stages.  TMA cannot prep or zero in the
//     prepped domain, so it loads only the weights.  One producer
//     warpgroup with the prep in fp32 set the pace (4x slower; the forms
//     tried: PERF.md §6).
//   - Two consumer warpgroups (warps 8-15, `setmaxnreg` up to cons_regs)
//     each own MR output rows of the tile (row 16 two, row 15 one): per
//     k-step and tap one `wgmma.mma_async.m64n96k16.f32.bf16.bf16` per row,
//     A from shared memory through a descriptor whose start is the tap's
//     shifted window (the start field counts 16-byte units, so a shift of
//     one pixel is a valid start; tests/test_torch_port_cuda.py's
//     descriptor unit proves it on the card), B the resident (k-step,
//     tap) block.  Row 15's projection is a tenth weight block on the
//     centre tap's window (at stride 2 the pixels (2*oy, 2*ox)).  One
//     commit group per k-step; a stage is released once the next k-step's
//     group is issued and its own has completed (`wgmma.wait_group 1`).
//   - Accumulation: all of K in one fp32 chain per output (the first
//     form summed each stage's taps into a fresh accumulator against the
//     tensor cores' truncating adds; the fresh sums would need 192
//     accumulators a thread here).  tests/test_torch_port_enc_wg.py
//     emulates the chain with each k-step's 16 products added by
//     truncation and holds it within the chip's gate of the plain version
//     (1 bf16 ulp, at least 99% equal, sums within ENC_TOL).
//   - Epilogue per consumer and output: + bias in fp32; each lane's fp32
//     sums of its valid pixels (rows in order), reduce-scattered over the
//     8 lanes of a channel in a fixed order and summed over the 8 warps in
//     order through shared memory into per-TILE partials (B, nb, 2, CH),
//     which enc_partials.cuh's kernel reduces in a fixed order: two calls
//     are bitwise equal whatever block took which tile.  The bf16 output
//     is staged in shared memory (a channel's 64 pixels one 144-byte row:
//     conflict-free 2-byte writes) and stored as 16-byte rows along W.
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): row 16 at
// 2x96x288x480 is 45.9 GFLOP of products, 0.046 ms; row 15 at
// 2x64x576x960 is 34 GFLOP against 248 MB, 0.074 ms by bytes (chip_smoke.py
// counts both per call).  What holds the kernel from that: the producers
// (the halo, 1.55x the input pixels a tile needs at stride 1, 1.26x at
// stride 2, its prep and transpose on the CUDA cores, and the loads'
// latency); shared-memory bandwidth (each m64n96k16 reads 5 KB of
// operands, about 104 of the 128 bytes a cycle); the epilogue, which does
// not overlap the next tile's products (the sums take a fifth of row 15's
// time); the last tile of each axis overhangs the output (about 7% at the
// path shapes).  Cout is 96 (kN); row 9 (64 -> 64, 72 KB of weights)
// could become an instance with N a template parameter.

#include "enc_bf16.cuh"
#include "enc_partials.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 96;             // outputs: all of Cout in one wgmma
constexpr int kKC = 16;            // input channels a k-step
constexpr int kTW = 64;            // output columns a tile: one m64
constexpr int kBlk = 2 * kN * 16;  // bytes of a (k-step, tap) weight block
enum Mode { kNone = 0, kPrep = 1, kResProj = 3 };

constexpr int kProducers = 2;      // producer warpgroups, then 2 consumers
constexpr int kThreads = 128 * (kProducers + 2);
// setmaxnreg's split of the block's registers by mode: it only moves
// registers within the launch allocation (512 threads x 128).  The
// residual form's producer holds x and r.
__host__ __device__ constexpr int prod_regs(int mode) {
  return mode == kResProj ? 120 : 104;
}
__host__ __device__ constexpr int cons_regs(int mode) {
  return (kThreads * (65536 / kThreads) - kProducers * 128 * prod_regs(mode)) /
         256;
}
static_assert(cons_regs(kPrep) == 152 && cons_regs(kResProj) == 136,
              "multiples of 8");
constexpr int kOutPitch = 144;     // staging bytes of a channel's 64 pixels
constexpr int kMaxSmem = 232448;

template <int S, bool PROJ, int NK>
struct WgGeo {
  static constexpr int MR = PROJ ? 1 : 2;   // output rows per consumer
  static constexpr int TH = 2 * MR;         // output rows a tile
  static constexpr int PW = S == 1 ? kTW + 2 : kTW + 1;  // plane pitch (px)
  static constexpr int PH = S == 1 ? TH + 2 : TH + 1;    // plane rows
  static constexpr int NPL = S == 1 ? 1 : 4;             // parity planes
  static constexpr int kHalf = NPL * PH * PW * 16;  // a channel half: LBO
  static constexpr int kStage = 2 * kHalf;
  static constexpr int kTaps = PROJ ? 10 : 9;
  static constexpr int kW = NK * kTaps * kBlk;      // resident weights
  static constexpr int RH = S == 1 ? TH + 2 : 2 * TH + 1;  // halo rows
  static constexpr int UPR = S * kTW / 32;  // 32-pixel units a halo row
  static constexpr int NU = RH * 2 * UPR;   // units a stage (both halves)
  static constexpr int UPW = NU / 4;        // units a producer warp
  static constexpr int NSIDE = S == 1 ? 2 : 1;  // edge columns a halo row
  static constexpr int NE = RH * 2 * NSIDE;     // edge items a stage
  static constexpr int kOut = kN * kOutPitch;   // a consumer's staging
  static constexpr int kFixed = kW + 2 * kOut;
  static constexpr int kStages0 = (kMaxSmem - kFixed - 128) / kStage;
  static constexpr int kStages = kStages0 > 4 ? 4 : kStages0;
  static constexpr int kBar = kFixed + kStages * kStage;  // 2*kStages + 1
  static constexpr int kSmem = kBar + 8 * (2 * kStages + 1);
  static_assert(NU % 4 == 0 && NE <= 128, "units dealt to 4 warps");
  static_assert(kStages >= 2 && kSmem <= kMaxSmem, "fits an SM");
  static_assert(4 * 2 * kN * 4 <= kOut, "the sums' scratch fits staging");
};

struct Args {
  const unsigned short* x;  // (B, Cin, H, W) bf16 bits
  const float* xs;          // (B, Cin) prep scale (kPrep, kResProj)
  const float* xt;
  const unsigned short* r;  // (B, Cin, H, W) residual input (kResProj)
  const float* rs;
  const float* rt;
  const unsigned short* w;  // wg_pack: (k-steps, taps, 2, 96, 8)
  const __nv_bfloat16* bias;  // (96)
  const __nv_bfloat16* bp;    // (96) projection bias (row 15)
  __nv_bfloat16* y;           // (B, 96, Ho, Wo)
  __nv_bfloat16* yp;          // (B, 96, Ho, Wo) projection (row 15)
  float* partials;            // (B, nb, 2, CH) per-tile sums, or null
  int cin, h, win, ho, wo, tiles_w, nb, total, nk;
  int vin, vout;  // 16-byte loads along W (inputs), stores (outputs)
};

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Waits for the phase of parity `parity` of barrier `bar` to complete.  A
// phase that never completes traps (an error the caller sees) instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1L << 24)) __trap();
  }
}
// `bytes` (a multiple of 16) from global `src` to shared `dst`, completing
// that many bytes of barrier `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// This thread's generic-proxy writes to shared memory, made visible to
// the async proxy (`wgmma`'s operand reads).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_bar(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
template <int R>
__device__ __forceinline__ void set_regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void set_regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
// Four 8x8 b16 matrices stored transposed: lanes 8i..8i+7 give the
// addresses of matrix i's memory rows j = 0..7; memory row j of matrix i
// receives column j of the fragment whose row g, columns 2c and 2c + 1
// lane 4g + c holds in register i.
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, uint32_t r0,
                                                  uint32_t r1, uint32_t r2,
                                                  uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, "
      "%4};\n" ::"r"(addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}
__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a,
                                             uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across a
// wgmma fence or wait.
__device__ __forceinline__ void fence_acc(float (&d)[48]) {
#pragma unroll
  for (int i = 0; i < 48; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A `wgmma` shared-memory matrix descriptor, no swizzle (the interleave
// layout): a core matrix is 8 rows of 16 bytes, 128 contiguous bytes;
// K-major, `lbo` is the step between the two core matrices along K (the
// 8-channel halves), `sbo` the step between core matrices along M or N
// (8 rows).  The start address counts 16-byte units, so any 16-byte
// aligned start is a valid window.
__device__ __forceinline__ uint64_t wg_desc(uint32_t saddr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// d (+)= A (64 x 16, bf16, shared) * B (16 x 96, bf16, shared), fp32 sums;
// d = A * B where `fresh`.  Thread t of the warpgroup holds, in d[4j + e],
// row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2) and column 8j + 2 (t % 4) +
// e % 2 of the 64 x 96 result.
__device__ __forceinline__ void wgmma_m64n96(float (&d)[48], uint64_t da,
                                             uint64_t db, bool fresh) {
  asm volatile(
      "{\n .reg .pred p;\n setp.eq.u32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"((uint32_t)fresh));
}

// The stored pixel slot of halo pixel (lr, lc): stride 1 row-major over
// (TH + 2) x 66; stride 2 its (row, column) parity plane's.
template <int S, typename G>
__device__ __forceinline__ int slot(int lr, int lc) {
  if constexpr (S == 1) return lr * G::PW + lc;
  return (((lr & 1) * 2 + (lc & 1)) * G::PH + (lr >> 1)) * G::PW + (lc >> 1);
}
// Pixel of a lane's 8-pixel vector in element e of its pair `pi`: stride
// 1 (2pi, 2pi + 1); stride 2 the pairs of one column parity, (0, 2), (4,
// 6), (1, 3), (5, 7), consecutive in their planes.
template <int S>
__device__ __forceinline__ int pair_px(int pi, int e) {
  return S == 1 ? 2 * pi + e : (pi & 1) * 4 + (pi >> 1) + 2 * e;
}
// The shared-memory byte offset of tap (dy, dx)'s window for output row
// `oyl` of the tile: 64 consecutive pixels of one plane.
template <int S, typename G>
__device__ __forceinline__ uint32_t tap_off(int oyl, int dy, int dx) {
  if constexpr (S == 1) return (uint32_t)(((oyl + dy) * G::PW + dx) * 16);
  return (uint32_t)(((((dy & 1) * 2 + (dx & 1)) * G::PH + oyl + (dy >> 1)) *
                         G::PW +
                     (dx >> 1)) *
                    16);
}

// bf16x2 arithmetic, each op rounded to bf16 once: the same values as
// `prep_bf16`'s fp32 op then bf16 rounding, since double rounding through
// fp32 (24 bits) is innocuous for a result of 8 bits (24 >= 2 * 8 + 2).
__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
// max(v, 0) keeping NaN (torch.relu), two halves (-0 becomes +0, which no
// product or sum of the conv can tell apart).
__device__ __forceinline__ uint32_t relu2(uint32_t a) {
  uint32_t d;
  asm("max.NaN.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(0u));
  return d;
}
// Two fp32 values rounded to bf16, as one bf16x2 (lo, hi).
__device__ __forceinline__ uint32_t bf2(float lo, float hi) {
  return (__float_as_uint(rbf(lo)) >> 16) |
         (__float_as_uint(rbf(hi)) & 0xFFFF0000u);
}
// The prep of two raw bf16 inputs x (and residuals r) with the affines
// s, t (rs, rt) cast to bf16: kNone x; kPrep relu(x*s + t); kResProj
// relu((r*rs + rt) + relu(x*s + t)).
template <int MODE>
__device__ __forceinline__ uint32_t prep2(uint32_t x, uint32_t r, uint32_t s,
                                          uint32_t t, uint32_t rs,
                                          uint32_t rt) {
  if constexpr (MODE == kNone) return x;
  uint32_t v = relu2(add2(mul2(x, s), t));
  if constexpr (MODE == kResProj) v = relu2(add2(add2(mul2(r, rs), rt), v));
  return v;
}

template <int S, int MODE, bool PROJ, int NK>
__global__ void __launch_bounds__(kThreads, 1)
enc_conv_wg_kernel(const Args a) {
  using G = WgGeo<S, PROJ, NK>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, wg = tid >> 7;
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t sw = sbase, sst = sbase + G::kFixed;  // weights, stages
  const uint32_t bar = sbase + G::kBar;  // full[kStages], empty, weights
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (G::kStages + s); };
  const uint32_t wbar = bar + 16 * G::kStages;
  if (tid == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(full(s), 128);
      mbar_init(empty(s), 256);
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg < kProducers) {
    // ------------------------------------------------------ producers
    // Producer warpgroup wg fills the stages it = wg, wg + kProducers,
    // ...: one fills while the other's loads are in flight.
    set_regs_dec<prod_regs(MODE)>();
    const int pt = tid - 128 * wg, lane = tid & 31, warp = pt >> 5,
              q = lane & 3;
    if (tid == 0) {
      const int blk = G::kTaps * kBlk;
      mbar_expect_tx(wbar, a.nk * blk);
      for (int k = 0; k < a.nk; ++k)
        bulk_copy(sw + k * blk, a.w + (long)k * blk / 2, blk, wbar);
    }
    // Unit i of this warp: (halo row lr, channel half h, 32-pixel chunk
    // uc); its lane holds channel 8h + lane / 4 of the k-step and pixels
    // 8 (lane % 4) .. + 7 of the chunk.  The index is opaque to the
    // compiler, so that it recomputes the unit's indices each stage
    // instead of holding them through the loop (which spilled).
    auto unit = [&](int i, int& lr, int& h, int& uc) {
      int un = warp + 4 * i;
      asm volatile("" : "+r"(un));
      lr = un / (2 * G::UPR);
      h = (un / G::UPR) & 1;
      uc = un % G::UPR;
    };
    // Edge item pt < NE: (halo row, channel half, side), 8 channels of
    // one pixel.
    auto edge = [&](int& lr, int& h, int& lc) {
      lr = pt / (2 * G::NSIDE);
      h = (pt / G::NSIDE) & 1;
      lc = pt % G::NSIDE ? kTW + 1 : 0;
    };
    int it = 0;
    for (int t = blockIdx.x; t < a.total; t += gridDim.x) {
      const int b = t / a.nb, rem = t - b * a.nb;
      const int ty = rem / a.tiles_w, tx = rem - ty * a.tiles_w;
      const int iy0 = ty * G::TH * S - 1, ix0 = tx * kTW * S - 1;
      for (int k = 0; k < a.nk; ++k, ++it) {
        if (it % kProducers != wg) continue;
        const int s = it % G::kStages;
        const uint32_t ph = (uint32_t)(it / G::kStages) & 1u;
        // ---- this stage's raw inputs into registers, before the wait
        uint4 rx[G::UPW], rr[MODE == kResProj ? G::UPW : 1];
#pragma unroll
        for (int i = 0; i < G::UPW; ++i) {
          int lr, h, uc;
          unit(i, lr, h, uc);
          const int c = k * kKC + 8 * h + (lane >> 2);
          const int gy = iy0 + lr, gx = ix0 + 1 + 32 * uc + 8 * q;
          const bool in = gy >= 0 && gy < a.h && c < a.cin;
          const long off = ((long)(b * a.cin + c) * a.h + gy) * a.win + gx;
          rx[i] = make_uint4(0u, 0u, 0u, 0u);
          if constexpr (MODE == kResProj) rr[i] = rx[i];
          if (a.vin) {
            if (in && gx < a.win) {
              rx[i] = __ldg(reinterpret_cast<const uint4*>(a.x + off));
              if constexpr (MODE == kResProj)
                rr[i] = __ldg(reinterpret_cast<const uint4*>(a.r + off));
            }
          } else if (in) {
            uint32_t xw[4] = {0u, 0u, 0u, 0u}, rw[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (gx + e < a.win) {
                xw[e / 2] |= (uint32_t)__ldg(a.x + off + e) << (16 * (e & 1));
                if constexpr (MODE == kResProj)
                  rw[e / 2] |= (uint32_t)__ldg(a.r + off + e)
                               << (16 * (e & 1));
              }
            rx[i] = make_uint4(xw[0], xw[1], xw[2], xw[3]);
            if constexpr (MODE == kResProj)
              rr[i] = make_uint4(rw[0], rw[1], rw[2], rw[3]);
          }
        }
        uint32_t ex[4] = {0u, 0u, 0u, 0u}, er[4] = {0u, 0u, 0u, 0u};
        if (pt < G::NE) {
          int lr, h, lc;
          edge(lr, h, lc);
          const int gy = iy0 + lr, gx = ix0 + lc;
          if (gy >= 0 && gy < a.h && gx >= 0 && gx < a.win) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int c = k * kKC + 8 * h + e;
              if (c < a.cin) {
                const long off =
                    ((long)(b * a.cin + c) * a.h + gy) * a.win + gx;
                ex[e / 2] |= (uint32_t)__ldg(a.x + off) << (16 * (e & 1));
                if constexpr (MODE == kResProj)
                  er[e / 2] |= (uint32_t)__ldg(a.r + off) << (16 * (e & 1));
              }
            }
          }
        }
        mbar_wait(empty(s), ph ^ 1u);
        const uint32_t stg = sst + s * G::kStage;
        if (pt < G::NE) {  // the halo's edge columns first: ex, er die
          int lr, h, lc;
          edge(lr, h, lc);
          const int gy = iy0 + lr, gx = ix0 + lc;
          const bool in = gy >= 0 && gy < a.h && gx >= 0 && gx < a.win;
          uint32_t v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c0 = k * kKC + 8 * h + 2 * e;
            uint32_t s2 = 0u, t2 = 0u, rs2 = 0u, rt2 = 0u;
            if constexpr (MODE != kNone) {
              const int p0 = in && c0 < a.cin ? b * a.cin + c0 : 0;
              const int p1 = in && c0 + 1 < a.cin ? b * a.cin + c0 + 1 : 0;
              s2 = bf2(__ldg(a.xs + p0), __ldg(a.xs + p1));
              t2 = bf2(__ldg(a.xt + p0), __ldg(a.xt + p1));
              if constexpr (MODE == kResProj) {
                rs2 = bf2(__ldg(a.rs + p0), __ldg(a.rs + p1));
                rt2 = bf2(__ldg(a.rt + p0), __ldg(a.rt + p1));
              }
            }
            const uint32_t keep = (in && c0 < a.cin ? 0x0000FFFFu : 0u) |
                                  (in && c0 + 1 < a.cin ? 0xFFFF0000u : 0u);
            v[e] = prep2<MODE>(ex[e], er[e], s2, t2, rs2, rt2) & keep;
          }
          st_shared_v4(stg + h * G::kHalf + slot<S, G>(lr, lc) * 16, v[0],
                       v[1], v[2], v[3]);
        }
        // ---- prep, mask (zero outside the image or past Cin AFTER the
        // prep), transpose into pixel rows
#pragma unroll
        for (int i = 0; i < G::UPW; ++i) {
          int lr, h, uc;
          unit(i, lr, h, uc);
          const int c = k * kKC + 8 * h + (lane >> 2);
          const int gy = iy0 + lr, gx = ix0 + 1 + 32 * uc + 8 * q;
          const bool in = gy >= 0 && gy < a.h && c < a.cin;
          uint32_t s2 = 0u, t2 = 0u, rs2 = 0u, rt2 = 0u;
          if constexpr (MODE != kNone) {
            const int plane = in ? b * a.cin + c : 0;
            s2 = bf2(__ldg(a.xs + plane), __ldg(a.xs + plane));
            t2 = bf2(__ldg(a.xt + plane), __ldg(a.xt + plane));
            if constexpr (MODE == kResProj) {
              rs2 = bf2(__ldg(a.rs + plane), __ldg(a.rs + plane));
              rt2 = bf2(__ldg(a.rt + plane), __ldg(a.rt + plane));
            }
          }
          const uint32_t xw[4] = {rx[i].x, rx[i].y, rx[i].z, rx[i].w};
          uint32_t rw[4] = {0u, 0u, 0u, 0u};
          if constexpr (MODE == kResProj)
            rw[0] = rr[i].x, rw[1] = rr[i].y, rw[2] = rr[i].z, rw[3] = rr[i].w;
          uint32_t v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t keep =
                (in && gx + 2 * e < a.win ? 0x0000FFFFu : 0u) |
                (in && gx + 2 * e + 1 < a.win ? 0xFFFF0000u : 0u);
            v[e] = prep2<MODE>(xw[e], rw[e], s2, t2, rs2, rt2) & keep;
          }
          // pair pi of the lane's 8 pixels: stride 1 (2pi, 2pi + 1), a
          // word; stride 2 (0, 2), (4, 6), (1, 3), (5, 7)
          uint32_t p[4] = {v[0], v[1], v[2], v[3]};
          if constexpr (S == 2) {
            p[0] = __byte_perm(v[0], v[1], 0x5410);
            p[1] = __byte_perm(v[2], v[3], 0x5410);
            p[2] = __byte_perm(v[0], v[1], 0x7632);
            p[3] = __byte_perm(v[2], v[3], 0x7632);
          }
          // register i <- pair (i + lane % 4) % 4
          if (q & 1) {
            const uint32_t t0 = p[0];
            p[0] = p[1], p[1] = p[2], p[2] = p[3], p[3] = t0;
          }
          if (q & 2) {
            uint32_t t0 = p[0], t1 = p[1];
            p[0] = p[2], p[1] = p[3], p[2] = t0, p[3] = t1;
          }
          // lane 8m + j addresses matrix m's row j: pixel pair_px(pi, j %
          // 2) of lane (j / 2)'s vector, pi = (m + j / 2) % 4
          const int mi = lane >> 3, j = lane & 7, pi = (mi + (j >> 1)) & 3;
          const int lc = 32 * uc + 8 * (j >> 1) + pair_px<S>(pi, j & 1) + 1;
          stmatrix_x4_trans(stg + h * G::kHalf + slot<S, G>(lr, lc) * 16,
                            p[0], p[1], p[2], p[3]);
        }
        fence_async_shared();
        mbar_arrive(full(s));
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    set_regs_inc<cons_regs(MODE)>();
    const int c = wg - kProducers, ct = tid - 128 * wg;
    const int w4 = ct >> 5, lane = ct & 31, g = lane >> 2, q = lane & 3;
    const uint64_t adesc = wg_desc(sst, G::kHalf, 128);
    const uint64_t bdesc = wg_desc(sw, kN * 16, 128);
    unsigned char* stage_out = smem + G::kW + c * G::kOut;  // staging
    float acc[G::MR][48], accp[48];  // accp: the projection (row 15)
    mbar_wait(wbar, 0);
    int it = 0;
    for (int t = blockIdx.x; t < a.total; t += gridDim.x) {
      const int b = t / a.nb, rem = t - b * a.nb;
      const int ty = rem / a.tiles_w, tx = rem - ty * a.tiles_w;
      const int oy0 = ty * G::TH, ox0 = tx * kTW;
      int prev = 0;
      for (int k = 0; k < a.nk; ++k, ++it) {
        const int s = it % G::kStages;
        mbar_wait(full(s), (uint32_t)(it / G::kStages) & 1u);
#pragma unroll
        for (int i = 0; i < G::MR; ++i) fence_acc(acc[i]);
        if constexpr (PROJ) fence_acc(accp);
        wg_fence();
        const uint64_t as = adesc + (uint64_t)((s * G::kStage) >> 4);
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const uint64_t db =
              bdesc + (uint64_t)(((k * G::kTaps + tap) * kBlk) >> 4);
#pragma unroll
          for (int i = 0; i < G::MR; ++i)
            wgmma_m64n96(
                acc[i],
                as + (tap_off<S, G>(c * G::MR + i, tap / 3, tap % 3) >> 4),
                db, k == 0 && tap == 0);
        }
        if constexpr (PROJ)  // the 1x1 projection on the centre tap
          wgmma_m64n96(accp, as + (tap_off<S, G>(c, 1, 1) >> 4),
                       bdesc + (uint64_t)(((k * G::kTaps + 9) * kBlk) >> 4),
                       k == 0);
        wg_commit();
        wg_wait<1>();
        if (k > 0) mbar_arrive(empty(prev));
        prev = s;
      }
      wg_wait<0>();
#pragma unroll
      for (int i = 0; i < G::MR; ++i) fence_acc(acc[i]);
      if constexpr (PROJ) fence_acc(accp);
      mbar_arrive(empty(prev));

      // ---- epilogue of output o (0: the conv, 1: the projection): the
      // tile's partial sums first (the staging area as their scratch),
      // then the bf16 output through the staging area, a row at a time
      const int ch = (PROJ ? 2 : 1) * kN;
#pragma unroll
      for (int o = 0; o < (PROJ ? 2 : 1); ++o) {
        const __nv_bfloat16* bias = o ? a.bp : a.bias;
        __nv_bfloat16* out = o ? a.yp : a.y;
        if (a.partials != nullptr) {
          float* red = reinterpret_cast<float*>(stage_out);
          // four passes of 3 n8 blocks: this lane's fp32 sums of its valid
          // pixels, v[2 cp + kind] for channel 8 (3p + cp / 2) + 2 (lane %
          // 4) + cp % 2, then the 8 lanes of a channel (lane / 4)
          // reduce-scatter them in a fixed order (12 shuffles a pass)
#pragma unroll
          for (int pp = 0; pp < 4; ++pp) {
            float v[12];
#pragma unroll
            for (int jj = 0; jj < 3; ++jj)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int j = 3 * pp + jj;
                const float bv = __bfloat162float(bias[8 * j + 2 * q + e]);
                float s1 = 0.f, s2 = 0.f;
#pragma unroll
                for (int i = 0; i < G::MR; ++i)
#pragma unroll
                  for (int hh = 0; hh < 2; ++hh) {
                    const int m = 16 * w4 + g + 8 * hh;
                    const float y = (o ? accp[4 * j + 2 * hh + e]
                                       : acc[i][4 * j + 2 * hh + e]) +
                                    bv;
                    if (oy0 + c * G::MR + i < a.ho && ox0 + m < a.wo) {
                      s1 += y;
                      s2 = fmaf(y, y, s2);
                    }
                  }
                v[2 * (2 * jj + e)] = s1;
                v[2 * (2 * jj + e) + 1] = s2;
              }
#pragma unroll
            for (int st = 0; st < 2; ++st) {  // lane bits 4, 3: keep a half
              const int half = 6 >> st, mask = 16 >> st;
              const bool upper = lane & mask;
#pragma unroll
              for (int i = 0; i < half; ++i) {
                const float send = upper ? v[i] : v[i + half];
                const float keep = upper ? v[i + half] : v[i];
                v[i] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
              }
            }
#pragma unroll
            for (int i = 0; i < 3; ++i)  // lane bit 2: both keep the sum
              v[i] += __shfl_xor_sync(0xffffffffu, v[i], 4);
            if ((lane & 4) == 0) {
              const int base = ((lane >> 4) & 1) * 6 + ((lane >> 3) & 1) * 3;
#pragma unroll
              for (int i = 0; i < 3; ++i) {
                const int idx = base + i, cp = idx >> 1;
                red[(w4 * 2 + (idx & 1)) * kN + 8 * (3 * pp + (cp >> 1)) +
                    2 * q + (cp & 1)] = v[i];
              }
            }
          }
          named_bar(3, 256);
          for (int idx = c * 128 + ct; idx < 2 * kN; idx += 256) {
            const int kind = idx / kN, n = idx - kind * kN;
            float sum = 0.f;  // the 8 warps in order
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const float* rd =
                  reinterpret_cast<const float*>(smem + G::kW + cc * G::kOut);
#pragma unroll
              for (int w = 0; w < 4; ++w) {
                const float v = rd[(w * 2 + kind) * kN + n];
                sum = cc == 0 && w == 0 ? v : sum + v;
              }
            }
            a.partials[((long)t * 2 + kind) * ch + o * kN + n] = sum;
          }
          named_bar(3, 256);
        }
#pragma unroll
        for (int i = 0; i < G::MR; ++i) {
          const int oy = oy0 + c * G::MR + i;
#pragma unroll
          for (int j = 0; j < 12; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = 8 * j + 2 * q + e;
              const float bv = __bfloat162float(bias[n]);
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const float v = (o ? accp[4 * j + 2 * hh + e]
                                   : acc[i][4 * j + 2 * hh + e]) +
                                bv;
                reinterpret_cast<__nv_bfloat16*>(stage_out + n * kOutPitch)
                    [16 * w4 + g + 8 * hh] = __float2bfloat16_rn(v);
              }
            }
          named_bar(1 + c, 128);
          if (oy < a.ho) {
            const long row = ((long)b * kN * a.ho + oy) * a.wo;
            for (int idx = ct; idx < kN * 8; idx += 128) {
              const int n = idx >> 3, ox = ox0 + 8 * (idx & 7);
              if (ox >= a.wo) continue;
              const unsigned char* src =
                  stage_out + n * kOutPitch + 16 * (idx & 7);
              __nv_bfloat16* dst = out + row + (long)n * a.ho * a.wo + ox;
              if (a.vout) {
                *reinterpret_cast<uint4*>(dst) =
                    *reinterpret_cast<const uint4*>(src);
              } else {
                const __nv_bfloat16* sv =
                    reinterpret_cast<const __nv_bfloat16*>(src);
                for (int e = 0; e < 8 && ox + e < a.wo; ++e) dst[e] = sv[e];
              }
            }
          }
          named_bar(1 + c, 128);
        }
      }
    }
  }
}

template <int S, int MODE, bool PROJ, int NK>
int launch(const Args& a, int batch, float* stats, cudaStream_t st) {
  using G = WgGeo<S, PROJ, NK>;
  auto kernel = enc_conv_wg_kernel<S, MODE, PROJ, NK>;
  if (a.nk > NK) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int grid = a.total < sms ? a.total : sms;
  kernel<<<grid, kThreads, G::kSmem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || stats == nullptr) return (int)e;
  const int ch2 = 2 * (PROJ ? 2 : 1) * kN;
  const int total = batch * ch2;
  enc_conv_tc_stats_kernel<<<(total + 7) / 8, 256, 0, st>>>(
      a.partials, stats, a.nb, ch2, total);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ the probe

// One warpgroup: the A image (two planes of `plane` bytes, a pixel one
// 16-byte row of 8 channels in each) and one B block of the pack into
// shared memory, then one m64n96k16 product with A's window starting
// `shift` pixels into the planes; out (64, 96) fp32.
__global__ void __launch_bounds__(128)
enc_conv_wg_probe_kernel(const uint4* __restrict__ a_img,
                         const uint4* __restrict__ b_blk,
                         float* __restrict__ out, int plane, int shift) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const uint32_t sa = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t sb = sa + 2 * plane;
  uint4* s4 = reinterpret_cast<uint4*>(smem);
  for (int i = tid; i < 2 * plane / 16; i += 128) s4[i] = a_img[i];
  for (int i = tid; i < kBlk / 16; i += 128) s4[2 * plane / 16 + i] = b_blk[i];
  fence_async_shared();
  __syncthreads();
  float d[48];
#pragma unroll
  for (int i = 0; i < 48; ++i) d[i] = 0.f;
  fence_acc(d);
  wg_fence();
  wgmma_m64n96(d, wg_desc(sa + 16 * shift, plane, 128),
               wg_desc(sb, kN * 16, 128), true);
  wg_commit();
  wg_wait<0>();
  fence_acc(d);
  const int w = tid >> 5, l = tid & 31;
#pragma unroll
  for (int j = 0; j < 12; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[(16 * w + l / 4 + 8 * (e / 2)) * kN + 8 * j + 2 * (l % 4) + e % 2] =
          d[4 * j + e];
}

}  // namespace

// x, r (B, Cin, H, W) bf16; xs, xt, rs, rt (B, Cin) fp32; w the pack of
// ops/cuda_encoder.py `wg_pack` (the projection's as its tenth tap with
// `stride` 2); bias, bp (96) bf16; y, yp (B, 96, Ho, Wo) bf16, Ho = (H -
// 1)/stride + 1 (and Wo alike); partials (B, nb, 2, CH) and stats (B, 2,
// CH) fp32, both null without statistics, CH = 96 (192 with the
// projection, its channels last); nb = ceil(Ho / TH) * ceil(Wo / 64), TH
// 4 at stride 1 and 2 at stride 2.  All contiguous.  Supported: stride 1
// with mode prep or res_proj and Cin <= 96; stride 2 with mode none, the
// projection and Cin <= 64; Cout 96.  Returns the CUDA error code of the
// launches (0 on success).
extern "C" int enc_conv_wg_forward(
    const void* x, const float* xs, const float* xt, const void* r,
    const float* rs, const float* rt, const void* w, const void* bias,
    const void* bp, void* y, void* yp, float* partials, float* stats,
    int batch, int cin, int h, int win, int cout, int stride, int mode,
    int nb, void* stream) {
  const bool proj = bp != nullptr;
  if (stride != 1 && stride != 2) return (int)cudaErrorInvalidValue;
  const int th = stride == 1 ? 4 : 2;
  const int ho = (h - 1) / stride + 1, wo = (win - 1) / stride + 1;
  const int tiles_w = (wo + kTW - 1) / kTW;
  if (batch < 1 || cin < 1 || h < 1 || win < 1 || cout != kN ||
      nb != ((ho + th - 1) / th) * tiles_w ||
      (stats == nullptr) != (partials == nullptr) || proj != (stride == 2))
    return (int)cudaErrorInvalidValue;
  auto al16 = [](const void* p) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const Args a{static_cast<const unsigned short*>(x), xs, xt,
               static_cast<const unsigned short*>(r), rs, rt,
               static_cast<const unsigned short*>(w),
               static_cast<const __nv_bfloat16*>(bias),
               static_cast<const __nv_bfloat16*>(bp),
               static_cast<__nv_bfloat16*>(y), static_cast<__nv_bfloat16*>(yp),
               partials, cin, h, win, ho, wo, tiles_w, nb, batch * nb,
               (cin + kKC - 1) / kKC,
               (int)(win % 8 == 0 && al16(x) && al16(r)),
               (int)(wo % 8 == 0 && al16(y) && al16(yp))};
  if (!al16(w)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stride == 1 && mode == kPrep)
    return launch<1, kPrep, false, 6>(a, batch, stats, s);
  if (stride == 1 && mode == kResProj)
    return launch<1, kResProj, false, 6>(a, batch, stats, s);
  if (stride == 2 && mode == kNone)
    return launch<2, kNone, true, 4>(a, batch, stats, s);
  return (int)cudaErrorInvalidValue;
}

// The shifted-window descriptor unit: a_img (2 * plane bytes), b_blk (one
// (k-step, tap) block of `wg_pack`, 3072 bytes), out (64, 96) fp32;
// returns the CUDA error code of the launch.
extern "C" int enc_conv_wg_probe(const void* a_img, const void* b_blk,
                                 float* out, int plane, int shift,
                                 void* stream) {
  if (plane % 16 != 0 || shift < 0 || (shift + 64) * 16 > plane)
    return (int)cudaErrorInvalidValue;
  const int smem = 2 * plane + kBlk;
  cudaError_t e = cudaFuncSetAttribute(
      enc_conv_wg_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  enc_conv_wg_probe_kernel<<<1, 128, smem, static_cast<cudaStream_t>(
                                               stream)>>>(
      static_cast<const uint4*>(a_img), static_cast<const uint4*>(b_blk), out,
      plane, shift);
  return (int)cudaGetLastError();
}
