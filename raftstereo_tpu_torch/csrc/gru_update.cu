// Fused finest-level GRU update for Hopper (sm_90a), fp32 or bf16, NHWC.
//
// Replaces the TPU kernel raftstereo_tpu/ops/pallas_gru.py
// `_gru_update_kernel`, launched from `_fused_forward`.  Function (the
// same as `_xla_reference_update` there), per pixel of the finest level:
//   c1  = relu(conv1x1(corr) + bc1)                       64 channels
//   cor = relu(conv3x3(c1) + bc2)                         64
//   f1  = relu(conv7x7(disp) + bf1)                       64 (x-flow only)
//   flo = relu(conv3x3(f1) + bf2)                         64
//   me  = relu(conv3x3(cor) + conv3x3(flo) + bme)         126
//   motion features mf = [me, disp, 0]                    128
//   zr  = conv3x3([h | mf | ext]) + bzr                   2*hd
//   z = sigmoid(zr[:hd] + cz), r = sigmoid(zr[hd:] + cr)
//   q   = tanh(conv3x3([r*h | mf | ext]) + bq + cq)
//   h'  = (1 - z) * h + z * q
//   delta = conv3x3(relu(conv3x3(h') + bfh1)) + bfh2      2
// All convs are zero-padded ("SAME"), so every intermediate is exactly 0
// outside the image.
//
// The bf16 form (`gru_update_forward_bf16`) takes bf16 activations,
// weights and biases and rounds where the JAX kernel casts to the compute
// dtype: each conv is an fp32 sum of exact products of bf16 values plus
// the bias, rounded once to bf16 (`_conv3(...).astype(ct)`, then relu);
// the disparity enters rounded to bf16; z, r, q and h' round after every
// elementwise operation, as the JAX kernel's bf16 arithmetic does (the
// sigmoid too: XLA computes it as 1 / (1 + exp(-v)) in bf16); delta is
// bf16.  The [h | mf | ext] concatenations never exist: each gate conv
// reads its operands in turn, the in-kernel form of models/update.py
// `_sliced_conv`.
//
// Design.  Nine launches per update in either form (up to twelve at
// ragged widths, below).  The six convs with at least 64 outputs (c2,
// f2, me, zr, q, fh1: over 99% of the multiply-adds) are one
// implicit-GEMM kernel on the tensor cores, `gru_mma_conv_kernel`:
// pixels x output channels, with the reduction K ordered (operand, tap,
// 128-byte channel chunk), so one pipeline stage is one tap of one
// operand.  A block covers TH x 16 pixels of one image, so a stage's A
// tile is one TMA box of the operand shifted by the tap: per stage one
// thread issues a 4-D box (a chunk of channels x 16 x TH x 1 of the NHWC
// operand) and a 3-D box of the weights (the chunk's K columns x BN
// outputs x the fp32 planes), both completing one mbarrier.  Taps
// outside the image, channels past an operand's width and outputs past N
// arrive as zeros (TMA's out-of-bounds fill): no element is branched on
// and no thread computes a source address.  The ring holds 4 stages
// where two blocks still fit on an SM, else 3, in dynamic shared memory
// with TMA's 128-byte swizzle, which is also the layout that keeps
// `ldmatrix` free of bank conflicts.  TMA replaced a form fed by
// `cp.async.cg`, whose threads each computed a source address and a
// predicate per 16 bytes copied (the two are compared in PERF.md §6).
// TMA takes rows of whole 16-byte units: where hd is not a multiple of 4
// (fp32) or 8 (bf16) channels, `pad_rows_kernel` copies h (with ext)
// before the zr conv, r*h after it and h' after the q conv into the
// workspace at the width rounded up (three launches more; one where only
// ext_dim is ragged); the padding is never read (TMA zero-fills past the
// operand's width).  The epilogues keep their rows at hd: writing them at
// the rounded stride instead slowed the fp32 update by 17% at 144x240
// (PERF.md §6).
// Four warps each own a (16*MT) x (8*NT) tile of fp32 accumulators: NT 8
// for bf16 where N > 64, else 4; MT 3 or 4, picked per launch from the
// tile count, the SM count and the instance's resident blocks, so that
// the biggest convs lose the least to their last wave.  A build with MT
// 3 alone ran the fp32 update 8% slower at 144x240 and 96x312 (bf16 the
// same), although at 144x240 the picker too launches MT 3 for every
// conv; why is not known (PERF.md §6), but the picker stays for it.
// Each stage's four k-steps sum into
// a fresh mma accumulator per n-tile, added to the total by one fp32
// add: the tensor cores add into their accumulator with truncation,
// which over a K of thousands drifted by ~2e-4 of O(1) outputs, past the
// fp32 tolerance.  Every output sums its products in one fixed order (no
// atomics, no split of K), whatever the tile.
//   - bf16: `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32` with
//     `ldmatrix` fragments.  Products of bf16 values are exact in fp32,
//     so this is the JAX kernel's sum before its one rounding to bf16.
//   - fp32: 3xTF32.  Each operand x splits into hi = cvt.rna.tf32(x) and
//     lo = cvt.rna.tf32(x - hi); `mma.sync.aligned.m16n8k8.row.col.f32.
//     tf32.tf32.f32` accumulates a_lo*b_hi + a_hi*b_lo + a_hi*b_hi.  The
//     weights come split from the pack (ops/cuda_gru.py); the
//     activations split as their fragments are loaded.  This keeps fp32
//     accuracy (the dropped lo*lo term is ~2^-22 of each product); a
//     single TF32 pass would not (about 3e-4 off on a gate conv, 7e-4 on
//     an update, emulated on the CPU) and is not used.
// `mma.sync` was taken over `wgmma`: its fragment layouts are the ones
// the CPU tests emulate, per warp and per k-step; `wgmma` (64-row
// warpgroup tiles read from shared memory, asynchronous, no `ldmatrix`)
// is the next step.
// The epilogues are fused: bias + relu; for `me` the motion features
// (126 outputs, then the disparity in channel 126, rounded to bf16 in
// the bf16 form, and 0 in channel 127); for zr the gates z and r*h
// (r = sigmoid(zr[hd:] + cr) never leaves registers); for q the GRU
// blend into h'.  c1 (K = corr channels) and f1 (the 1-channel 7x7
// disparity conv), under 1% of the work, run on a small SIMT kernel,
// `gru_simt_conv_kernel`; the 2-output flow-head conv, which would waste
// most of a tensor-core tile, on `conv3x3_few_out_kernel` (one warp per
// pixel).  Intermediates live in a workspace in device memory (~1 KB a
// pixel, mostly re-read from L2); keeping them on chip, as the TPU
// kernel does in VMEM, is not the lever here.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 and 495 TF32 dense on the
// tensor cores, 67 TFLOP/s fp32 on the CUDA cores, 3.35 TB/s): at
// 144x240 with hd=128 the update is 127.7 GFLOP (zr 61, q 31, fh1 20,
// motion convs 16) against about 130 MB of inputs and outputs, so it is
// bound by operations: bf16 0.13 ms on the tensor cores; fp32 as 3xTF32
// three TF32 passes, 0.77 ms (1.9 ms on the CUDA cores).  What holds
// each form back from that: `mma.sync` issues from the warps at a
// fraction of `wgmma`'s rate; in fp32 splitting each A fragment takes
// three instructions per element, as many issue slots as the products
// it feeds at NT = 4; in bf16 the 255 registers of a 64x64 warp tile
// allow two blocks of four warps per SM, and every block re-reads its
// whole K x BN weight slice from L2 (TMA multicast across a cluster
// would share it).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRowBytes = 128;  // bytes of K per shared row and stage
constexpr int kSteps = kRowBytes / 32;  // mma k-steps per stage
constexpr int kTileW = 16;      // pixels per tile row
constexpr int kWarpsM = 2, kWarpsN = 2;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kMaxOps = 3;

enum Epilogue { kRelu = 0, kMotion = 1, kGates = 2, kGruBlend = 3 };

constexpr int kMotionCh = 64;  // convc1/convc2/convf1/convf2 widths
constexpr int kMe = 126;       // merge-conv outputs (128 minus the flow)
constexpr int kMf = 128;       // motion features [me, disp, 0]
constexpr int kHead = 256;     // flow-head hidden width
constexpr int kDelta = 2;      // flow-head outputs

__device__ __forceinline__ float ld(float v) { return v; }
__device__ __forceinline__ float ld(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// Rounds to bf16 and back: the bf16 form's rounding points.
__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// jnp.maximum(v, 0): keeps NaN.
__device__ __forceinline__ float relu_keep_nan(float v) {
  return v < 0.f ? 0.f : v;
}
__device__ __forceinline__ float sigmoidf_(float v) {
  return 1.f / (1.f + expf(-v));
}
// jax.nn.sigmoid of a bf16 value as XLA computes it: 1 / (1 + exp(-v))
// with every operation rounded to bf16.
__device__ __forceinline__ float sigmoid_bf16(float v) {
  return rnd(1.f / rnd(1.f + rnd(expf(-v))));
}

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
// Waits for the phase of parity `parity` of barrier `bar` to complete.  A
// copy that never lands traps (an error the caller sees) instead of
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
// TMA: a box of `map` at the given coordinates (innermost first) into
// shared memory at `dst`, completing `bytes` of barrier `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3,
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}
// d = a * b + 0 (a fresh partial sum; see the promotion note in the
// kernel) or d += a * b.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1, bool fresh) {
  if (fresh)
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(0.f));
  else
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1, bool fresh) {
  if (fresh)
    asm(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(0.f));
  else
    asm(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// cvt.rna.tf32.f32: round to nearest on 10 mantissa bits, ties away
// from zero; the low 13 bits of the result are 0.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// Byte offset of 16-byte unit u (0..7) of row r in a stage's A or B
// block, as TMA's 128-byte swizzle lays it out: 128-byte rows, unit u
// stored at u ^ (r % 8), so the eight rows of one ldmatrix phase hit
// eight distinct 16-byte bank groups.
__device__ __forceinline__ uint32_t swz(int r, int u) {
  return (uint32_t)(r * kRowBytes + ((u ^ (r & 7)) << 4));
}

// ------------------------------------------------- tensor-core conv

template <typename T>
struct MmaParams {
  CUtensorMap amap[kMaxOps];  // operand o: (B, H, W, cin), box (chunk, 16, TH, 1)
  CUtensorMap wmap;           // (planes, N, K), box (chunk, BN, planes)
  const T* x[kMaxOps];        // the operands, NHWC (host side: maps)
  int cin[kMaxOps];           // channels
  int ld[kMaxOps];            // row stride, a multiple of 16 / sizeof(T)
  int nchunk[kMaxOps];        // 128-byte chunks per tap
  int nops;
  int total;       // stages: 9 * sum of nchunk
  const T* w;      // (N, total * 128 / sizeof(T)); fp32: (2, N, ...) hi, lo
  const T* bias;   // (N); kMotion: (126)
  int N;
  int B, H, W;
  int epi;
  T* y;            // kRelu, kMotion: (P, N); kGates: z; kGruBlend: h'
  T* y2;           // kGates: r*h
  const T* g1;     // kGates: cz; kGruBlend: cq
  const T* g2;     // kGates: cr; kGruBlend: z
  const T* h;      // kGates, kGruBlend: the hidden state (P, hd)
  const float* disp;  // kMotion: (P)
};

// The epilogue of output (m, n), fed the fp32 sum of its products.
template <typename T>
__device__ __forceinline__ void finish(const MmaParams<T>& p, long m, int n,
                                       float acc) {
  constexpr bool f32 = std::is_same<T, float>::value;
  if (p.epi == kMotion && n >= kMe) {  // mf's disparity and zero channels
    st(p.y + m * p.N + n,
       n == kMe ? (f32 ? p.disp[m] : rnd(p.disp[m])) : 0.f);
    return;
  }
  float v = acc + ld(p.bias[n]);
  if (!f32) v = rnd(v);
  if (p.epi == kRelu || p.epi == kMotion) {
    st(p.y + m * p.N + n, f32 ? fmaxf(v, 0.f) : relu_keep_nan(v));
  } else if (p.epi == kGates) {
    const int hd = p.N >> 1;
    if (n < hd) {
      const long e = m * hd + n;
      const float s = v + ld(p.g1[e]);
      st(p.y + e, f32 ? sigmoidf_(s) : sigmoid_bf16(rnd(s)));
    } else {
      const long e = m * hd + (n - hd);
      const float s = v + ld(p.g2[e]);
      const float r = f32 ? sigmoidf_(s) : sigmoid_bf16(rnd(s));
      st(p.y2 + e, r * ld(p.h[e]));
    }
  } else {  // kGruBlend
    const long e = m * p.N + n;
    const float z = ld(p.g2[e]);
    if constexpr (f32) {
      const float q = tanhf(v + p.g1[e]);
      v = (1.f - z) * p.h[e] + z * q;
    } else {
      const float q = rnd(tanhf(rnd(v + ld(p.g1[e]))));
      v = rnd(rnd(rnd(1.f - z) * ld(p.h[e])) + rnd(z * q));
    }
    st(p.y + e, v);
  }
}

// A block's tile: TH x 16 pixels of one image (BM = 32 * MT) by BN
// outputs; its shared memory, a ring of kStages (A | B planes) stages
// (4 where two blocks still fit on an SM, else 3), each block aligned to
// 1024 bytes (TMA's 128-byte swizzle), then one mbarrier per stage.
template <typename T, int MT, int NT>
struct Tile {
  static constexpr int BM = kWarpsM * 16 * MT;
  static constexpr int BN = kWarpsN * 8 * NT;
  static constexpr int TH = BM / kTileW;
  static constexpr int kPlanes = std::is_same<T, float>::value ? 2 : 1;
  static constexpr int kABytes = BM * kRowBytes;
  static constexpr int kBBytes = BN * kRowBytes;
  static constexpr int kStageBytes = kABytes + kPlanes * kBBytes;
  static constexpr int kStages = kStageBytes <= 28 * 1024 ? 4 : 3;  // ring
  static constexpr int kSmem = kStages * (kStageBytes + 8);
};

template <typename T, int MT, int NT>
__global__ void __launch_bounds__(kThreads)
gru_mma_conv_kernel(const __grid_constant__ MmaParams<T> p) {
  using TL = Tile<T, MT, NT>;
  constexpr bool f32 = std::is_same<T, float>::value;
  constexpr int EPS = kRowBytes / sizeof(T);  // channels per stage row
  static_assert(NT % 2 == 0, "B fragments load in pairs of n-tiles");
  static_assert(TL::kABytes % 1024 == 0 && TL::kBBytes % 1024 == 0,
                "swizzled blocks start on 1024-byte boundaries");
  extern __shared__ __align__(1024) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  constexpr int kStages = TL::kStages;
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  if (sbase & 1023u) __trap();  // the swizzle needs 1024-byte alignment
  const uint32_t bars = sbase + kStages * TL::kStageBytes;
  const int tiles_x = (p.W + kTileW - 1) / kTileW;
  const int tiles_y = (p.H + TL::TH - 1) / TL::TH;
  const int x0 = (blockIdx.x % tiles_x) * kTileW;
  const int y0 = (blockIdx.x / tiles_x % tiles_y) * TL::TH;
  const int b = blockIdx.x / tiles_x / tiles_y;
  const int n0 = blockIdx.y * TL::BN;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0 copies: stage s is tap lt of chunk lc of operand lo, one TMA
  // box of the operand shifted by the tap (out-of-image pixels and
  // channels past the operand's width arrive as zeros) and one box of
  // the weights' K columns [s * EPS, (s + 1) * EPS).
  int lo = 0, lt = 0, lc = 0;
  auto issue = [&](int s) {
    const int buf = s % kStages;
    const uint32_t sa = sbase + buf * TL::kStageBytes, bar = bars + 8 * buf;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(bar, TL::kStageBytes);
    const CUtensorMap* am =
        lo == 0 ? &p.amap[0] : lo == 1 ? &p.amap[1] : &p.amap[2];
    tma_load_4d(sa, am, bar, lc * EPS, x0 + lt % 3 - 1, y0 + lt / 3 - 1, b);
    tma_load_3d(sa + TL::kABytes, &p.wmap, bar, s * EPS, n0, 0);
    const int nchunk =
        lo == 0 ? p.nchunk[0] : lo == 1 ? p.nchunk[1] : p.nchunk[2];
    if (++lc == nchunk) {
      lc = 0;
      if (++lt == 9) {
        lt = 0;
        ++lo;
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // Fragment rows and units of this lane (see the PTX fragment layouts:
  // A matrices (rows 0-7 | 8-15) x (k-half 0 | 1), B matrices n-tile
  // pairs x (k-half 0 | 1)).
  const int a_row = wm * 16 * MT + (lane & 7) + (((lane >> 3) & 1) << 3);
  const int a_u = lane >> 4;
  const int b_row = wn * 8 * NT + (lane & 7) + ((lane >> 4) << 3);
  const int b_u = (lane >> 3) & 1;

  if (tid == 0)
    for (int s = 0; s < kStages - 1 && s < p.total; ++s) issue(s);
  for (int s = 0; s < p.total; ++s) {
    mbar_wait(bars + 8 * (s % kStages), (s / kStages) & 1);
    __syncthreads();  // every warp is done with stage s-1's buffer
    if (tid == 0 && s + kStages - 1 < p.total) issue(s + kStages - 1);

    const uint32_t sa = sbase + (s % kStages) * TL::kStageBytes;
    const uint32_t sb = sa + TL::kABytes;
    // B fragments of the stage's 32-byte k-steps.
    uint32_t bf[kSteps][TL::kPlanes][NT][2];
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
      for (int pl = 0; pl < TL::kPlanes; ++pl)
#pragma unroll
        for (int j = 0; j < NT / 2; ++j)
          ldmatrix_x4(bf[kk][pl][2 * j][0], bf[kk][pl][2 * j][1],
                      bf[kk][pl][2 * j + 1][0], bf[kk][pl][2 * j + 1][1],
                      sb + pl * TL::kBBytes +
                          swz(b_row + 16 * j, 2 * kk + b_u));
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      // The stage's partial sums of row tile i, one per n-tile, each
      // then added into the total in fp32: the tensor cores add into
      // their accumulator with truncation, which over a K of thousands
      // drifts by ~1e-4 of the sum.  The NT chains are independent, so
      // their mma latencies overlap.
      float t[NT][4];
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t a[4], lo4[4];
        ldmatrix_x4(a[0], a[1], a[2], a[3],
                    sa + swz(a_row + 16 * i, 2 * kk + a_u));
        if constexpr (f32) {  // a = hi + lo, hi kept in a
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = __uint_as_float(a[e]);
            a[e] = tf32_rna(x);
            lo4[e] = tf32_rna(x - __uint_as_float(a[e]));
          }
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if constexpr (f32) {
            mma_tf32(t[j], lo4, bf[kk][0][j][0], bf[kk][0][j][1], kk == 0);
            mma_tf32(t[j], a, bf[kk][1][j][0], bf[kk][1][j][1], false);
            mma_tf32(t[j], a, bf[kk][0][j][0], bf[kk][0][j][1], false);
          } else {
            mma_bf16(t[j], a, bf[kk][0][j][0], bf[kk][0][j][1], kk == 0);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += t[j][e];
    }
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 16 * MT + 16 * i + g + 8 * half;
      const int y = y0 + r / kTileW, x = x0 + r % kTileW;
      if (y >= p.H || x >= p.W) continue;
      const long m = ((long)b * p.H + y) * p.W + x;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 8 * NT + 8 * j + 2 * t + e;
          if (n < p.N) finish(p, m, n, acc[i][j][2 * half + e]);
        }
    }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? (EncodeTiled)f : nullptr;
  }();
  return fn;
}

// Error codes of the host side, apart from CUDA's: no encoder in the
// driver; kEncodeError + the CUresult of a refused tensor map.
constexpr int kNoEncoder = 9999;
constexpr int kEncodeError = 10000;

// A rank-`rank` tensor map of T with 128-byte swizzle and zero fill.
template <typename T>
int encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
           const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled f = encoder();
  if (!f) return kNoEncoder;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r =
      f(map,
        std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
        (cuuint32_t)rank, const_cast<void*>(ptr), dims, strides, box, ones,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

// Blocks of one instance that fit on an SM, once per process.
template <typename T, int MT, int NT>
int resident_blocks() {
  static const int n = [] {
    int b = 0;
    cudaFuncSetAttribute(gru_mma_conv_kernel<T, MT, NT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         Tile<T, MT, NT>::kSmem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, gru_mma_conv_kernel<T, MT, NT>, kThreads, Tile<T, MT, NT>::kSmem);
    return b > 0 ? b : 1;
  }();
  return n;
}

template <typename T, int MT, int NT>
long tiles(const MmaParams<T>& p) {
  using TL = Tile<T, MT, NT>;
  return (long)p.B * ((p.H + TL::TH - 1) / TL::TH) *
         ((p.W + kTileW - 1) / kTileW) * ((p.N + TL::BN - 1) / TL::BN);
}

template <typename T, int MT, int NT>
int launch(MmaParams<T> p, cudaStream_t s) {
  using TL = Tile<T, MT, NT>;
  constexpr int EPS = kRowBytes / sizeof(T);
  constexpr long es = sizeof(T);
  int rc;
  for (int o = 0; o < p.nops; ++o) {
    const cuuint64_t dims[4] = {(cuuint64_t)p.cin[o], (cuuint64_t)p.W,
                                (cuuint64_t)p.H, (cuuint64_t)p.B};
    const cuuint64_t strides[3] = {(cuuint64_t)(p.ld[o] * es),
                                   (cuuint64_t)((long)p.W * p.ld[o] * es),
                                   (cuuint64_t)((long)p.H * p.W * p.ld[o] * es)};
    const cuuint32_t box[4] = {EPS, kTileW, TL::TH, 1};
    if ((rc = encode<T>(&p.amap[o], p.x[o], 4, dims, strides, box))) return rc;
  }
  const long nk = (long)p.total * EPS;
  const cuuint64_t dims[3] = {(cuuint64_t)nk, (cuuint64_t)p.N,
                              (cuuint64_t)TL::kPlanes};
  const cuuint64_t strides[2] = {(cuuint64_t)(nk * es),
                                 (cuuint64_t)(nk * p.N * es)};
  const cuuint32_t box[3] = {EPS, TL::BN, TL::kPlanes};
  if ((rc = encode<T>(&p.wmap, p.w, 3, dims, strides, box))) return rc;
  cudaFuncSetAttribute(gru_mma_conv_kernel<T, MT, NT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, TL::kSmem);
  const dim3 grid((unsigned)(tiles<T, MT, NT>(p) / ((p.N + TL::BN - 1) / TL::BN)),
                  (unsigned)((p.N + TL::BN - 1) / TL::BN));
  gru_mma_conv_kernel<T, MT, NT><<<grid, kThreads, TL::kSmem, s>>>(p);
  return (int)cudaGetLastError();
}

// Relative time of a launch at MT: the waves it needs at the SM's
// resident blocks, each wave as long as those blocks' rows (plus a fixed
// cost per tile), so a grid whose last wave is nearly empty loses.
template <typename T, int MT, int NT>
long wave_cost(const MmaParams<T>& p, int sms) {
  const long occ = resident_blocks<T, MT, NT>();
  const long slots = occ * sms;
  return (tiles<T, MT, NT>(p) + slots - 1) / slots * occ *
         (Tile<T, MT, NT>::BM + 16);
}

template <typename T, int NT>
int mma_conv_nt(const MmaParams<T>& p, int sms, cudaStream_t s) {
  if (wave_cost<T, 3, NT>(p, sms) < wave_cost<T, 4, NT>(p, sms))
    return launch<T, 3, NT>(p, s);
  return launch<T, 4, NT>(p, s);
}

// bf16 takes 128-output tiles where N allows; fp32 keeps 64, whose
// two planes of B fragments per k-step fit beside the accumulators.
template <typename T>
int mma_conv(MmaParams<T>& p, int sms, cudaStream_t s) {
  p.total = 0;
  for (int o = 0; o < p.nops; ++o) p.total += 9 * p.nchunk[o];
  if constexpr (std::is_same<T, float>::value)
    return mma_conv_nt<T, 4>(p, sms, s);
  else
    return p.N > 64 ? mma_conv_nt<T, 8>(p, sms, s)
                    : mma_conv_nt<T, 4>(p, sms, s);
}

template <typename T>
MmaParams<T> make(int B, int H, int W, const T* w, const T* bias, int N,
                  int epi, T* y) {
  MmaParams<T> p = {};
  p.B = B;
  p.H = H;
  p.W = W;
  p.w = w;
  p.bias = bias;
  p.N = N;
  p.epi = epi;
  p.y = y;
  return p;
}

// Adds operand x of cin channels, rows ld elements apart.
template <typename T>
void add(MmaParams<T>& p, const T* x, int cin, int ld) {
  const int eps = kRowBytes / (int)sizeof(T);
  p.x[p.nops] = x;
  p.cin[p.nops] = cin;
  p.ld[p.nops] = ld;
  p.nchunk[p.nops++] = (cin + eps - 1) / eps;
}

// ------------------------------------------------------ SIMT remainders

// c1 (1x1 over the correlation) and f1 (7x7 over the disparity) to 64
// channels, bias + relu: a block stages 32 pixels' K inputs and the
// (K, 64) weights in shared memory; thread (n, lane) sums pixels
// lane, lane + 4, ... for output n.  The bf16 form rounds its input to
// bf16 (a no-op for bf16 inputs; the disparity enters so rounded).
constexpr int kSimtPix = 32;

template <typename TI, typename T, int KS>
__global__ void __launch_bounds__(256)
gru_simt_conv_kernel(const TI* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ bias, T* __restrict__ y, int B,
                     int H, int W, int cin) {
  constexpr bool f32 = std::is_same<T, float>::value;
  extern __shared__ float sm[];
  const int K = KS * KS * cin;
  float* ws = sm;                  // (K, 64)
  float* xs = sm + K * kMotionCh;  // (kSimtPix, K)
  const long P = (long)B * H * W;
  const long m0 = (long)blockIdx.x * kSimtPix;
  for (int i = threadIdx.x; i < K * kMotionCh; i += blockDim.x)
    ws[i] = ld(w[i]);
  for (int i = threadIdx.x; i < kSimtPix * K; i += blockDim.x) {
    const int r = i / K, k = i - r * K;
    const long m = m0 + r;
    float v = 0.f;
    if (m < P) {
      const int tap = k / cin, ci = k - tap * cin;
      const int dy = tap / KS - KS / 2, dx = tap % KS - KS / 2;
      const int xx = (int)(m % W) + dx, yy = (int)((m / W) % H) + dy;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W)
        v = ld(x[(m + (long)dy * W + dx) * cin + ci]);
      if (!f32) v = rnd(v);
    }
    xs[i] = v;
  }
  __syncthreads();
  const int n = threadIdx.x & (kMotionCh - 1);
  const float b = ld(bias[n]);
  for (int r = threadIdx.x / kMotionCh; r < kSimtPix;
       r += blockDim.x / kMotionCh) {
    const long m = m0 + r;
    if (m >= P) break;
    float s = 0.f;
    for (int k = 0; k < K; ++k) s = fmaf(xs[r * K + k], ws[k * kMotionCh + n], s);
    const float v = s + b;
    st(y + m * kMotionCh + n, f32 ? fmaxf(v, 0.f) : relu_keep_nan(rnd(v)));
  }
}

template <typename TI, typename T, int KS>
int simt_conv(const TI* x, const T* w, const T* bias, T* y, int B, int H,
              int W, int cin, cudaStream_t s) {
  const long P = (long)B * H * W;
  const int K = KS * KS * cin;
  const size_t smem = sizeof(float) * (size_t)K * (kMotionCh + kSimtPix);
  cudaFuncSetAttribute(gru_simt_conv_kernel<TI, T, KS>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  gru_simt_conv_kernel<TI, T, KS>
      <<<(unsigned)((P + kSimtPix - 1) / kSimtPix), 256, smem, s>>>(
          x, w, bias, y, B, H, W, cin);
  return (int)cudaGetLastError();
}

// 3x3 SAME conv to CO (few) output channels: one warp per pixel, lanes
// split the input channels, weights in shared memory, shuffle reduction.
constexpr int kSmallWarps = 8;
constexpr int kSmallPixPerWarp = 8;

template <int CO, typename T>
__global__ void __launch_bounds__(32 * kSmallWarps)
conv3x3_few_out_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ bias, T* __restrict__ y, int B,
                       int H, int W, int cin) {
  extern __shared__ float ws[];  // (9*cin, CO)
  for (int i = threadIdx.x; i < 9 * cin * CO; i += blockDim.x)
    ws[i] = ld(w[i]);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long P = (long)B * H * W;
  const long base =
      ((long)blockIdx.x * kSmallWarps + (threadIdx.x >> 5)) * kSmallPixPerWarp;
  for (int r = 0; r < kSmallPixPerWarp; ++r) {
    const long m = base + r;
    if (m >= P) break;  // warp-uniform
    const int xx0 = (int)(m % W);
    const int yy0 = (int)((m / W) % H);
    const int bb = (int)(m / ((long)W * H));
    float s[CO];
#pragma unroll
    for (int o = 0; o < CO; ++o) s[o] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      const int yy = yy0 + tap / 3 - 1, xx = xx0 + tap % 3 - 1;
      if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
      const T* src = x + (((long)bb * H + yy) * W + xx) * cin;
      const float* wt = ws + tap * cin * CO;
      for (int c = lane; c < cin; c += 32) {
        const float v = ld(src[c]);
#pragma unroll
        for (int o = 0; o < CO; ++o) s[o] = fmaf(v, wt[c * CO + o], s[o]);
      }
    }
#pragma unroll
    for (int o = 0; o < CO; ++o) {
#pragma unroll
      for (int d = 16; d > 0; d >>= 1)
        s[o] += __shfl_xor_sync(0xffffffffu, s[o], d);
    }
    if (lane == 0) {
#pragma unroll
      for (int o = 0; o < CO; ++o) st(y + m * CO + o, s[o] + ld(bias[o]));
    }
  }
}

// Weight-pointer order of `w`, shared with ops/cuda_gru.py WEIGHT_ORDER.
enum {
  WC1, BC1, KC2, BC2, WF1, BF1, KF2, BF2, KME, BME, KZR, BZR, KQ, BQ, KFH1,
  BFH1, WFH2, BFH2
};

// Channels rounded up to whole 16-byte units: the row stride TMA takes.
template <typename T>
int padded(int c) {
  constexpr int u = 16 / (int)sizeof(T);
  return (c + u - 1) / u * u;
}

// Copies (P, ca) a into (P, lda) ap and (P, cb) b into (P, ldb) bp (cb 0
// for none), for operands whose rows are not whole 16-byte units.
template <typename T>
__global__ void __launch_bounds__(256)
pad_rows_kernel(const T* __restrict__ a, T* __restrict__ ap, int ca, int lda,
                const T* __restrict__ b, T* __restrict__ bp, int cb, int ldb,
                long P) {
  const long na = P * ca, n = na + P * cb;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    if (i < na)
      ap[i / ca * lda + i % ca] = a[i];
    else
      bp[(i - na) / cb * ldb + (i - na) % cb] = b[i - na];
  }
}

template <typename T>
int pad_rows(const T* a, T* ap, int ca, int lda, const T* b, T* bp, int cb,
             int ldb, long P, cudaStream_t s) {
  const long n = P * (ca + cb);
  const unsigned blocks = (unsigned)((n + 255) / 256 < 4096 ? (n + 255) / 256
                                                            : 4096);
  pad_rows_kernel<T><<<blocks, 256, 0, s>>>(a, ap, ca, lda, b, bp, cb, ldb, P);
  return (int)cudaGetLastError();
}

// Workspace elements (in T) of an update: c1/f1, cor, flo (64 each), mf
// (128), z and r*h (hd each, their slots rounded up to 16 bytes so that
// every slot starts on one), the flow-head hidden (256); where hd is
// ragged, h, r*h and h' at the rounded width, and where ext_dim is, ext.
template <typename T>
long workspace(long P, int hd, int ext_dim) {
  const int hdp = padded<T>(hd), extp = padded<T>(ext_dim);
  return P * (3 * kMotionCh + kMf + 2 * hdp + kHead +
              (hdp != hd ? 3 * hdp : 0) + (extp != ext_dim ? extp : 0));
}

template <typename T>
int forward(const T* h, const T* ext, const T* corr, const float* disp,
            const T* cz, const T* cr, const T* cq, const T* const* w, T* hn,
            T* delta, T* ws, int B, int H, int W, int hd, int ext_dim,
            int corr_ch, cudaStream_t s) {
  const long P = (long)B * H * W;
  if (P == 0) return 0;
  int dev = 0, sms = 0, rc;
  if ((rc = (int)cudaGetDevice(&dev))) return rc;
  if ((rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev)))
    return rc;
  const int hdp = padded<T>(hd), extp = padded<T>(ext_dim);
  T* c1 = ws;  // c1, then f1
  T* cor = c1 + P * kMotionCh;
  T* flo = cor + P * kMotionCh;
  T* mf = flo + P * kMotionCh;
  T* z = mf + P * kMf;
  T* rh = z + P * hdp;
  T* fh = rh + P * hdp;
  // The gate and head convs' operands: h, ext, r*h and h', or their
  // copies at the rounded width.
  T* pad = fh + P * kHead;
  T *hop = const_cast<T*>(h), *eop = const_cast<T*>(ext), *rhop = rh,
    *hnop = hn;
  if (hdp != hd) {
    hop = pad;
    rhop = hop + P * hdp;
    hnop = rhop + P * hdp;
    pad = hnop + P * hdp;
  }
  if (extp != ext_dim) eop = pad;
  if (hop != h || eop != ext)
    if ((rc = pad_rows(h, hop, hop != h ? hd : 0, hdp, ext, eop,
                       eop != ext ? ext_dim : 0, extp, P, s)))
      return rc;

  if ((rc = simt_conv<T, T, 1>(corr, w[WC1], w[BC1], c1, B, H, W, corr_ch,
                               s)))
    return rc;
  MmaParams<T> c2 = make(B, H, W, w[KC2], w[BC2], kMotionCh, kRelu, cor);
  add(c2, (const T*)c1, kMotionCh, kMotionCh);
  if ((rc = mma_conv(c2, sms, s))) return rc;
  if ((rc = simt_conv<float, T, 7>(disp, w[WF1], w[BF1], c1, B, H, W, 1, s)))
    return rc;
  MmaParams<T> f2 = make(B, H, W, w[KF2], w[BF2], kMotionCh, kRelu, flo);
  add(f2, (const T*)c1, kMotionCh, kMotionCh);
  if ((rc = mma_conv(f2, sms, s))) return rc;
  MmaParams<T> me = make(B, H, W, w[KME], w[BME], kMf, kMotion, mf);
  add(me, (const T*)cor, kMotionCh, kMotionCh);
  add(me, (const T*)flo, kMotionCh, kMotionCh);
  me.disp = disp;
  if ((rc = mma_conv(me, sms, s))) return rc;

  MmaParams<T> g = make(B, H, W, w[KZR], w[BZR], 2 * hd, kGates, z);
  add(g, (const T*)hop, hd, hdp);
  add(g, (const T*)mf, kMf, kMf);
  if (ext_dim) add(g, (const T*)eop, ext_dim, extp);
  g.y2 = rh;
  g.g1 = cz;
  g.g2 = cr;
  g.h = h;
  if ((rc = mma_conv(g, sms, s))) return rc;
  if (rhop != rh &&
      (rc = pad_rows<T>(rh, rhop, hd, hdp, nullptr, nullptr, 0, 0, P, s)))
    return rc;

  MmaParams<T> q = make(B, H, W, w[KQ], w[BQ], hd, kGruBlend, hn);
  add(q, (const T*)rhop, hd, hdp);
  add(q, (const T*)mf, kMf, kMf);
  if (ext_dim) add(q, (const T*)eop, ext_dim, extp);
  q.g1 = cq;
  q.g2 = z;
  q.h = h;
  if ((rc = mma_conv(q, sms, s))) return rc;
  if (hnop != hn &&
      (rc = pad_rows<T>(hn, hnop, hd, hdp, nullptr, nullptr, 0, 0, P, s)))
    return rc;

  MmaParams<T> h1 = make(B, H, W, w[KFH1], w[BFH1], kHead, kRelu, fh);
  add(h1, (const T*)hnop, hd, hdp);
  if ((rc = mma_conv(h1, sms, s))) return rc;

  const long pix_per_block = (long)kSmallWarps * kSmallPixPerWarp;
  const size_t smem = sizeof(float) * 9 * kHead * kDelta;
  conv3x3_few_out_kernel<kDelta, T>
      <<<(unsigned)((P + pix_per_block - 1) / pix_per_block),
         32 * kSmallWarps, smem, s>>>(fh, w[WFH2], w[BFH2], delta, B, H, W,
                                      kHead);
  return (int)cudaGetLastError();
}

}  // namespace

// Elements of the workspace `ws` (fp32 for gru_update_forward, bf16 for
// gru_update_forward_bf16, as `elem_bytes` says) that the update needs
// for its intermediates.
extern "C" long gru_update_workspace_elems(int B, int H, int W, int hd,
                                           int ext_dim, int elem_bytes) {
  const long P = (long)B * H * W;
  return elem_bytes == 4 ? workspace<float>(P, hd, ext_dim)
                         : workspace<bf16>(P, hd, ext_dim);
}

// fp32: every tensor fp32; the kernel-layout weights (kc2, ...) hold the
// hi and lo TF32 planes.  Returns the first nonzero CUDA error code of
// the launches, else 0.
extern "C" int gru_update_forward(const float* h, const float* ext,
                                  const float* corr, const float* disp,
                                  const float* cz, const float* cr,
                                  const float* cq, const float* const* w,
                                  float* hn, float* delta, float* ws, int B,
                                  int H, int W, int hd, int ext_dim,
                                  int corr_ch, void* stream) {
  return forward<float>(h, ext, corr, disp, cz, cr, cq, w, hn, delta, ws, B,
                        H, W, hd, ext_dim, corr_ch,
                        static_cast<cudaStream_t>(stream));
}

// bf16: activations, weights, outputs and workspace bf16, disp fp32.
extern "C" int gru_update_forward_bf16(const void* h, const void* ext,
                                       const void* corr, const float* disp,
                                       const void* cz, const void* cr,
                                       const void* cq, const void* const* w,
                                       void* hn, void* delta, void* ws, int B,
                                       int H, int W, int hd, int ext_dim,
                                       int corr_ch, void* stream) {
  return forward<bf16>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(ext),
      static_cast<const bf16*>(corr), disp, static_cast<const bf16*>(cz),
      static_cast<const bf16*>(cr), static_cast<const bf16*>(cq),
      reinterpret_cast<const bf16* const*>(w), static_cast<bf16*>(hn),
      static_cast<bf16*>(delta), static_cast<bf16*>(ws), B, H, W, hd,
      ext_dim, corr_ch, static_cast<cudaStream_t>(stream));
}
