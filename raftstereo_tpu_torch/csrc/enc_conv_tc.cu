// Fused encoder 3x3 convolutions on Hopper's tensor cores (sm_90a), fp32
// as 3xTF32: prep -> 3x3 convolution -> + bias -> raw output, with the
// optional per-(image, channel) fp32 sum and sum of squares of that raw
// output.
//
// Replaces the TPU kernels of the fused encoder stages:
//   raftstereo_tpu/ops/pallas_encoder.py `_enc_conv_kernel` /
//   `_enc_conv_res_kernel` (3x3 stride-1 convs of the stem + layer1
//   stage, row 9);
//   raftstereo_tpu/ops/pallas_layer2.py `_l2_entry_kernel` (layer2's entry:
//   the 3x3 stride-2 conv and the 1x1 stride-2 projection of the same
//   input, both with their sums, row 15);
//   raftstereo_tpu/ops/pallas_layer2.py `_l2_conv_kernel` /
//   `_l2_conv_res_kernel` (layer2's 3x3 stride-1 96->96 convs, row 16).
// Function, NCHW, per output pixel (oy, ox) and channel co:
//   y  = bias + sum_{ci,dy,dx} w[co,ci,dy,dx] * t[ci, S*oy+dy-1, S*ox+dx-1]
//   yp = bp + sum_ci wp[co,ci] * t[ci, 2*oy, 2*ox]      (row 15 only)
// where t is the prepped input, zero outside the image: the zero padding
// lives in the PREPPED domain, since prep(0) = relu(shift) need not be 0.
//   kNone     t = x                                   (row 15: post-relu)
//   kPrep     t = relu(x*s + t)                       (norm apply + relu)
//   kRes      t = relu(relu(r*rs + rt) + relu(x*s + t))  (row 9's block
//                                                       boundary)
//   kResProj  t = relu((r*rs + rt) + relu(x*s + t))   (row 16: no relu on
//                                                       the projection)
// with (s, t) per (image, channel), each product and sum rounded as the
// plain version rounds them (no FMA contraction).  The sums are of the
// fp32 output including the bias.
//
// Design.  An implicit GEMM: pixels x output channels, K = input channels
// x taps.  A block of 8 warps computes an 8 x TW tile of output pixels for
// BN outputs, one instance per conv (kInst below): row 9 8x32 pixels x 64
// outputs; row 15 8x16 x 96 at stride 2; row 16 8x16 x 96 at stride 1, so
// that its 96 outputs fill one tile with no column wasted (8x32 x 64 with
// Cout padded to 128 does a third more products).  Cout past a multiple
// of BN is zero-padded in the pack and never stored.  K is walked in
// stages of 8 input channels, all 9 taps per stage, through a ring of two
// shared-memory stages:
//   - The input: each stage brings in the chunk's haloed input tile once,
//     (TH+2) x (TW+2) at stride 1, (2TH+1) x (2TW+1) at stride 2 (with r's
//     tile too in kRes and kResProj).  Each thread copies its items' raw
//     values with 4-byte `cp.async` (any width, no alignment needed; zero
//     past the image or Cin) while the stage before runs its products,
//     then reads them back, preps them, zeroes every position outside the
//     image or past Cin AFTER the prep, and splits each value into TF32 hi
//     and lo planes: each input element is prepped, masked and split once,
//     not once per tap.  The planes hold a pixel's 8 channels as one
//     32-byte row, its two 16-byte halves swapped where bit 2 of the pixel
//     index is set, so that 8 consecutive pixels fall in 8 distinct bank
//     groups for `ldmatrix` and for the 16-byte stores.  At stride 2 the
//     tile is stored as its four (row, column) parity planes, so that a
//     tap's window is again 16 consecutive pixels of one plane.  (TMA, as
//     row 2 takes it, cannot zero in the prepped domain and needs rows of
//     whole 16-byte units, which odd widths are not.)
//   - The weights: the pack (ops/cuda_encoder.py `tc_pack`) holds each
//     stage's tap blocks exactly as they lie in shared memory (per tap the
//     hi and lo TF32 planes of BN rows of 8 channels, with the same swap),
//     so the threads copy them with `cp.async` 16 bytes at a time.
//   - Every tap of a stage then reads a shifted window of the same tile:
//     A fragments by `ldmatrix` (rows = 16 consecutive output pixels of
//     one output row at the tap's offset), B fragments by `ldmatrix`.
// Warps are 4 (pixels) x 2 (outputs); each owns (16*MT) x (8*NT) fp32
// accumulators (MT 4, NT 4 for row 9; MT 2, NT 6 for rows 15 and 16: MT 4
// with NT 6 would hold 96 running and 96 fresh sums, which spilled).  Row
// 15's projection runs after the conv's epilogue, in the conv's freed
// registers: the tile's centre pixels (input (2*oy, 2*ox)) of 8 stages at
// a time and the pack's projection blocks, copied while the conv's
// outputs are stored, then K = Cin of products, not a 3x3 conv with zero
// taps.  Inside the conv's loop its 48 accumulators beside the conv's
// and their fresh sums spilled (ptxas: 4 to 260 bytes in every form
// tried); this form does not, at 6% of row 15's time (PERF.md §6).  The fill's
// item indices are opaque to the compiler (an empty asm), so that it
// recomputes them each stage instead of holding them through the loop:
// that cut row 9 from 240 to 222 registers and 7% of its time.
// Precision: 3xTF32.  Each operand x splits into hi = cvt.rna.tf32(x) and
// lo = cvt.rna.tf32(x - hi); `mma.sync.aligned.m16n8k8.row.col.f32.tf32.
// tf32.f32` accumulates a_lo*b_hi + a_hi*b_lo + a_hi*b_hi.  The dropped
// lo*lo term is ~2^-22 of each product; a single TF32 pass would not keep
// fp32 accuracy (emulated on the CPU: tests/test_torch_port_enc_tc.py)
// and is not used.  Each stage's 9 k-steps sum into a fresh accumulator
// per (m-tile, n-tile), added to the running total by fp32 adds: the
// tensor cores add into their accumulator with truncation (row 2's kernel
// drifted by ~2e-4 without the fresh accumulator).  The projection's one
// k-step per stage is summed fresh and added likewise.  Every output sums
// its products in one fixed order, whatever the tile.
// Statistics: each lane sums its valid pixels of each of its channels
// (m-tiles in order, rows g then g+8), a fixed butterfly over the 8 lanes
// that share a channel, the 4 pixel warps in order, one partial per
// block; then `enc_conv_tc_stats_kernel` reduces the blocks' partials in
// a fixed order.  No floating-point atomics and no split of K: two calls
// are bitwise equal.
//
// Bound on an H100 SXM (495 TFLOP/s TF32 dense on the tensor cores, so
// fp32 as 3xTF32 at 165; 67 TFLOP/s fp32 on the CUDA cores; 3.35 TB/s):
// a 3x3 64->64 conv over a 576x960 image is 40.8 GFLOP of products
// against 283 MB moved, so operations bound it: 0.25 ms per image as
// 3xTF32 (0.61 ms on the CUDA cores); row 15 at the same input is 17 GFLOP
// with its projection, 0.10 ms per image; row 16, a 3x3 96->96 conv over
// a 288x480 image, 22.9 GFLOP, 0.14 ms per image (0.34 ms on the CUDA
// cores).  What holds the three instances back from that: `mma.sync`
// issues from the warps at a fraction of `wgmma`'s rate; one `ldmatrix`
// per plane per fragment (hi and lo) is about one shared-memory wavefront
// per mma; each stage's fill (read back, prep, mask, split) runs between
// two barriers while the tensor cores wait; one block per SM (8 warps)
// hides little latency; every block copies the whole weight pack from L2
// (295 KB at 64->64, 664 KB at 96->96), and rows 15 and 16's 8x16 tiles
// take it twice as often per pixel as row 9's 8x32.
// The bf16 forms of all three are enc_conv_wg.cu's `wgmma` conv.

#include "enc_partials.cuh"

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsM = 4, kWarpsN = 2;
constexpr int kTH = 8;          // output rows per block
constexpr int kKC = 8;          // input channels per stage
constexpr int kRow = 4 * kKC;   // bytes of a pixel's or an output's stage row

enum Mode { kNone = 0, kPrep = 1, kRes = 2, kResProj = 3 };

// Modes that read the residual input r beside x.
__host__ __device__ constexpr bool has_res(int mode) {
  return mode == kRes || mode == kResProj;
}

template <int S, int MT, int NT, bool PROJ>
struct Geo {
  static constexpr int TW = 8 * MT;               // 4 warps x 16*MT pixels
  static constexpr int BN = kWarpsN * 8 * NT;     // outputs per block
  static constexpr int RH = (kTH - 1) * S + 3;    // raw input tile
  static constexpr int RW = (TW - 1) * S + 3;
  static constexpr int PW = S == 1 ? RW : TW + 1;  // stored plane width
  static constexpr int PS = S == 1 ? RH * RW : (kTH + 1) * (TW + 1);
  static constexpr int NPIX = S == 1 ? PS : 4 * PS;
  static constexpr int kAPlane = NPIX * kRow;
  static constexpr int kABytes = 2 * kAPlane;
  static constexpr int kTapBytes = 2 * BN * kRow;  // a tap's hi and lo rows
  static constexpr int kBBytes = 9 * kTapBytes;    // a stage's conv weights
  // a stage's block in the pack: 9 taps, then the projection's
  static constexpr int kPackFloats = (9 + (PROJ ? 1 : 0)) * kTapBytes / 4;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // fill items: (channel quad, raw tile pixel)
  static constexpr int kItems = 2 * RH * RW;
  static constexpr int kIPT = (kItems + kThreads - 1) / kThreads;
  // the raw values in flight: 16 bytes per item slot and thread, for x
  // (and as much again for r in kRes and kResProj)
  static constexpr int kRawBytes = kIPT * kThreads * 16;
  static constexpr int kSmem = 2 * kStageBytes + kRawBytes;
  // The projection phase (row 15), kPG stages at a time, after the block
  // sums' scratch (kRed bytes): raw values, the hi and lo planes of the
  // tile's centre pixels, the projection's weights.
  static constexpr int kRed = kWarpsM * 2 * 2 * BN * 4;
  static constexpr int kPG = 8;
  static constexpr int kPPix = kTH * TW;
  static constexpr int kPIPT = kPG * 2 * kPPix / kThreads;
  static constexpr int kPRaw = kPIPT * kThreads * 16;
  static constexpr int kPA = kPG * kPPix * kRow;
  static constexpr int kPSmem = kRed + kPRaw + 2 * kPA + kPG * kTapBytes;
  static_assert(kStageBytes % 16 == 0, "16-byte copies");
  static_assert(TW % 16 == 0, "m16 tiles lie within one output row");
  static_assert(kPIPT * kThreads == kPG * 2 * kPPix, "whole fill items");
  static_assert(kRed <= kSmem && (!PROJ || kPSmem <= kSmem),
                "the epilogue reuses the stages' shared memory");
};

struct Args {
  const float* x;     // (B, Cin, H, W)
  const float* xs;    // (B, Cin) prep scale (all modes but kNone)
  const float* xt;    // (B, Cin) prep shift
  const float* r;     // (B, Cin, H, W) residual input (kRes, kResProj)
  const float* rs;
  const float* rt;
  const float* w;     // pack (n tiles, stages, taps, 2, BN, 8), see tc_pack
  const float* bias;  // (Cout)
  const float* bp;    // (Cout) projection bias (row 15)
  float* y;           // (B, Cout, Ho, Wo)
  float* yp;          // (B, Cout, Ho, Wo) projection output (row 15)
  float* partials;    // (B, nb, 2, CH) per-block sums, or null
  int cin, h, win, cout, ho, wo, tiles_w, nb, nchunk;
};

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3,
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}
// d = a * b + 0 (a fresh partial sum) or d += a * b.
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
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
// 4 bytes, or 4 zero bytes where !ok (nothing is read).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ float4 ld_shared_v4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}
__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a,
                                             uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// Byte offset of 16-byte half u (channels 4u .. 4u+3) of row p: the two
// halves swap where bit 2 of p is set.
__device__ __forceinline__ uint32_t row_off(int p, int u) {
  return (uint32_t)(p * kRow + (((u ^ (p >> 2)) & 1) << 4));
}

// d (+)= a * b in 3xTF32: a_lo*b_hi (fresh: onto 0), + a_hi*b_lo, +
// a_hi*b_hi.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2], bool fresh) {
  mma_tf32(d, al, bh[0], bh[1], fresh);
  mma_tf32(d, ah, bl[0], bl[1], false);
  mma_tf32(d, ah, bh[0], bh[1], false);
}

// v = hi + lo as two TF32 values: hi = cvt.rna(v), lo = cvt.rna(v - hi).
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(__fsub_rn(v, __uint_as_float(hi)));
}

// jnp.maximum(v, 0) as torch.relu: keeps NaN.
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

template <int S, int MODE, bool PROJ, int MT, int NT>
__global__ void __launch_bounds__(kThreads, 1)
enc_conv_tc_kernel(const Args a) {
  using G = Geo<S, MT, NT, PROJ>;
  static_assert(NT % 2 == 0, "B fragments load in pairs of n-tiles");
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int b = blockIdx.z, n0 = blockIdx.y * G::BN;
  const int oy0 = (blockIdx.x / a.tiles_w) * kTH;
  const int ox0 = (blockIdx.x % a.tiles_w) * G::TW;
  const int iy0 = oy0 * S - 1, ix0 = ox0 * S - 1;
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  const float* wsrc = a.w + (long)blockIdx.y * a.nchunk * G::kPackFloats;

  // ---- stage fill: item it = (channel quad q, raw tile pixel p).  Each
  // thread copies its items' raw values (x, and r with a residual) into
  // its own 16-byte slots with `cp.async` (zeros past the image or Cin),
  // and after the products of the stage before reads them back from its
  // own slots: its own copies need only its own wait, no barrier.  The
  // item index is
  // made opaque to the compiler, so that it recomputes the item's indices
  // each stage instead of holding them in registers through the loop
  // (which spilled).
  const uint32_t raw = sbase + 2 * G::kStageBytes;
  auto item = [&](int s, int& q, int& lr, int& lc, bool& inside) {
    int it = tid + s * kThreads;
    asm volatile("" : "+r"(it));
    if (it >= G::kItems) return false;
    q = it / (G::RH * G::RW);
    const int p = it - q * (G::RH * G::RW);
    lr = p / G::RW;
    lc = p - lr * G::RW;
    const int gy = iy0 + lr, gx = ix0 + lc;
    inside = gy >= 0 && gy < a.h && gx >= 0 && gx < a.win;
    return true;
  };
  auto load = [&](int k) {
#pragma unroll
    for (int s = 0; s < G::kIPT; ++s) {
      int q, lr, lc;
      bool inside;
      if (!item(s, q, lr, lc, inside)) break;
      const uint32_t slot = raw + (s * kThreads + tid) * 16;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = k * kKC + q * 4 + e;
        const bool ok = inside && c < a.cin;
        const long off =
            ok ? (((long)b * a.cin + c) * a.h + iy0 + lr) * a.win + ix0 + lc
               : 0;
        cp_async4(slot + 4 * e, a.x + off, ok);
        if constexpr (has_res(MODE))
          cp_async4(slot + G::kRawBytes + 4 * e, a.r + off, ok);
      }
    }
  };
  // Preps, masks and splits the loaded values into stage `buf`.
  auto store = [&](int k, int buf) {
    const uint32_t sa = sbase + buf * G::kStageBytes;
#pragma unroll
    for (int s = 0; s < G::kIPT; ++s) {
      int q, lr, lc;
      bool inside;
      if (!item(s, q, lr, lc, inside)) break;
      const uint32_t slot = raw + (s * kThreads + tid) * 16;
      const float4 x4 = ld_shared_v4(slot);
      float4 r4 = x4;
      if constexpr (has_res(MODE)) r4 = ld_shared_v4(slot + G::kRawBytes);
      const float rx[4] = {x4.x, x4.y, x4.z, x4.w};
      const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = k * kKC + q * 4 + e;
        float v = 0.f;  // outside the image or past Cin: zero AFTER prep
        if (inside && c < a.cin) {
          v = rx[e];
          if constexpr (MODE != kNone) {
            const int plane = b * a.cin + c;
            v = relu(__fadd_rn(__fmul_rn(v, __ldg(a.xs + plane)),
                               __ldg(a.xt + plane)));
            if constexpr (has_res(MODE)) {
              float u = __fadd_rn(__fmul_rn(rr[e], __ldg(a.rs + plane)),
                                  __ldg(a.rt + plane));
              if constexpr (MODE == kRes) u = relu(u);
              v = relu(__fadd_rn(u, v));
            }
          }
        }
        split(v, hi[e], lo[e]);
      }
      const int sp = S == 1 ? lr * G::RW + lc
                            : ((lr & 1) * 2 + (lc & 1)) * G::PS +
                                  (lr >> 1) * G::PW + (lc >> 1);
      const uint32_t off = row_off(sp, q);
      st_shared_v4(sa + off, hi[0], hi[1], hi[2], hi[3]);
      st_shared_v4(sa + G::kAPlane + off, lo[0], lo[1], lo[2], lo[3]);
    }
  };
  // `bytes` of the pack from float offset `from` to `dst`, 16 at a time.
  auto copy = [&](uint32_t dst, long from, int bytes) {
    const char* src = reinterpret_cast<const char*>(wsrc + from);
    int i0 = tid;  // opaque, as the fill's items
    asm volatile("" : "+r"(i0));
    for (int i = i0; i < bytes / 16; i += kThreads)
      cp_async16(dst + 16 * i, src + 16 * i);
  };

  // ---- fragment geometry of this lane (PTX m16n8k8 fragment layouts:
  // A matrices (rows 0-7 | 8-15) x (k 0-3 | 4-7); B matrices n-tile pairs
  // x (k 0-3 | 4-7)).  m-tile i of warp wm is output row ly, columns
  // lx .. lx+15: its A rows at tap (dy, dx) are stored pixels pbase[i] +
  // toff(dy, dx), and (ly, lx) of the projection's centre pixels.
  const int a_u = lane >> 4;
  const int r16 = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int b_row = wn * 8 * NT + (lane & 7) + ((lane >> 4) << 3);
  // B rows b_row + 16*jp of any tap block: the same swap as b_row's
  const uint32_t b_off = row_off(b_row, (lane >> 3) & 1);
  auto m_row = [&](int i) { return (wm * MT + i) / (G::TW / 16); };
  auto m_col = [&](int i) { return (wm * MT + i) % (G::TW / 16) * 16; };
  int pbase[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) pbase[i] = m_row(i) * G::PW + m_col(i) + r16;
  // B fragments of n-tiles 2jp, 2jp+1 of the tap block at `blk`.
  auto b_pair = [&](uint32_t blk, int jp, uint32_t(&h)[2][2],
                    uint32_t(&l)[2][2]) {
    const uint32_t o = blk + b_off + 16 * jp * kRow;
    ldmatrix_x4(h[0][0], h[0][1], h[1][0], h[1][1], o);
    ldmatrix_x4(l[0][0], l[0][1], l[1][0], l[1][1], o + G::BN * kRow);
  };
  // A fragments of stored pixel rows p.. of the hi plane at `plane`,
  // its lo plane `lo` bytes after it.
  auto a_frag = [&](uint32_t plane, int lo, int p, uint32_t(&h)[4],
                    uint32_t(&l)[4]) {
    const uint32_t o = plane + row_off(p, a_u);
    ldmatrix_x4(h[0], h[1], h[2], h[3], o);
    ldmatrix_x4(l[0], l[1], l[2], l[3], o + lo);
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  copy(sbase + G::kABytes, 0, G::kBBytes);
  load(0);
  cp_async_wait_all();
  store(0, 0);
  __syncthreads();

  for (int k = 0; k < a.nchunk; ++k) {
    const int cur = k & 1;
    const bool more = k + 1 < a.nchunk;
    if (more) {  // the next stage's copies, in flight during the products
      copy(sbase + (cur ^ 1) * G::kStageBytes + G::kABytes,
           (long)(k + 1) * G::kPackFloats, G::kBBytes);
      load(k + 1);
    }
    const uint32_t sa = sbase + cur * G::kStageBytes;
    const uint32_t sb = sa + G::kABytes;
    float t[MT][NT][4];  // this stage's fresh partial sums
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const int toff = S == 1 ? dy * G::RW + dx
                              : ((dy & 1) * 2 + (dx & 1)) * G::PS +
                                    (dy >> 1) * G::PW + (dx >> 1);
      uint32_t bh[NT / 2][2][2], bl[NT / 2][2][2];
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp)
        b_pair(sb + tap * G::kTapBytes, jp, bh[jp], bl[jp]);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t ah[4], al[4];
        a_frag(sa, G::kAPlane, pbase[i] + toff, ah, al);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma3(t[i][j], ah, al, bh[j / 2][j % 2], bl[j / 2][j % 2],
               tap == 0);
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += t[i][j][e];
    cp_async_wait_all();
    if (more) store(k + 1, cur ^ 1);
    __syncthreads();  // stage cur is free, stage cur^1 is complete
  }

  // ---- epilogue of output o (0: the conv, 1: the projection): + bias,
  // store, and this lane's sums over its pixels; per column a butterfly
  // over its 8 lanes (lane bits 2-4) into red[wm][o][kind][BN]; the 4
  // pixel warps are added in order after a barrier.  Fixed order:
  // bitwise repeatable.  (n < Cout is uniform over a warp: Cout is a
  // multiple of 32 and a warp's n-tile starts at a multiple of 8.)
  const int g = lane >> 2, tq = lane & 3;
  constexpr int kOuts = PROJ ? 2 : 1;
  const bool sums = a.partials != nullptr;  // uniform over the grid
  float* red = reinterpret_cast<float*>(smem);
  auto finish = [&](int o, const float(&v4)[MT][NT][4]) {
    const float* bias = o ? a.bp : a.bias;
    float* out = o ? a.yp : a.y;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = wn * 8 * NT + 8 * j + 2 * tq + e, n = n0 + col;
        float s1 = 0.f, s2 = 0.f;
        if (n < a.cout) {
          const float bv = __ldg(bias + n);
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int oy = oy0 + m_row(i);
              const int ox = ox0 + m_col(i) + g + 8 * half;
              if (oy >= a.ho || ox >= a.wo) continue;
              const float v = v4[i][j][2 * half + e] + bv;
              out[(((long)b * a.cout + n) * a.ho + oy) * a.wo + ox] = v;
              s1 += v;
              s2 = fmaf(v, v, s2);
            }
        }
        if (sums) {
#pragma unroll
          for (int m = 4; m < 32; m <<= 1) {
            s1 += __shfl_xor_sync(0xffffffffu, s1, m);
            s2 += __shfl_xor_sync(0xffffffffu, s2, m);
          }
          if (g == 0) {
            red[((wm * kOuts + o) * 2 + 0) * G::BN + col] = s1;
            red[((wm * kOuts + o) * 2 + 1) * G::BN + col] = s2;
          }
        }
      }
  };

  if constexpr (PROJ) {
    // ---- the projection (row 15): yp = bp + wp . x at the tile's centre
    // pixels (input (2*oy, 2*ox)), K = Cin, after the conv so that its
    // accumulators take the conv's registers: kPG stages at a time, the
    // centre pixels' raw values (a post-relu input: no prep, and the zero
    // fill is exact) and the pack's projection blocks brought in by
    // `cp.async`, split into hi and lo planes, then per stage a fresh
    // 3xTF32 sum added in fp32, as in the conv.
    const uint32_t praw = sbase + G::kRed, pa = praw + G::kPRaw;
    const uint32_t pb = pa + 2 * G::kPA;
    auto pitem = [&](int s, int& kk, int& q, int& p) {
      int it = tid + s * kThreads;  // opaque, as the fill's items
      asm volatile("" : "+r"(it));
      kk = it / (2 * G::kPPix);
      q = it / G::kPPix % 2;
      p = it % G::kPPix;
    };
    auto pload = [&](int k0) {
#pragma unroll
      for (int s = 0; s < G::kPIPT; ++s) {
        int kk, q, p;
        pitem(s, kk, q, p);
        const int gy = 2 * (oy0 + p / G::TW), gx = 2 * (ox0 + p % G::TW);
        const uint32_t slot = praw + (s * kThreads + tid) * 16;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = (k0 + kk) * kKC + q * 4 + e;
          const bool ok = gy < a.h && gx < a.win && c < a.cin;
          const long off =
              ok ? (((long)b * a.cin + c) * a.h + gy) * a.win + gx : 0;
          cp_async4(slot + 4 * e, a.x + off, ok);
        }
      }
      const int n = min(G::kPG, a.nchunk - k0);
      for (int kk = 0; kk < n; ++kk)
        copy(pb + kk * G::kTapBytes,
             (long)(k0 + kk) * G::kPackFloats + 9 * G::kTapBytes / 4,
             G::kTapBytes);
    };
    auto psplit = [&]() {
#pragma unroll
      for (int s = 0; s < G::kPIPT; ++s) {
        int kk, q, p;
        pitem(s, kk, q, p);
        const float4 x4 = ld_shared_v4(praw + (s * kThreads + tid) * 16);
        const float v[4] = {x4.x, x4.y, x4.z, x4.w};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(v[e], hi[e], lo[e]);
        const uint32_t off = kk * G::kPPix * kRow + row_off(p, q);
        st_shared_v4(pa + off, hi[0], hi[1], hi[2], hi[3]);
        st_shared_v4(pa + G::kPA + off, lo[0], lo[1], lo[2], lo[3]);
      }
    };
    pload(0);  // in flight during the conv's epilogue
    finish(0, acc);
    float accp[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) accp[i][j][e] = 0.f;
    for (int k0 = 0; k0 < a.nchunk; k0 += G::kPG) {
      if (k0 > 0) {
        __syncthreads();  // the previous group's products are done
        pload(k0);
      }
      cp_async_wait_all();
      psplit();
      __syncthreads();
      const int n = min(G::kPG, a.nchunk - k0);
      for (int kk = 0; kk < n; ++kk) {
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          a_frag(pa + kk * G::kPPix * kRow, G::kPA,
                 m_row(i) * G::TW + m_col(i) + r16, ah[i], al[i]);
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          uint32_t bh[2][2], bl[2][2];
          b_pair(pb + kk * G::kTapBytes, jp, bh, bl);
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              float tp[4];
              mma3(tp, ah[i], al[i], bh[jj], bl[jj], true);
#pragma unroll
              for (int e = 0; e < 4; ++e) accp[i][2 * jp + jj][e] += tp[e];
            }
        }
      }
    }
    finish(1, accp);
  } else {
    finish(0, acc);
  }
  if (!sums) return;
  __syncthreads();
  const int ch = kOuts * a.cout;
  for (int idx = tid; idx < kOuts * 2 * G::BN; idx += kThreads) {
    const int col = idx % G::BN, kind = (idx / G::BN) % 2,
              o = idx / (2 * G::BN);
    if (n0 + col >= a.cout) continue;
    float s = red[(o * 2 + kind) * G::BN + col];
#pragma unroll
    for (int w = 1; w < kWarpsM; ++w)
      s += red[((w * kOuts + o) * 2 + kind) * G::BN + col];
    a.partials[(((long)b * a.nb + blockIdx.x) * 2 + kind) * ch +
               o * a.cout + n0 + col] = s;
  }
}

// A conv kernel over the grid (tiles, Cout tiles of `bn`, images), then
// the sums' reduction.
int launch_conv(void (*kernel)(Args), int smem, int bn, bool proj,
                const Args& a, int batch, float* stats, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.nb, (a.cout + bn - 1) / bn, batch);
  kernel<<<grid, kThreads, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || stats == nullptr) return (int)e;
  const int ch2 = 2 * (proj ? 2 : 1) * a.cout;
  const int total = batch * ch2;
  enc_conv_tc_stats_kernel<<<(total + 7) / 8, 256, 0, st>>>(
      a.partials, stats, a.nb, ch2, total);
  return (int)cudaGetLastError();
}

// The instances, by id: (stride, MT, NT).  Output columns per block 8*MT,
// outputs per block 16*NT.
struct Inst {
  int stride, mt, nt;
};
constexpr Inst kInst[3] = {
    {1, 4, 4},  // 0: row 9, the stem + layer1 stage's convs (prep, res)
    {2, 2, 6},  // 1: row 15, layer2's entry (none, with the projection)
    {1, 2, 6},  // 2: row 16, layer2's convs (prep, res_proj)
};

template <int I, int MODE, bool PROJ>
int launch_inst(const Args& a, int batch, float* stats, cudaStream_t st) {
  constexpr Inst in = kInst[I];
  using G = Geo<in.stride, in.mt, in.nt, PROJ>;
  return launch_conv(enc_conv_tc_kernel<in.stride, MODE, PROJ, in.mt, in.nt>,
                     G::kSmem + (has_res(MODE) ? G::kRawBytes : 0), G::BN,
                     PROJ, a, batch, stats, st);
}

// The supported (instance, mode) pairs.
int dispatch(const Args& a, int inst, int mode, int batch, float* stats,
             cudaStream_t s) {
  if (inst == 0 && mode == kPrep)
    return launch_inst<0, kPrep, false>(a, batch, stats, s);
  if (inst == 0 && mode == kRes)
    return launch_inst<0, kRes, false>(a, batch, stats, s);
  if (inst == 1 && mode == kNone)
    return launch_inst<1, kNone, true>(a, batch, stats, s);
  if (inst == 2 && mode == kPrep)
    return launch_inst<2, kPrep, false>(a, batch, stats, s);
  if (inst == 2 && mode == kResProj)
    return launch_inst<2, kResProj, false>(a, batch, stats, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, r (B, Cin, H, W); xs, xt, rs, rt (B, Cin); w the pack of
// ops/cuda_encoder.py `tc_pack` for outputs per block `bn`; bias, bp
// (Cout); y, yp (B, Cout, Ho, Wo), Ho = (H - 1)/stride + 1 (and Wo alike);
// partials (B, nb, 2, CH) scratch and stats (B, 2, CH), both null without
// statistics, CH = Cout (2*Cout with the projection, its channels last),
// nb = ceil(Ho/8) * ceil(Wo/tile width).  All fp32 and contiguous.  Cout
// a multiple of 32, any Cin.
// `inst` picks the instance of kInst (its stride, tile width and bn, which
// must match `bn`); supported (instance, mode): (0, prep|res), (1, none)
// with the projection, (2, prep|res_proj).
// Returns the CUDA error code of the launches (0 on success).
extern "C" int enc_conv_tc_forward(
    const float* x, const float* xs, const float* xt, const float* r,
    const float* rs, const float* rt, const float* w, const float* bias,
    const float* bp, float* y, float* yp, float* partials, float* stats,
    int batch, int cin, int h, int win, int cout, int inst, int mode,
    int nb, int bn, void* stream) {
  if (inst < 0 || inst > 2) return (int)cudaErrorInvalidValue;
  const Inst in = kInst[inst];
  const int ho = (h - 1) / in.stride + 1, wo = (win - 1) / in.stride + 1;
  const int tiles_w = (wo + 8 * in.mt - 1) / (8 * in.mt);
  const bool proj = bp != nullptr;
  if (batch < 1 || cin < 1 || h < 1 || win < 1 || cout % 32 != 0 ||
      nb != ((ho + kTH - 1) / kTH) * tiles_w ||
      (stats == nullptr) != (partials == nullptr) ||
      bn != kWarpsN * 8 * in.nt || proj != (inst == 1))
    return (int)cudaErrorInvalidValue;
  const Args a{x,   xs,  xt, r,    rs, rt, w,       bias,
               bp,  y,   yp, partials, cin, h, win, cout,
               ho,  wo,  tiles_w, nb, (cin + kKC - 1) / kKC};
  return dispatch(a, inst, mode, batch, stats,
                  static_cast<cudaStream_t>(stream));
}
