// The fused encoder's 7x7 conv1 for Hopper (sm_90a), fp32: convolution of
// the raw image -> + bias -> raw output, with the optional per-(image,
// channel) fp32 sum and sum of squares of that raw output.
//
// Replaces the TPU kernels of the fused encoder stem:
//   raftstereo_tpu/ops/pallas_encoder.py `_stem7_kernel` (7x7 stride-1
//   conv1 of the image, row 13), `_stem7s2_kernel` (7x7 stride 2, row 12).
// (The stages' 3x3 convs, rows 9, 15 and 16, run on the tensor cores:
// csrc/enc_conv_tc.cu.)
// Function, NCHW, per output pixel and channel:
//   y = bias + sum_{ci,dy,dx} w[co,ci,dy,dx] * x[ci, oy*S+dy-3, ox*S+dx-3]
// with x zero outside the image.  Statistics are of the fp32 output
// including the bias, one partial per (image, 8x32 output tile) from
// registers and shared memory, then one fixed-order reduction kernel over
// the tiles' partials: no floating-point atomics, so two calls are
// bitwise equal, and no single running sum over the 552,960 pixels of an
// image.
//
// Both strides are one kernel, `stem7_tc_kernel<S>` (3 -> 64 channels):
// an implicit GEMM of 3xTF32 `mma.sync.m16n8k8` tiles, M = output pixels,
// N = the 64 outputs, K = 3 channels x 49 taps in the weights' own order
// (ci, dy, dx), padded from 147 to 152: 19 k-steps of 8.
//   - Persistent blocks (as many as fit the SMs: one), each walking 8x32
//     output tiles of all 64 outputs; the tiles are dealt so that every
//     block takes the same count, rounds = ceil(tiles / SMs) (row 12's
//     serving shape, 1080 tiles, is 9 rounds of 120 blocks).  A block
//     splits the weights once into TF32 hi and lo planes in shared memory
//     (78 KB: per k-step 64 rows of 8 values, the two 16-byte halves of a
//     row swapped where bit 2 of the output index is set, so `ldmatrix`
//     reads B without bank conflicts; the pad k zero), and keeps them for
//     its life.
//   - Per tile the whole haloed input is split once into hi and lo planes
//     (not once per tap); the next tile's raw values arrive by 4-byte
//     `cp.async` (zero outside the image) while the tile before runs its
//     products, and are split into the other plane buffer.  Stride 1
//     stages 3 x 14 x 38 values.  Stride 2 stages 3 x 21 rows of 69
//     columns, each row as two column planes, even columns then odd
//     columns (35 each, 42 apart): output column p at tap dx reads raw
//     column 2p + dx, which is plane dx & 1 at column p + (dx >> 1), so
//     the 8 lanes of a fragment row read 8 consecutive words again, not
//     words 2 apart (a bank conflict in every gather).
//   - A fragments are gathered: a table in shared memory gives each k its
//     plane offset, (ci * IH + dy) * IW + (dx % S) * PS + dx / S, and
//     lane (g, t) of a 16-pixel m-tile reads its pixel rows g and g + 8 at
//     k 8s + t and 8s + t + 4 (8 scalar shared loads a fragment, hi and
//     lo).  A pad k's offset points into zeros past the plane, so it never
//     multiplies an image value.  (For stride 1, K ordered (dy, ci, dx)
//     with dx padded to 8, 21 k-steps whose 8 k are 8 consecutive columns,
//     was 3.5% slower: PERF.md section 6.)
//   - Warps 8 (pixels) x 2 (outputs), each 2 m-tiles x 4 n-tiles: 16 warps
//     at 125 registers, against 8 warps of 4 m-tiles at 204 (5% slower).
//     Each product is a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (hi =
//     cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi)); every 4 k-steps sum
//     into fresh accumulators, added to the running total by fp32 adds
//     (the tensor cores truncate as they accumulate).  A single TF32 pass
//     would not keep fp32 accuracy (emulated on the CPU:
//     tests/test_torch_port_stem_tc.py and test_torch_port_stem_s2_tc.py).
//   - Outputs are stored from the fragments: the 8 lanes of a column write
//     8 consecutive pixels of one output row, whole 32-byte sectors.
//
// Bound on an H100 SXM (495 TFLOP/s TF32 dense on the tensor cores, so
// fp32 as 3xTF32 at 165; 67 TFLOP/s fp32 on the CUDA cores; 3.35 TB/s):
// a 7x7 3->64 conv1 over a 576x960 image is 10.4 GFLOP of products
// against 148 MB moved (the fp32 output), so as 3xTF32 it is bound by
// operations at 0.063 ms per image (bytes 0.044 ms; 0.16 ms on the CUDA
// cores); row 12 at the same input is 2.6 GFLOP against 42 MB, 0.016 ms
// per image as 3xTF32 (bytes 0.013 ms; 0.039 ms on the CUDA cores).  What
// holds this design back from that: `mma.sync` issues at a fraction of
// `wgmma`'s rate; the A fragments are 8 scalar shared loads per m-tile and
// k-step (a sliding window's rows are not 16-byte aligned for `ldmatrix`),
// in whose gathers lanes of different k can meet in a bank; one block of
// 16 warps per SM (the resident weights take 78 KB) hides little latency;
// a tile's stores and the next tile's split run between barriers while the
// tensor cores wait; and stride 2 stages 2.8x the input values a tile of
// stride 1 does for the same products.  With its products taken out, the
// stride-2 form ran in 73% of its time (PERF.md section 6): the
// gathers and splits and their address arithmetic, not the tensor cores,
// set its pace (splitting A in registers as it is gathered, which halves
// the gathers but adds three operations a value, was 9% slower).
//
// The bf16 forms (`enc_stem7_tc_forward` with `bf16` set: the JAX kernels at
// dt=bfloat16, `img.astype(dt)` and the weights and bias `.astype(dt)`,
// pallas_encoder.py:802-807, :863-869) are `stem7_bf16_kernel<S>`, the
// same persistent design over bf16 operands: K = 147 in (ci, dy, dx)
// order padded to 160, 10 k-steps of one
// `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32` (exact products,
// fp32 sums: 4 k-steps a fresh accumulator, added in fp32), the bf16 bias
// added in fp32, the sums of that fp32 output, the output stored rounded
// to bf16 once.  The resident weights are bf16 rows of 16 k (20 KB); the
// input planes bf16, one per buffer (no hi/lo split); an A register is
// two k of one pixel (k 2t, 2t+1, or + 8), each gathered through the
// table as a 2-byte load.  The next tile's raw values are 2 bytes, below
// `cp.async`'s 4: each thread loads them into registers during the
// products and stores them after.  Bound (989 TFLOP/s dense bf16): row 13
// at 576x960 10.4 GFLOP against 74 MB, 0.022 ms per image by bytes; row
// 12 2.6 GFLOP against 21 MB, 0.0063 ms by bytes.  A first form: right
// and simple, with the fp32 form's gathers as its pace.

#include "enc_bf16.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 8;   // output rows per tile
constexpr int kTileW = 32;  // output columns per tile

// partials (B, nb, 2*CH) -> stats (B, 2*CH): one warp per output, lanes
// strided over the blocks, then a butterfly.  Fixed order.
__global__ void __launch_bounds__(256)
enc_conv_stats_kernel(const float* __restrict__ partials,
                      float* __restrict__ stats, int nb, int ch2, int total) {
  const int idx = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (idx >= total) return;  // whole warps exit together
  const int b = idx / ch2, k = idx - b * ch2;
  const float* p = partials + (long)b * nb * ch2 + k;
  float s = 0.f;
  for (int i = lane; i < nb; i += 32) s += p[(long)i * ch2];
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (lane == 0) stats[idx] = s;
}

// ------------------------------------ rows 13 and 12: the stems, 3xTF32

constexpr int kStemIn = 3, kStemOut = 64, kStemKS = 7;
constexpr int kStemWarpsM = 8, kStemWarpsN = 2;
constexpr int kStemMT = 2, kStemNT = 4;  // m-tiles, n-tiles per warp
constexpr int kStemThreads = 32 * kStemWarpsM * kStemWarpsN;
constexpr int kStemTH = kTileH, kStemTW = kTileW;  // the 8x32 output tile
constexpr int kStemK = kStemIn * kStemKS * kStemKS;  // 147, (ci, dy, dx)
constexpr int kStemKSteps = (kStemK + 7) / 8;          // 19 of 8
constexpr int kStemGroup = 4;  // k-steps summed into one fresh accumulator
constexpr int kRow = 32;                  // bytes: a row of 8 TF32 values
constexpr int kStemTapBytes = 2 * kStemOut * kRow;  // a k-step's hi, lo
constexpr int kStemWBytes = kStemKSteps * kStemTapBytes;
constexpr int kStemRedBytes = 2 * kStemWarpsM * 2 * kStemOut * 4;
constexpr int kStemTabBytes = 8 * kStemKSteps * 4;
static_assert(kStemWarpsM * kStemMT * 16 == kStemTH * kStemTW,
              "the warps' m-tiles cover the tile");
static_assert(kStemWarpsN * kStemNT * 8 == kStemOut, "all 64 outputs");

// The staged input tile of stride S: kIH rows of the haloed tile, each
// row kIW values holding S column planes of kHalf values kPS apart (raw
// column j at (j % S) * kPS + j / S; the slots between unused, zero),
// then kZeros zeros past the 3 channels' planes (a pad k's reads).  At
// stride 2 the odd plane starts 42 values after the even one: a gather's
// 4 k (lanes t) then meet in a bank 1.26 times a load on average over the
// tile's m-tiles and k-steps, against 2.45 with the planes packed 35
// apart (stride 1, one plane of 38: 1.34), as a model of the 32 banks
// finds (PERF.md section 6).
template <int S>
struct StemTile {
  static constexpr int kIH = (kStemTH - 1) * S + kStemKS;   // 14, 21
  static constexpr int kRaw = (kStemTW - 1) * S + kStemKS;  // 38, 69
  static constexpr int kHalf = (kRaw + S - 1) / S;          // 38, 35
  static constexpr int kPS = S == 1 ? kHalf : 42;           // 38, 42
  static constexpr int kIW = S * kPS;                       // 38, 84
  static constexpr int kPlane = kStemIn * kIH * kIW;  // values a plane
  static constexpr int kZeros = ((kStemTH - 1) * S * kIW + kStemTW + 31) /
                                32 * 32;               // 320, 1216
  static constexpr int kPlaneStride = kPlane + kZeros;
  static constexpr int kIPT = (kPlane + kStemThreads - 1) / kStemThreads;
  static constexpr int kPlanesBytes = 2 * 2 * kPlaneStride * 4;  // 2 x hi, lo
  static constexpr int kRawBytes = kIPT * kStemThreads * 4;
  static constexpr int kSmem = kStemWBytes + kPlanesBytes + kRawBytes +
                               kStemRedBytes + kStemTabBytes;
  static_assert(kZeros >= (kStemTH - 1) * S * kIW + kStemTW,
                "a pad k's reads, from any pixel of the tile, stay in zeros");
  static_assert(kSmem <= 232448, "the block's shared memory fits an SM");
};

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// v = hi + lo as two TF32 values: hi = cvt.rna(v), lo = cvt.rna(v - hi).
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(__fsub_rn(v, __uint_as_float(hi)));
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
// 4 bytes, or 4 zero bytes where !ok (nothing is read).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}
// Byte offset of 16-byte half u (k 4u .. 4u+3) of weight row n: the two
// halves swap where bit 2 of n is set.
__device__ __forceinline__ uint32_t row_off(int n, int u) {
  return (uint32_t)(n * kRow + (((u ^ (n >> 2)) & 1) << 4));
}

// In: the image's and weights' element (float, or a bf16's bits as
// unsigned short); Out: the bias's and output's (float or __nv_bfloat16).
template <typename In, typename Out>
struct StemArgsT {
  const In* x;        // (B, 3, H, W)
  const In* w;        // (64, 3, 7, 7), OIHW
  const Out* bias;    // (64)
  Out* y;             // (B, 64, Ho, Wo)
  float* partials;    // (B, nb, 2, 64) per-tile sums, or null (no stats)
  int batch, h, win, ho, wo, tiles_w, nb;
};
using StemArgs = StemArgsT<float, float>;
using StemArgsB = StemArgsT<unsigned short, __nv_bfloat16>;

template <int S>
__global__ void __launch_bounds__(kStemThreads, 1)
stem7_tc_kernel(const StemArgs a) {
  using G = StemTile<S>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kStemWarpsN, wn = warp % kStemWarpsN;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t sw = sbase;  // the weights' k-step blocks
  uint32_t* planes = reinterpret_cast<uint32_t*>(smem + kStemWBytes);
  const uint32_t raw = sbase + kStemWBytes + G::kPlanesBytes;
  float* red = reinterpret_cast<float*>(smem + kStemWBytes +
                                        G::kPlanesBytes + G::kRawBytes);
  int* tab = reinterpret_cast<int*>(smem + G::kSmem - kStemTabBytes);
  const int total = a.batch * a.nb;

  // ---- a tile's input: item it = its plane index (ci, staged row,
  // column plane, column), raw column j = column * S + plane; each thread
  // copies its items' values into its own 4-byte slots (zero outside the
  // image and in the unused slots), then after its own wait splits them
  // into a plane buffer.  The item index is opaque to the compiler, so
  // that it recomputes the item's indices instead of holding them through
  // the products.
  auto tile_at = [&](int tile, int& b, int& oy0, int& ox0) {
    b = tile / a.nb;
    const int tb = tile - b * a.nb;
    oy0 = (tb / a.tiles_w) * kStemTH;
    ox0 = (tb % a.tiles_w) * kStemTW;
  };
  auto load = [&](int tile) {
    int b, oy0, ox0;
    tile_at(tile, b, oy0, ox0);
#pragma unroll
    for (int s = 0; s < G::kIPT; ++s) {
      int it = tid + s * kStemThreads;
      asm volatile("" : "+r"(it));
      if (it >= G::kPlane) break;
      const int ci = it / (G::kIH * G::kIW);
      const int p = it - ci * (G::kIH * G::kIW);
      const int q = p % G::kIW, c = q % G::kPS;
      const int gy = oy0 * S - kStemKS / 2 + p / G::kIW;
      const int gx = ox0 * S - kStemKS / 2 + c * S + q / G::kPS;
      const bool ok = c < G::kHalf && gy >= 0 && gy < a.h && gx >= 0 &&
                      gx < a.win;
      const long off =
          ok ? (((long)b * kStemIn + ci) * a.h + gy) * a.win + gx : 0;
      cp_async4(raw + (s * kStemThreads + tid) * 4, a.x + off, ok);
    }
  };
  auto store = [&](int buf) {
    uint32_t* hi = planes + buf * 2 * G::kPlaneStride;
#pragma unroll
    for (int s = 0; s < G::kIPT; ++s) {
      int it = tid + s * kStemThreads;
      asm volatile("" : "+r"(it));
      if (it >= G::kPlane) break;
      const float v = *reinterpret_cast<const float*>(
          smem + kStemWBytes + G::kPlanesBytes +
          (s * kStemThreads + tid) * 4);
      split(v, hi[it], hi[G::kPlaneStride + it]);
    }
  };

  // ---- once per block, while the first tile's input is in flight: the
  // weights, k = ci * 49 + dy * 7 + dx (OIHW's own order) at k-step k / 8,
  // slot k % 8 of row n, split into hi and lo planes, the pad k (147 ..
  // 151) zero; the gather table, tab[k] = the plane offset of k's (ci, dy,
  // dx) (a pad k's: the zeros past the plane); and those zeros.
  if (blockIdx.x < total) load(blockIdx.x);
  for (int e = tid; e < kStemOut * 8 * kStemKSteps; e += kStemThreads) {
    const int n = e / (8 * kStemKSteps), k = e % (8 * kStemKSteps);
    uint32_t hi = 0u, lo = 0u;
    if (k < kStemK) split(__ldg(a.w + n * kStemK + k), hi, lo);
    unsigned char* blk = smem + (k / 8) * kStemTapBytes;
    const uint32_t off = row_off(n, (k >> 2) & 1) + (k & 3) * 4;
    *reinterpret_cast<uint32_t*>(blk + off) = hi;
    *reinterpret_cast<uint32_t*>(blk + kStemOut * kRow + off) = lo;
  }
  for (int k = tid; k < 8 * kStemKSteps; k += kStemThreads) {
    const int ci = k / (kStemKS * kStemKS), tap = k % (kStemKS * kStemKS);
    const int dy = tap / kStemKS, dx = tap % kStemKS;
    tab[k] = k < kStemK
                 ? (ci * G::kIH + dy) * G::kIW + (dx % S) * G::kPS + dx / S
                 : G::kPlane;
  }
  for (int e = tid; e < 2 * 2 * G::kZeros; e += kStemThreads)
    planes[(e / G::kZeros) * G::kPlaneStride + G::kPlane + e % G::kZeros] =
        0u;

  // ---- fragment geometry: m-tile i of warp wm is tile row ly, columns
  // lx .. lx + 15, whose pixel lx + g's raw window starts at staged row
  // S * ly, column lx + g of each column plane; lane (g, t)'s A values at
  // k-step s are the plane's values pbase[i] + {tab[8s + t], 8 + tab[8s +
  // t], tab[8s + t + 4], 8 + tab[8s + t + 4]} (rows g, g + 8 by k t, t +
  // 4).
  int pbase[kStemMT];
#pragma unroll
  for (int i = 0; i < kStemMT; ++i) {
    const int mt = wm * kStemMT + i;
    pbase[i] = (mt / (kStemTW / 16)) * S * G::kIW +
               (mt % (kStemTW / 16)) * 16 + g;
  }
  const int b_row = wn * 8 * kStemNT + (lane & 7) + ((lane >> 4) << 3);
  const uint32_t b_off = row_off(b_row, (lane >> 3) & 1);

  int buf = 0;
  if (blockIdx.x < total) {  // the first tile's input landed meanwhile
    cp_async_wait_all();
    store(0);
  }
  __syncthreads();

  for (int tile = blockIdx.x; tile < total; tile += gridDim.x, buf ^= 1) {
    const int next = tile + gridDim.x;
    if (next < total) load(next);  // in flight during the products
    const uint32_t* ph = planes + buf * 2 * G::kPlaneStride;
    const uint32_t* pl = ph + G::kPlaneStride;
    float acc[kStemMT][kStemNT][4];
#pragma unroll
    for (int i = 0; i < kStemMT; ++i)
#pragma unroll
      for (int j = 0; j < kStemNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll 1
    for (int s0 = 0; s0 < kStemKSteps; s0 += kStemGroup) {
      float f[kStemMT][kStemNT][4];  // these k-steps' fresh partial sums
#pragma unroll
      for (int ss = 0; ss < kStemGroup; ++ss) {
        const int s = s0 + ss;
        if (s >= kStemKSteps) break;
        const uint32_t blk = sw + s * kStemTapBytes;
        uint32_t bh[kStemNT / 2][2][2], bl[kStemNT / 2][2][2];
#pragma unroll
        for (int jp = 0; jp < kStemNT / 2; ++jp) {
          const uint32_t o = blk + b_off + 16 * jp * kRow;
          ldmatrix_x4(bh[jp][0][0], bh[jp][0][1], bh[jp][1][0], bh[jp][1][1],
                      o);
          ldmatrix_x4(bl[jp][0][0], bl[jp][0][1], bl[jp][1][0], bl[jp][1][1],
                      o + kStemOut * kRow);
        }
        const int o0 = tab[8 * s + t], o1 = tab[8 * s + t + 4];
#pragma unroll
        for (int i = 0; i < kStemMT; ++i) {
          const int q = pbase[i];
          const uint32_t ah[4] = {ph[q + o0], ph[q + 8 + o0], ph[q + o1],
                                  ph[q + 8 + o1]};
          const uint32_t al[4] = {pl[q + o0], pl[q + 8 + o0], pl[q + o1],
                                  pl[q + 8 + o1]};
#pragma unroll
          for (int j = 0; j < kStemNT; ++j)
            mma3(f[i][j], ah, al, bh[j / 2][j % 2], bl[j / 2][j % 2],
                 ss == 0);
        }
      }
#pragma unroll
      for (int i = 0; i < kStemMT; ++i)
#pragma unroll
        for (int j = 0; j < kStemNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += f[i][j][e];
    }

    // ---- + bias, store, and this lane's sums over its pixels (m-tiles in
    // order, rows g then g + 8); per column a butterfly over its 8 lanes
    // g into red[buf][wm][kind][n]; after the barrier the 8 pixel warps
    // are added in order.  Fixed order: bitwise repeatable.
    int b, oy0, ox0;
    tile_at(tile, b, oy0, ox0);
    const bool sums = a.partials != nullptr;  // uniform over the grid
    float* rb = red + buf * (kStemWarpsM * 2 * kStemOut);
#pragma unroll
    for (int j = 0; j < kStemNT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = wn * 8 * kStemNT + 8 * j + 2 * t + e;
        const float bv = __ldg(a.bias + n);
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int i = 0; i < kStemMT; ++i)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int mt = wm * kStemMT + i;
            const int oy = oy0 + mt / (kStemTW / 16);
            const int ox = ox0 + (mt % (kStemTW / 16)) * 16 + g + 8 * half;
            if (oy >= a.ho || ox >= a.wo) continue;
            const float v = acc[i][j][2 * half + e] + bv;
            a.y[(((long)b * kStemOut + n) * a.ho + oy) * a.wo + ox] = v;
            s1 += v;
            s2 = fmaf(v, v, s2);
          }
        if (sums) {
#pragma unroll
          for (int m = 4; m < 32; m <<= 1) {
            s1 += __shfl_xor_sync(0xffffffffu, s1, m);
            s2 += __shfl_xor_sync(0xffffffffu, s2, m);
          }
          if (g == 0) {
            rb[(wm * 2 + 0) * kStemOut + n] = s1;
            rb[(wm * 2 + 1) * kStemOut + n] = s2;
          }
        }
      }
    if (next < total) {  // the next tile's planes, into the other buffer
      cp_async_wait_all();
      store(buf ^ 1);
    }
    __syncthreads();
    if (sums && tid < 2 * kStemOut) {
      const int n = tid % kStemOut, kind = tid / kStemOut;
      float s = rb[kind * kStemOut + n];
#pragma unroll
      for (int w = 1; w < kStemWarpsM; ++w) s += rb[(w * 2 + kind) * kStemOut + n];
      a.partials[((long)tile * 2 + kind) * kStemOut + n] = s;
    }
  }
}

// A persistent stem kernel (as many blocks as fit the SMs, found at its
// first launch into `grid_max`), then the sums' reduction.
template <typename A>
int launch_stem7(void (*kernel)(A), int smem, int& grid_max, const A& a,
                 float* stats, cudaStream_t st) {
  if (grid_max == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0, per_sm = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kStemThreads, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    grid_max = sms * per_sm;
  }
  // Every block takes the same count of tiles: ceil(total / grid_max)
  // rounds over as few blocks as those rounds need.
  const int total = a.batch * a.nb;
  const int rounds = (total + grid_max - 1) / grid_max;
  const int grid = (total + rounds - 1) / rounds;
  kernel<<<grid, kStemThreads, smem, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || stats == nullptr) return (int)e;
  const int ch2 = 2 * kStemOut;
  const int n = a.batch * ch2;
  enc_conv_stats_kernel<<<(n + 7) / 8, 256, 0, st>>>(a.partials, stats, a.nb,
                                                     ch2, n);
  return (int)cudaGetLastError();
}

// ------------------------------------------- rows 13 and 12 in bf16

constexpr int kStemKStepsB = (kStemK + 15) / 16;     // 10 of 16
constexpr int kStemTapBytesB = kStemOut * kRow;      // 64 rows of 16 bf16
constexpr int kStemWBytesB = kStemKStepsB * kStemTapBytesB;
constexpr int kStemTabBytesB = 16 * kStemKStepsB * 4;

template <int S>
struct StemTileB {
  using T = StemTile<S>;
  static constexpr int kPlane = T::kPlane;       // bf16 values of a tile
  static constexpr int kPlaneStride = (T::kPlaneStride + 7) / 8 * 8;
  static constexpr int kIPT = T::kIPT;
  static constexpr int kPlanesBytes = 2 * kPlaneStride * 2;  // 2 buffers
  static constexpr int kSmem =
      kStemWBytesB + kPlanesBytes + kStemRedBytes + kStemTabBytesB;
  static_assert(kSmem <= 232448, "the block's shared memory fits an SM");
};

template <int S>
__global__ void __launch_bounds__(kStemThreads, 1)
stem7_bf16_kernel(const StemArgsB a) {
  using T = StemTile<S>;
  using G = StemTileB<S>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kStemWarpsN, wn = warp % kStemWarpsN;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t sw = (uint32_t)__cvta_generic_to_shared(smem);
  unsigned short* planes =
      reinterpret_cast<unsigned short*>(smem + kStemWBytesB);
  float* red = reinterpret_cast<float*>(smem + kStemWBytesB + G::kPlanesBytes);
  int* tab = reinterpret_cast<int*>(smem + G::kSmem - kStemTabBytesB);
  const int total = a.batch * a.nb;

  // ---- a tile's input: item it = its plane index (ci, staged row,
  // column plane, column), as the fp32 kernel's; each thread loads its
  // items' bf16 values into registers (zero outside the image and in the
  // unused slots), then stores them into a plane buffer.
  unsigned short rv[G::kIPT];
  auto tile_at = [&](int tile, int& b, int& oy0, int& ox0) {
    b = tile / a.nb;
    const int tb = tile - b * a.nb;
    oy0 = (tb / a.tiles_w) * kStemTH;
    ox0 = (tb % a.tiles_w) * kStemTW;
  };
  auto load = [&](int tile) {
    int b, oy0, ox0;
    tile_at(tile, b, oy0, ox0);
#pragma unroll
    for (int s = 0; s < G::kIPT; ++s) {
      int it = tid + s * kStemThreads;
      asm volatile("" : "+r"(it));
      if (it >= G::kPlane) break;
      const int ci = it / (T::kIH * T::kIW);
      const int p = it - ci * (T::kIH * T::kIW);
      const int q = p % T::kIW, c = q % T::kPS;
      const int gy = oy0 * S - kStemKS / 2 + p / T::kIW;
      const int gx = ox0 * S - kStemKS / 2 + c * S + q / T::kPS;
      const bool ok = c < T::kHalf && gy >= 0 && gy < a.h && gx >= 0 &&
                      gx < a.win;
      const long off =
          ok ? (((long)b * kStemIn + ci) * a.h + gy) * a.win + gx : 0;
      rv[s] = ok ? __ldg(a.x + off) : (unsigned short)0;
    }
  };
  auto store = [&](int buf) {
    unsigned short* pl = planes + buf * G::kPlaneStride;
#pragma unroll
    for (int s = 0; s < G::kIPT; ++s) {
      int it = tid + s * kStemThreads;
      asm volatile("" : "+r"(it));
      if (it >= G::kPlane) break;
      pl[it] = rv[s];
    }
  };

  // ---- once per block: the weights, k = ci * 49 + dy * 7 + dx at k-step
  // k / 16, position k % 16 of row n (the two 8-k halves of a row swapped
  // where bit 2 of n is set), the pad k (147 .. 159) zero; the gather
  // table (a pad k's offset: the zeros past the plane); those zeros.
  if (blockIdx.x < total) load(blockIdx.x);
  for (int e = tid; e < kStemOut * 16 * kStemKStepsB; e += kStemThreads) {
    const int n = e / (16 * kStemKStepsB), k = e % (16 * kStemKStepsB);
    const unsigned short v = k < kStemK ? __ldg(a.w + n * kStemK + k)
                                        : (unsigned short)0;
    unsigned char* blk = smem + (k / 16) * kStemTapBytesB;
    const uint32_t off = row_off(n, (k >> 3) & 1) + (k & 7) * 2;
    *reinterpret_cast<unsigned short*>(blk + off) = v;
  }
  for (int k = tid; k < 16 * kStemKStepsB; k += kStemThreads) {
    const int ci = k / (kStemKS * kStemKS), tap = k % (kStemKS * kStemKS);
    const int dy = tap / kStemKS, dx = tap % kStemKS;
    tab[k] = k < kStemK
                 ? (ci * T::kIH + dy) * T::kIW + (dx % S) * T::kPS + dx / S
                 : G::kPlane;
  }
  for (int e = tid; e < 2 * (G::kPlaneStride - G::kPlane);
       e += kStemThreads) {
    const int z = G::kPlaneStride - G::kPlane;
    planes[(e / z) * G::kPlaneStride + G::kPlane + e % z] = 0;
  }

  // ---- fragment geometry: m-tile i of warp wm as in the fp32 kernel;
  // lane (g, t)'s A registers at k-step s hold rows g, g + 8 at k 16s + 2t,
  // + 1 and 16s + 2t + 8, + 9, gathered through tab.
  int pbase[kStemMT];
#pragma unroll
  for (int i = 0; i < kStemMT; ++i) {
    const int mt = wm * kStemMT + i;
    pbase[i] = (mt / (kStemTW / 16)) * S * T::kIW +
               (mt % (kStemTW / 16)) * 16 + g;
  }
  const int b_row = wn * 8 * kStemNT + (lane & 7) + ((lane >> 4) << 3);
  const uint32_t b_off = row_off(b_row, (lane >> 3) & 1);

  int buf = 0;
  if (blockIdx.x < total) store(0);
  __syncthreads();

  for (int tile = blockIdx.x; tile < total; tile += gridDim.x, buf ^= 1) {
    const int next = tile + gridDim.x;
    if (next < total) load(next);  // in flight during the products
    const unsigned short* ph = planes + buf * G::kPlaneStride;
    float acc[kStemMT][kStemNT][4];
#pragma unroll
    for (int i = 0; i < kStemMT; ++i)
#pragma unroll
      for (int j = 0; j < kStemNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll 1
    for (int s0 = 0; s0 < kStemKStepsB; s0 += kStemGroup) {
      float f[kStemMT][kStemNT][4];  // these k-steps' fresh partial sums
#pragma unroll
      for (int ss = 0; ss < kStemGroup; ++ss) {
        const int s = s0 + ss;
        if (s >= kStemKStepsB) break;
        const uint32_t blk = sw + s * kStemTapBytesB;
        uint32_t bq[kStemNT / 2][2][2];
#pragma unroll
        for (int jp = 0; jp < kStemNT / 2; ++jp)
          ldmatrix_x4(bq[jp][0][0], bq[jp][0][1], bq[jp][1][0], bq[jp][1][1],
                      blk + b_off + 16 * jp * kRow);
        const int o0 = tab[16 * s + 2 * t], o1 = tab[16 * s + 2 * t + 1];
        const int o2 = tab[16 * s + 2 * t + 8], o3 = tab[16 * s + 2 * t + 9];
#pragma unroll
        for (int i = 0; i < kStemMT; ++i) {
          const int q = pbase[i];
          const uint32_t af[4] = {
              ph[q + o0] | ((uint32_t)ph[q + o1] << 16),
              ph[q + 8 + o0] | ((uint32_t)ph[q + 8 + o1] << 16),
              ph[q + o2] | ((uint32_t)ph[q + o3] << 16),
              ph[q + 8 + o2] | ((uint32_t)ph[q + 8 + o3] << 16)};
#pragma unroll
          for (int j = 0; j < kStemNT; ++j)
            mma_bf16(f[i][j], af, bq[j / 2][j % 2][0], bq[j / 2][j % 2][1],
                     ss == 0);
        }
      }
#pragma unroll
      for (int i = 0; i < kStemMT; ++i)
#pragma unroll
        for (int j = 0; j < kStemNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += f[i][j][e];
    }

    // ---- + the bf16 bias in fp32, the bf16 store, the fp32 sums of the
    // unrounded values; reduced as in the fp32 kernel (fixed order).
    int b, oy0, ox0;
    tile_at(tile, b, oy0, ox0);
    const bool sums = a.partials != nullptr;
    float* rb = red + buf * (kStemWarpsM * 2 * kStemOut);
#pragma unroll
    for (int j = 0; j < kStemNT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = wn * 8 * kStemNT + 8 * j + 2 * t + e;
        const float bv = __bfloat162float(a.bias[n]);
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int i = 0; i < kStemMT; ++i)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int mt = wm * kStemMT + i;
            const int oy = oy0 + mt / (kStemTW / 16);
            const int ox = ox0 + (mt % (kStemTW / 16)) * 16 + g + 8 * half;
            if (oy >= a.ho || ox >= a.wo) continue;
            const float v = acc[i][j][2 * half + e] + bv;
            a.y[(((long)b * kStemOut + n) * a.ho + oy) * a.wo + ox] =
                __float2bfloat16_rn(v);
            s1 += v;
            s2 = fmaf(v, v, s2);
          }
        if (sums) {
#pragma unroll
          for (int m = 4; m < 32; m <<= 1) {
            s1 += __shfl_xor_sync(0xffffffffu, s1, m);
            s2 += __shfl_xor_sync(0xffffffffu, s2, m);
          }
          if (g == 0) {
            rb[(wm * 2 + 0) * kStemOut + n] = s1;
            rb[(wm * 2 + 1) * kStemOut + n] = s2;
          }
        }
      }
    if (next < total) store(buf ^ 1);  // the next tile's plane
    __syncthreads();
    if (sums && tid < 2 * kStemOut) {
      const int n = tid % kStemOut, kind = tid / kStemOut;
      float s = rb[kind * kStemOut + n];
#pragma unroll
      for (int w = 1; w < kStemWarpsM; ++w)
        s += rb[(w * 2 + kind) * kStemOut + n];
      a.partials[((long)tile * 2 + kind) * kStemOut + n] = s;
    }
  }
}

}  // namespace

// Rows 13 (stride 1) and 12 (stride 2).  x (B, 3, H, W); w (64, 3, 7, 7)
// OIHW; bias (64); y (B, 64, Ho, Wo), Ho = (H - 1) / stride + 1 (and Wo
// alike): fp32, or bf16 with `bf16` set; partials (B, nb, 2, 64) scratch
// and stats (B, 2, 64) fp32, both null without statistics, nb =
// ceil(Ho/8) * ceil(Wo/32).  All contiguous.  Returns the CUDA error code
// of the launches (0 on success).
extern "C" int enc_stem7_tc_forward(const void* x, const void* w,
                                    const void* bias, void* y,
                                    float* partials, float* stats, int batch,
                                    int h, int win, int stride, int nb,
                                    int bf16, void* stream) {
  if (batch < 1 || h < 1 || win < 1 || (stride != 1 && stride != 2))
    return (int)cudaErrorInvalidValue;
  const int ho = (h - 1) / stride + 1, wo = (win - 1) / stride + 1;
  const int tiles_w = (wo + kStemTW - 1) / kStemTW;
  if (nb != ((ho + kStemTH - 1) / kStemTH) * tiles_w ||
      (long)batch * nb > 0x7fffffffL ||
      (stats == nullptr) != (partials == nullptr))
    return (int)cudaErrorInvalidValue;
  static int grid_max[2][2];  // [bf16][stride - 1], at the first launch
  int& gm = grid_max[bf16 != 0][stride - 1];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const StemArgsB a{static_cast<const unsigned short*>(x),
                      static_cast<const unsigned short*>(w),
                      static_cast<const __nv_bfloat16*>(bias),
                      static_cast<__nv_bfloat16*>(y), partials, batch, h, win,
                      ho, wo, tiles_w, nb};
    return stride == 1 ? launch_stem7(stem7_bf16_kernel<1>,
                                      StemTileB<1>::kSmem, gm, a, stats, s)
                       : launch_stem7(stem7_bf16_kernel<2>,
                                      StemTileB<2>::kSmem, gm, a, stats, s);
  }
  const StemArgs a{static_cast<const float*>(x), static_cast<const float*>(w),
                   static_cast<const float*>(bias), static_cast<float*>(y),
                   partials, batch, h, win, ho, wo, tiles_w, nb};
  return stride == 1 ? launch_stem7(stem7_tc_kernel<1>, StemTile<1>::kSmem, gm,
                                    a, stats, s)
                     : launch_stem7(stem7_tc_kernel<2>, StemTile<2>::kSmem, gm,
                                    a, stats, s);
}
