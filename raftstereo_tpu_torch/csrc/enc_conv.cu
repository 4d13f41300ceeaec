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
//   y = bias + sum_{ci,dy,dx} w[co,ci,dy,dx] * x[ci, oy*S+dy-P, ox*S+dx-P]
// with x zero outside the image.  Statistics are of the fp32 output
// including the bias, one partial per (image, 8x32 output tile) from
// registers and shared memory, then one fixed-order reduction kernel over
// the tiles' partials: no floating-point atomics, so two calls are
// bitwise equal, and no single running sum over the 552,960 pixels of an
// image.
//
// Row 13 (stride 1, 3 -> 64 channels): an implicit GEMM of 3xTF32
// `mma.sync.m16n8k8` tiles, M = output pixels, N = the 64 outputs, K = 3
// channels x 49 taps in the weights' own order (ci, dy, dx), padded from
// 147 to 152: 19 k-steps of 8.
//   - Persistent blocks (as many as fit the SMs: one), each walking 8x32
//     output tiles of all 64 outputs.  A block splits the weights once
//     into TF32 hi and lo planes in shared memory (78 KB: per k-step 64
//     rows of 8 values, the two 16-byte halves of a row swapped where bit
//     2 of the output index is set, so `ldmatrix` reads B without bank
//     conflicts; the pad k zero), and keeps them for its life.
//   - Per tile the whole haloed input, 3 x 14 x 38 values, is split once
//     into hi and lo planes (not once per tap); the next tile's raw values
//     arrive by 4-byte `cp.async` (zero outside the image) while the tile
//     before runs its products, and are split into the other plane buffer.
//   - A fragments are gathered: a table in shared memory gives each k its
//     plane offset, (ci * 14 + dy) * 38 + dx, and lane (g, t) of a 16-pixel
//     m-tile reads its pixel rows g and g + 8 at k 8s + t and 8s + t + 4
//     (8 scalar shared loads a fragment, hi and lo).  A pad k's offset
//     points into zeros past the plane, so it never multiplies an image
//     value.  (K ordered (dy, ci, dx) with dx padded to 8, 21 k-steps whose
//     8 k are 8 consecutive columns, was 3.5% slower: PERF.md section 6.)
//   - Warps 8 (pixels) x 2 (outputs), each 2 m-tiles x 4 n-tiles: 16 warps
//     at 125 registers, against 8 warps of 4 m-tiles at 204 (5% slower).
//     Each product is a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (hi =
//     cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi)); every 4 k-steps sum
//     into fresh accumulators, added to the running total by fp32 adds
//     (the tensor cores truncate as they accumulate).  A single TF32 pass
//     would not keep fp32 accuracy (emulated on the CPU:
//     tests/test_torch_port_stem_tc.py).
//   - Outputs are stored from the fragments: the 8 lanes of a column write
//     8 consecutive pixels of one output row, whole 32-byte sectors.
// Row 12 (stride 2) is a direct convolution on the CUDA cores: a block of
// 256 threads computes an 8x32 output tile for 32 output channels, each
// thread 4 pixels x 8 channels in registers, the image's 3 channels with
// their halo and the weights staged in shared memory.
//
// Bound on an H100 SXM (495 TFLOP/s TF32 dense on the tensor cores, so
// fp32 as 3xTF32 at 165; 67 TFLOP/s fp32 on the CUDA cores; 3.35 TB/s):
// a 7x7 3->64 conv1 over a 576x960 image is 10.4 GFLOP of products
// against 148 MB moved (the fp32 output), so as 3xTF32 it is bound by
// operations at 0.063 ms per image (bytes 0.044 ms; 0.16 ms on the CUDA
// cores); row 12 at the same input is 2.6 GFLOP against 42 MB, 0.039 ms per
// image on the CUDA cores.  What holds row 13's design back from that:
// `mma.sync` issues at a fraction of `wgmma`'s rate; the A fragments are 8
// scalar shared loads per m-tile and k-step (a sliding window's rows are
// not 16-byte aligned for `ldmatrix`), in whose gathers lanes of different
// k can meet in a bank; one block of 16 warps per SM (the resident weights
// take 78 KB) hides little latency; a tile's stores and the next tile's
// split run between barriers while the tensor cores wait.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileH = 8;      // output rows per block
constexpr int kTileW = 32;     // output columns per block
constexpr int kCoutTile = 32;  // output channels per block
constexpr int kPix = 4;        // output pixels per thread
constexpr int kCo = 8;         // output channels per thread

// Input channels per shared-memory chunk (the image's 3), and the staged
// tile geometry.  Rows are padded to 8 mod 32 floats so the 4 tile rows a
// warp reads fall in disjoint banks at stride 1.
template <int KS, int S>
struct Cfg {
  static constexpr int kIn = 3;
  static constexpr int kInH = (kTileH - 1) * S + KS;
  static constexpr int kInW = (kTileW - 1) * S + KS;
  static constexpr int kInWP = ((kInW + 23) / 32) * 32 + 8;
};

struct Args {
  const float* x;   // (B, Cin, H, W)
  const float* wt;  // (Cin, KS, KS, Cout)
  const float* bias;  // (Cout)
  float* y;         // (B, Cout, Ho, Wo)
  float* partials;  // (B, nb, 2, Cout) per-block sums, or null (no stats)
  int cin, h, win, cout, ho, wo, tiles_w, nb;
};

template <int KS, int S>
__global__ void __launch_bounds__(kThreads, 2)
enc_conv_kernel(const Args a) {
  using C = Cfg<KS, S>;
  constexpr int kTaps = KS * KS;
  constexpr int kNv = 2 * kCo;  // stats values per thread
  __shared__ __align__(16) float s_w[C::kIn * kTaps * kCoutTile];
  __shared__ __align__(16) float s_in[C::kIn * C::kInH * C::kInWP];
  __shared__ float s_red[kThreads / 32][kNv];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z;
  const int co0 = blockIdx.y * kCoutTile;
  const int ty0 = (blockIdx.x / a.tiles_w) * kTileH;
  const int tx0 = (blockIdx.x % a.tiles_w) * kTileW;
  const int iy0 = ty0 * S - KS / 2, ix0 = tx0 * S - KS / 2;
  const int cg = warp >> 1;                         // channels cg*8 .. +7
  const int pr = (warp & 1) * 4 + (lane >> 3);      // tile row
  const int pc = lane & 7;                          // columns pc + 8j

  float acc[kPix][kCo];
#pragma unroll
  for (int j = 0; j < kPix; ++j)
#pragma unroll
    for (int k = 0; k < kCo; ++k) acc[j][k] = 0.f;

  for (int c0 = 0; c0 < a.cin; c0 += C::kIn) {
    __syncthreads();  // the previous chunk's reads are done
    for (int i = tid; i < C::kIn * C::kInH * C::kInW; i += kThreads) {
      const int ci = i / (C::kInH * C::kInW);
      const int rem = i - ci * (C::kInH * C::kInW);
      const int yy = rem / C::kInW, xx = rem - yy * C::kInW;
      const int c = c0 + ci, gy = iy0 + yy, gx = ix0 + xx;
      float v = 0.f;  // outside the image (or past Cin)
      if (c < a.cin && gy >= 0 && gy < a.h && gx >= 0 && gx < a.win)
        v = __ldg(a.x + ((long)(b * a.cin + c) * a.h + gy) * a.win + gx);
      s_in[(ci * C::kInH + yy) * C::kInWP + xx] = v;
    }
    for (int i = tid; i < C::kIn * kTaps * kCoutTile; i += kThreads) {
      const int ci = i / (kTaps * kCoutTile);
      const int rem = i - ci * (kTaps * kCoutTile);  // tap * 32 + co
      const int c = c0 + ci;
      s_w[i] = c < a.cin
          ? __ldg(a.wt + ((long)c * kTaps + rem / kCoutTile) * a.cout + co0 +
                  rem % kCoutTile)
          : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int ci = 0; ci < C::kIn; ++ci) {
      const float* in = s_in + (ci * C::kInH + pr * S) * C::kInWP + pc * S;
      const float* wv = s_w + ci * kTaps * kCoutTile + cg * kCo;
#pragma unroll
      for (int dy = 0; dy < KS; ++dy) {
#pragma unroll
        for (int dx = 0; dx < KS; ++dx) {
          const float4 w0 =
              *reinterpret_cast<const float4*>(wv + (dy * KS + dx) * kCoutTile);
          const float4 w1 = *reinterpret_cast<const float4*>(
              wv + (dy * KS + dx) * kCoutTile + 4);
          const float wk[kCo] = {w0.x, w0.y, w0.z, w0.w,
                                 w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int j = 0; j < kPix; ++j) {
            const float v = in[dy * C::kInWP + dx + 8 * S * j];
#pragma unroll
            for (int k = 0; k < kCo; ++k) acc[j][k] = fmaf(v, wk[k], acc[j][k]);
          }
        }
      }
    }
  }

  // Epilogue: + bias, store, and this thread's sums over its 4 pixels.
  const int oy = ty0 + pr;
  float sv[kNv];
#pragma unroll
  for (int k = 0; k < kCo; ++k) {
    const int co = co0 + cg * kCo + k;
    const float bv = __ldg(a.bias + co);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const int ox = tx0 + pc + 8 * j;
      const float v = acc[j][k] + bv;
      if (oy < a.ho && ox < a.wo) {
        a.y[(((long)b * a.cout + co) * a.ho + oy) * a.wo + ox] = v;
        s1 += v;
        s2 = fmaf(v, v, s2);
      }
    }
    sv[k] = s1;
    sv[kCo + k] = s2;
  }
  if (a.partials == nullptr) return;  // uniform over the grid

  // Block sums: a butterfly over each warp's 32 pixel groups, then the two
  // warps of a channel group in order.  Fixed order: bitwise repeatable.
#pragma unroll
  for (int v = 0; v < kNv; ++v) {
    float s = sv[v];
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
    if (lane == 0) s_red[warp][v] = s;
  }
  __syncthreads();
  if (tid < 2 * kCoutTile) {
    const int co = tid % kCoutTile;
    const int kind = tid / kCoutTile;
    const int g = co / kCo, v = kind * kCo + co % kCo;
    const float s = s_red[2 * g][v] + s_red[2 * g + 1][v];
    a.partials[(((long)b * a.nb + blockIdx.x) * 2 + kind) * a.cout + co0 +
               co] = s;
  }
}

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

template <int KS, int S>
int launch(const Args& a, int batch, float* stats, cudaStream_t st) {
  const dim3 grid(a.nb, a.cout / kCoutTile, batch);
  enc_conv_kernel<KS, S><<<grid, kThreads, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || stats == nullptr) return (int)e;
  const int ch2 = 2 * a.cout;
  const int total = batch * ch2;
  enc_conv_stats_kernel<<<(total + 7) / 8, 256, 0, st>>>(a.partials, stats,
                                                         a.nb, ch2, total);
  return (int)cudaGetLastError();
}

// ------------------------------------------ row 13: the stride-1 stem, 3xTF32

constexpr int kStemIn = 3, kStemOut = 64, kStemKS = 7;
constexpr int kStemWarpsM = 8, kStemWarpsN = 2;
constexpr int kStemMT = 2, kStemNT = 4;  // m-tiles, n-tiles per warp
constexpr int kStemThreads = 32 * kStemWarpsM * kStemWarpsN;
constexpr int kStemTH = kTileH, kStemTW = kTileW;  // the 8x32 output tile
constexpr int kStemIH = kStemTH + kStemKS - 1;     // haloed input tile
constexpr int kStemIW = kStemTW + kStemKS - 1;
constexpr int kStemPlane = kStemIn * kStemIH * kStemIW;  // values a plane
constexpr int kStemK = kStemIn * kStemKS * kStemKS;  // 147, (ci, dy, dx)
constexpr int kStemKSteps = (kStemK + 7) / 8;          // 19 of 8
constexpr int kStemGroup = 4;  // k-steps summed into one fresh accumulator
constexpr int kZeros = 320;    // zeros past each plane: the pad k's reads
constexpr int kRow = 32;                  // bytes: a row of 8 TF32 values
constexpr int kStemTapBytes = 2 * kStemOut * kRow;  // a k-step's hi, lo
constexpr int kStemWBytes = kStemKSteps * kStemTapBytes;
constexpr int kStemIPT = (kStemPlane + kStemThreads - 1) / kStemThreads;
constexpr int kStemPlaneStride = kStemPlane + kZeros;
constexpr int kStemPlanesBytes = 2 * 2 * kStemPlaneStride * 4;  // 2 x hi, lo
constexpr int kStemRawBytes = kStemIPT * kStemThreads * 4;
constexpr int kStemRedBytes = 2 * kStemWarpsM * 2 * kStemOut * 4;
constexpr int kStemTabBytes = 8 * kStemKSteps * 4;
constexpr int kStemSmem = kStemWBytes + kStemPlanesBytes + kStemRawBytes +
                          kStemRedBytes + kStemTabBytes;
static_assert(kStemWarpsM * kStemMT * 16 == kStemTH * kStemTW,
              "the warps' m-tiles cover the tile");
static_assert(kStemWarpsN * kStemNT * 8 == kStemOut, "all 64 outputs");
static_assert(kZeros >= (kStemTH - 1) * kStemIW + kStemTW,
              "a pad k's reads, from any pixel of the tile, stay in zeros");

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

struct StemArgs {
  const float* x;     // (B, 3, H, W)
  const float* w;     // (64, 3, 7, 7), OIHW
  const float* bias;  // (64)
  float* y;           // (B, 64, H, W)
  float* partials;    // (B, nb, 2, 64) per-tile sums, or null (no stats)
  int batch, h, win, tiles_w, nb;
};

__global__ void __launch_bounds__(kStemThreads, 1)
stem7_tc_kernel(const StemArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kStemWarpsN, wn = warp % kStemWarpsN;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t sw = sbase;  // the weights' k-step blocks
  uint32_t* planes = reinterpret_cast<uint32_t*>(smem + kStemWBytes);
  const uint32_t raw = sbase + kStemWBytes + kStemPlanesBytes;
  float* red = reinterpret_cast<float*>(smem + kStemWBytes +
                                        kStemPlanesBytes + kStemRawBytes);
  int* tab = reinterpret_cast<int*>(smem + kStemSmem - kStemTabBytes);
  const int total = a.batch * a.nb;

  // ---- once per block: the weights, k = ci * 49 + dy * 7 + dx (OIHW's
  // own order) at k-step k / 8, slot k % 8 of row n, split into hi and lo
  // planes, the pad k (147 .. 151) zero; the gather table, tab[k] = the
  // plane offset of k's (ci, dy, dx) (a pad k's: the zeros past the
  // plane); and those zeros.
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
    tab[k] = k < kStemK
                 ? (ci * kStemIH + tap / kStemKS) * kStemIW + tap % kStemKS
                 : kStemPlane;
  }
  for (int e = tid; e < 2 * 2 * kZeros; e += kStemThreads)
    planes[(e / kZeros) * kStemPlaneStride + kStemPlane + e % kZeros] = 0u;

  // ---- a tile's input: item it = (ci, raw row, raw column); each thread
  // copies its items' values into its own 4-byte slots (zero outside the
  // image), then after its own wait splits them into a plane buffer.  The
  // item index is opaque to the compiler, so that it recomputes the
  // item's indices instead of holding them through the products.
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
    for (int s = 0; s < kStemIPT; ++s) {
      int it = tid + s * kStemThreads;
      asm volatile("" : "+r"(it));
      if (it >= kStemPlane) break;
      const int ci = it / (kStemIH * kStemIW);
      const int p = it - ci * (kStemIH * kStemIW);
      const int gy = oy0 - kStemKS / 2 + p / kStemIW;
      const int gx = ox0 - kStemKS / 2 + p % kStemIW;
      const bool ok = gy >= 0 && gy < a.h && gx >= 0 && gx < a.win;
      const long off =
          ok ? (((long)b * kStemIn + ci) * a.h + gy) * a.win + gx : 0;
      cp_async4(raw + (s * kStemThreads + tid) * 4, a.x + off, ok);
    }
  };
  auto store = [&](int buf) {
    uint32_t* hi = planes + buf * 2 * kStemPlaneStride;
#pragma unroll
    for (int s = 0; s < kStemIPT; ++s) {
      int it = tid + s * kStemThreads;
      asm volatile("" : "+r"(it));
      if (it >= kStemPlane) break;
      const float v = *reinterpret_cast<const float*>(
          smem + kStemWBytes + kStemPlanesBytes + (s * kStemThreads + tid) * 4);
      split(v, hi[it], hi[kStemPlaneStride + it]);
    }
  };

  // ---- fragment geometry: m-tile i of warp wm is tile row ly, columns
  // lx .. lx + 15; lane (g, t)'s A values at k-step s are the plane's
  // values pbase[i] + {tab[8s + t], 8 + tab[8s + t], tab[8s + t + 4],
  // 8 + tab[8s + t + 4]} (rows g, g + 8 by k t, t + 4).
  int pbase[kStemMT];
#pragma unroll
  for (int i = 0; i < kStemMT; ++i) {
    const int mt = wm * kStemMT + i;
    pbase[i] = (mt / (kStemTW / 16)) * kStemIW + (mt % (kStemTW / 16)) * 16 +
               g;
  }
  const int b_row = wn * 8 * kStemNT + (lane & 7) + ((lane >> 4) << 3);
  const uint32_t b_off = row_off(b_row, (lane >> 3) & 1);

  int buf = 0;
  if (blockIdx.x < total) {
    load(blockIdx.x);
    cp_async_wait_all();
    store(0);
  }
  __syncthreads();

  for (int tile = blockIdx.x; tile < total; tile += gridDim.x, buf ^= 1) {
    const int next = tile + gridDim.x;
    if (next < total) load(next);  // in flight during the products
    const uint32_t* ph = planes + buf * 2 * kStemPlaneStride;
    const uint32_t* pl = ph + kStemPlaneStride;
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
    // g into red[buf][wm][kind][n]; after the barrier the 4 pixel warps
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
            if (oy >= a.h || ox >= a.win) continue;
            const float v = acc[i][j][2 * half + e] + bv;
            a.y[(((long)b * kStemOut + n) * a.h + oy) * a.win + ox] = v;
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

int launch_stem7_tc(const StemArgs& a, float* stats, cudaStream_t st) {
  static int grid_max = 0;  // persistent blocks: as many as fit the SMs
  if (grid_max == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        stem7_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kStemSmem);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0, per_sm = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, stem7_tc_kernel, kStemThreads, kStemSmem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    grid_max = sms * per_sm;
  }
  const int total = a.batch * a.nb;
  stem7_tc_kernel<<<total < grid_max ? total : grid_max, kStemThreads,
                    kStemSmem, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || stats == nullptr) return (int)e;
  const int ch2 = 2 * kStemOut;
  const int n = a.batch * ch2;
  enc_conv_stats_kernel<<<(n + 7) / 8, 256, 0, st>>>(a.partials, stats, a.nb,
                                                     ch2, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Row 12.  x (B, Cin, H, W); w (Cin, ks, ks, Cout); bias (Cout); y (B,
// Cout, Ho, Wo) with Ho = (H + 2*(ks/2) - ks)/stride + 1 (and Wo alike);
// partials (B, nb, 2, Cout) scratch and stats (B, 2, Cout), both null
// without statistics, nb = ceil(Ho/8) * ceil(Wo/32).  All fp32 and
// contiguous; Cout a multiple of 32.  Supported (ks, stride): (7, 2).
// Returns the CUDA error code of the launches (0 on success).
extern "C" int enc_conv_forward(const float* x, const float* w,
                                const float* bias, float* y, float* partials,
                                float* stats, int batch, int cin, int h,
                                int win, int cout, int ks, int stride, int nb,
                                void* stream) {
  const int pad = ks / 2;
  const int ho = (h + 2 * pad - ks) / stride + 1;
  const int wo = (win + 2 * pad - ks) / stride + 1;
  const int tiles_w = (wo + kTileW - 1) / kTileW;
  if (batch < 1 || cin < 1 || ho < 1 || wo < 1 || cout % kCoutTile != 0 ||
      nb != ((ho + kTileH - 1) / kTileH) * tiles_w ||
      (stats == nullptr) != (partials == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{x, w, bias, y, partials, cin, h, win, cout, ho, wo,
               tiles_w, nb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ks == 7 && stride == 2) return launch<7, 2>(a, batch, stats, s);
  return (int)cudaErrorInvalidValue;
}

// Row 13.  x (B, 3, H, W); w (64, 3, 7, 7) OIHW; bias (64); y (B, 64, H,
// W); partials (B, nb, 2, 64) scratch and stats (B, 2, 64), both null
// without statistics, nb = ceil(H/8) * ceil(W/32).  All fp32 and
// contiguous.  Returns the CUDA error code of the launches (0 on success).
extern "C" int enc_stem7_tc_forward(const float* x, const float* w,
                                    const float* bias, float* y,
                                    float* partials, float* stats, int batch,
                                    int h, int win, int nb, void* stream) {
  const int tiles_w = (win + kStemTW - 1) / kStemTW;
  if (batch < 1 || h < 1 || win < 1 ||
      nb != ((h + kStemTH - 1) / kStemTH) * tiles_w ||
      (long)batch * nb > 0x7fffffffL ||
      (stats == nullptr) != (partials == nullptr))
    return (int)cudaErrorInvalidValue;
  const StemArgs a{x, w, bias, y, partials, batch, h, win, tiles_w, nb};
  return launch_stem7_tc(a, stats, static_cast<cudaStream_t>(stream));
}
