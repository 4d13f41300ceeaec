// The fused encoder's 7x7 conv1 for Hopper (sm_90a), fp32: direct
// convolution of the raw image -> + bias -> raw output, with the optional
// per-(image, channel) fp32 sum and sum of squares of that raw output.
//
// Replaces the TPU kernels of the fused encoder stem:
//   raftstereo_tpu/ops/pallas_encoder.py `_stem7_kernel` (7x7 stride-1
//   conv1 of the image, row 13), `_stem7s2_kernel` (7x7 stride 2, row 12).
// (The stages' 3x3 convs, rows 9, 15 and 16, run on the tensor cores:
// csrc/enc_conv_tc.cu.)
// Function, NCHW, per output pixel and channel:
//   y = bias + sum_{ci,dy,dx} w[ci,dy,dx,co] * x[ci, oy*S+dy-P, ox*S+dx-P]
// with x zero outside the image.  Statistics are of the fp32 output
// including the bias, per block in registers and shared memory,
// then one fixed-order reduction kernel over the blocks' partial sums: no
// floating-point atomics, so two calls are bitwise equal, and no single
// running sum over the 552,960 pixels of an image.
//
// Design (a simple first form).  One block of 256 threads computes an
// 8x32 tile of output pixels for 32 output channels; each thread holds 4
// pixels (columns c, c+8, c+16, c+24 of one tile row) x 8 channels in
// registers.  The image's 3 channels and their halo tile and the weights
// are staged in shared memory, then each (channel, tap) step costs a
// thread 4 scalar loads, 2 broadcast 16-byte weight loads and 32 FMAs.
// fp32 FMAs only (no tensor cores).
//
// Bound on an H100 SXM (67 TFLOP/s fp32 outside the tensor cores, 3.35
// TB/s): a 7x7 conv1 over a 576x960 image is 10.4 GFLOP against 28 MB
// moved, so operations bound it (0.16 ms per image).  What this design
// does about it: each input element is read from device memory about
// once per block (plus halo) and reused from shared memory across 32
// output channels and 49 taps; the statistics ride along, so the norm
// after conv1 never costs its own pass over the tensor.

#include <cuda_runtime.h>

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

}  // namespace

// x (B, Cin, H, W); w (Cin, ks, ks, Cout); bias (Cout); y (B, Cout, Ho,
// Wo) with Ho = (H + 2*(ks/2) - ks)/stride + 1 (and Wo alike); partials
// (B, nb, 2, Cout) scratch and stats (B, 2, Cout), both null without
// statistics, nb = ceil(Ho/8) * ceil(Wo/32).  All fp32 and contiguous;
// Cout a multiple of 32.  Supported (ks, stride): (7, 1|2).  Returns the
// CUDA error code of the launches (0 on success).
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
  if (ks == 7 && stride == 1) return launch<7, 1>(a, batch, stats, s);
  if (ks == 7 && stride == 2) return launch<7, 2>(a, batch, stats, s);
  return (int)cudaErrorInvalidValue;
}
