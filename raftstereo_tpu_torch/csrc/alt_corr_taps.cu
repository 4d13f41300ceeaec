// On-demand all-level correlation lookup at caller-given taps, for Hopper
// (sm_90a): fp32 or bf16 feature maps in, fp32 or bf16 features out.
//
// Replaces the TPU kernel raftstereo_tpu/ops/pallas_alt.py
// `_alt_pyr_fwd_kernel`, launched from `_alt_pyr_fwd_impl` (the forward of
// the custom VJP `_make_alt_pyr`, behind `pallas_alt_lookup`,
// `pallas_alt_lookup_flat` and `pallas_alt_pyramid_flat`).  Function: for
// every pixel (n, x1) of a flattened row n and every tap q = l*K + k of
// level l (local coordinate t = taps[n, x1, q], level width w_l),
//   out[n, x1, q] = sum_{j in [0, w_l)} M_l[j] * max(0, 1 - |j - t|),
//   M_l[j] = <fmap1[n, x1, :], fmap2_l[n, j, :]> / sqrt(C).
// The hat is nonzero at two columns at most: j0 = floor(t) with weight
// 1 - f and j0 + 1 with weight f, f = t - j0.  So a tap in (-1, w_l) reads
// the columns of {j0, j0 + 1} that lie inside the level, a tap outside
// (including +-inf) gives 0, and a NaN tap gives NaN (as the TPU's dense
// hat does: max(0, NaN) is NaN on every column).  The hat weight 1-|j-t|
// and the lerp weight agree up to fp32 rounding.  Accumulation is fp32
// FMAs (no TF32); bf16 feature maps are widened exactly; a bf16 output is
// the fp32 result rounded once.
//
// Design.  The TPU kernel computes whole (block x W2cat) correlation rows
// on its matrix unit and sweeps a dense hat per tap.  Here one warp owns
// one pixel: each lane holds C/32 channels of fmap1 in registers (the
// first 512 channels; any beyond come through the caches) and reads
// its slice of each fmap2 row with 16-byte loads, reduced across the warp
// with shuffles.  Taps are independent, so unlike the radial lookup
// (alt_corr.cu) there is no shared window.  The columns are not
// deduplicated in shared memory: each tap's two columns are checked
// against the previous tap's two (kept in registers, a warp-uniform test)
// and only new ones are computed.  Radial-pattern taps (t, t+1, ...) then
// cost one new dot each, L*(K+1) per pixel; scattered taps cost up to
// 2*L*K row reads and dots per pixel, served mostly from L1/L2.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): at 144 rows of 240 pixels, C=256, level widths 240/120/60/30 and
// 36 taps, the call must read fmap1 (35.4 MB), the fmap2 pyramid (66.4 MB)
// and the taps (5.0 MB) and write the output (5.0 MB): about 112 MB, 33 us.
// The dots are at most 2*36*256*2 FLOPs per pixel (1.3 GFLOP, 19 us), so
// it is bound by bytes.  What this design does about it: each fmap1
// element is read once (registers), fmap2 rows go through the caches, and
// nothing but the output is written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarpsPerBlock = 8;

struct Levels {
  int n;
  int off[kMaxLevels];    // first column of level l in the concatenated W2
  int width[kMaxLevels];  // width w_l of level l
};

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int V = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename TIn, bool kWide>
struct Row {
  static constexpr int V = Vec<TIn>::V;
  static constexpr int kChunk = 32 * V;
  static constexpr int kMaxChunks = 512 / kChunk;
  float a[kMaxChunks][V];  // this lane's first 512 channels of fmap1
  const TIn* p1;           // fmap1 pixel, offset to this lane's channels
  const TIn* f2row;        // fmap2 row n, offset to this lane's channels
  int c, nchunk;
  float scale;

  // <fmap1[pix], fmap2[n, col]> * scale, identical on every lane.
  __device__ __forceinline__ float dot(int col) const {
    const TIn* p2 = f2row + (long)col * c;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxChunks; ++i) {
      if (i < nchunk) {
        float b[V];
        Vec<TIn>::load(p2 + i * kChunk, b);
#pragma unroll
        for (int v = 0; v < V; ++v) s = fmaf(a[i][v], b[v], s);
      }
    }
    for (int i = kMaxChunks; kWide && i < nchunk; ++i) {  // C > 512: caches
      float x[V], b[V];
      Vec<TIn>::load(p1 + i * kChunk, x);
      Vec<TIn>::load(p2 + i * kChunk, b);
#pragma unroll
      for (int v = 0; v < V; ++v) s = fmaf(x[v], b[v], s);
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
    return __fmul_rn(s, scale);
  }
};

template <typename TIn, typename TOut, bool kWide>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
alt_corr_taps_kernel(const TIn* __restrict__ f1, const TIn* __restrict__ f2,
                     const float* __restrict__ taps, TOut* __restrict__ out,
                     long npix, int w1, int w2cat, int c, int kk, float scale,
                     Levels lv) {
  using R = Row<TIn, kWide>;
  const int lane = threadIdx.x & 31;
  const long pix = (long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pix >= npix) return;  // whole warps exit together
  R row;
  row.c = c;
  row.nchunk = c / R::kChunk;
  row.scale = scale;
  row.p1 = f1 + pix * c + lane * R::V;
#pragma unroll
  for (int i = 0; i < R::kMaxChunks; ++i)
    if (i < row.nchunk) Vec<TIn>::load(row.p1 + i * R::kChunk, row.a[i]);
  row.f2row = f2 + (pix / w1) * (long)w2cat * c + lane * R::V;

  const int lk = lv.n * kk;
  const float* tp = taps + pix * lk;
  TOut* o = out + pix * lk;
  for (int l = 0; l < lv.n; ++l) {
    const int off = lv.off[l], w = lv.width[l];
    // The previous tap's columns and their dots (-2: none).
    int ca = -2, cb = -2;
    float va = 0.f, vb = 0.f;
    for (int k = 0; k < kk; ++k) {
      const float t = tp[l * kk + k];  // the same address on every lane
      float r = 0.f;
      if (isnan(t)) {
        if (w > 0) r = NAN;
      } else if (t > -1.f && t < (float)w) {
        const float b0 = floorf(t);
        const float f = t - b0;
        const int j0 = (int)b0;  // in [-1, w - 1]
        float v[2];
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          const int j = j0 + d;
          if (j < 0 || j >= w) {
            v[d] = 0.f;
          } else if (j == ca) {
            v[d] = va;
          } else if (j == cb) {
            v[d] = vb;
          } else {
            v[d] = row.dot(off + j);
          }
        }
        ca = j0;
        va = v[0];
        cb = j0 + 1;
        vb = v[1];
        // Two products and a sum, each rounded: the plain version's order.
        r = __fadd_rn(__fmul_rn(v[0], __fsub_rn(1.f, f)), __fmul_rn(v[1], f));
      }
      if (lane == 0) put(o + l * kk + k, r);
    }
  }
}

template <typename TIn, typename TOut>
int launch(const void* f1, const void* f2, const float* taps, void* out,
           long npix, int w1, int w2cat, int c, int kk, float scale,
           const Levels& lv, cudaStream_t stream) {
  const unsigned blocks =
      (unsigned)((npix + kWarpsPerBlock - 1) / kWarpsPerBlock);
  // C <= 512, the model's widths, keeps the register-only form.
  if (c > 512)
    alt_corr_taps_kernel<TIn, TOut, true>
        <<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
            static_cast<const TIn*>(f1), static_cast<const TIn*>(f2), taps,
            static_cast<TOut*>(out), npix, w1, w2cat, c, kk, scale, lv);
  else
    alt_corr_taps_kernel<TIn, TOut, false>
        <<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
            static_cast<const TIn*>(f1), static_cast<const TIn*>(f2), taps,
            static_cast<TOut*>(out), npix, w1, w2cat, c, kk, scale, lv);
  return (int)cudaGetLastError();
}

}  // namespace

// fmap1 (rows, W1, C), f2cat (rows, W2cat, C), fp32 (in_bf16 = 0) or bf16
// (in_bf16 = 1); taps (rows, W1, nlev*kk) fp32, level-major, each level's
// local coordinates; out (rows, W1, nlev*kk), fp32 (out_bf16 = 0) or bf16;
// all contiguous.  C must be a multiple of 128 (fp32) or 256 (bf16);
// nlev <= 8; W2cat = sum(widths).  Returns the CUDA error code of
// the launch (0 on success).
extern "C" int alt_corr_taps_forward(const void* f1, const void* f2,
                                     const float* taps, void* out, long npix,
                                     int w1, int w2cat, int c, int kk,
                                     float scale, int nlev, const int* offsets,
                                     const int* widths, int in_bf16,
                                     int out_bf16, void* stream) {
  const int chunk = in_bf16 ? 256 : 128;
  if (nlev < 1 || nlev > kMaxLevels || c % chunk != 0 || c < chunk || kk < 1)
    return (int)cudaErrorInvalidValue;
  if (npix == 0) return 0;
  Levels lv;
  lv.n = nlev;
  for (int l = 0; l < kMaxLevels; ++l) {
    lv.off[l] = l < nlev ? offsets[l] : 0;
    lv.width[l] = l < nlev ? widths[l] : 0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (in_bf16 && out_bf16)
    return launch<bf16, bf16>(f1, f2, taps, out, npix, w1, w2cat, c, kk,
                              scale, lv, s);
  if (in_bf16)
    return launch<bf16, float>(f1, f2, taps, out, npix, w1, w2cat, c, kk,
                               scale, lv, s);
  if (out_bf16)
    return launch<float, bf16>(f1, f2, taps, out, npix, w1, w2cat, c, kk,
                               scale, lv, s);
  return launch<float, float>(f1, f2, taps, out, npix, w1, w2cat, c, kk,
                              scale, lv, s);
}
