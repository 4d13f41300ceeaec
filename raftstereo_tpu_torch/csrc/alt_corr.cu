// On-demand all-level correlation lookup for Hopper (sm_90a): fp32 or bf16
// feature maps in, fp32 or bf16 correlation features out.
//
// Replaces the TPU kernel raftstereo_tpu/ops/pallas_alt.py
// `_alt_pyr_radial_kernel` (core `_radial_cols`), launched from
// `_alt_pyr_radial_fwd_impl`.  Function: for every pixel (b, y, x1) and
// level l, with the level-0 coordinate x and x_l = x * 2^-l,
//   win[d] = <fmap1[b,y,x1,:], fmap2_l[b,y,floor(x_l)+d-r,:]> / sqrt(C)
//            for d = 0..2r+1, and 0 where the index is outside [0, w2_l-1]
//   out[b,y,x1,l*K+k] = (1-f)*win[k] + f*win[k+1],  f = x_l - floor(x_l)
// which is the align-corners hat interpolation of the `alt` backend.  A
// NaN coordinate gives f = NaN and poisons the output, as on the TPU.
// Accumulation is fp32 FMAs throughout (no TF32).  bf16 feature maps are
// widened to fp32 exactly (products of bf16 values are exact in fp32), as
// the TPU's matrix unit takes them with preferred_element_type=float32;
// a bf16 output is the fp32 result rounded once.
//
// Design.  The TPU kernel computes whole (block x W2cat) correlation rows
// on its matrix unit and masks them.  Here only the K+1 window dot
// products a pixel needs are computed (40 dots of length 256 at the
// flagship shapes): one warp per pixel, each lane holding C/32 channels
// of fmap1 in registers and reading its slice of each fmap2 row with
// 16-byte loads (4 fp32 or 8 bf16 values a lane), reduced across the warp
// with shuffles.  The W2 rows a pixel reads overlap its neighbours' rows,
// so the fmap2 pyramid is served mostly from L1/L2.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): at 144x240, C=256, 4 levels of radius 4 the call must read
// fmap1 (35 MB) and the fmap2 pyramid (up to 66 MB) once and does about
// 0.7 GFLOP, so it is bound by bytes, about 30 us.  In bf16 (the bf16
// serving path: fmap1 17.7 MB, the pyramid 33.2 MB, a bf16 output 2.5 MB)
// about 53 MB, about 16 us.  What this design does about it: each fmap1
// element is read once (registers), fmap2 rows are read through the
// caches, and nothing but the output is written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarpsPerBlock = 8;

struct Levels {
  int n;
  int off[kMaxLevels];    // first column of level l in the concatenated W2
  int width[kMaxLevels];  // real width w2_l of level l
};

// 16-byte vector loads of the feature maps: V values a lane, widened to
// fp32; a warp covers 32 * V channels per chunk, C <= 512.
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

template <int R, typename TIn, typename TOut>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
alt_corr_kernel(const TIn* __restrict__ f1, const TIn* __restrict__ f2,
                const float* __restrict__ x, TOut* __restrict__ out,
                long npix, int w1, int w2cat, int c, float scale,
                Levels lv) {
  constexpr int K = 2 * R + 1;
  constexpr int V = Vec<TIn>::V;
  constexpr int kChunk = 32 * V;
  constexpr int kMaxChunks = 512 / kChunk;
  const int lane = threadIdx.x & 31;
  const long pix = (long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pix >= npix) return;  // whole warps exit together
  const long row = pix / w1;
  const int nchunk = c / kChunk;

  float a[kMaxChunks][V];
  const TIn* p1 = f1 + pix * c + lane * V;
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i)
    if (i < nchunk) Vec<TIn>::load(p1 + i * kChunk, a[i]);

  const float xv = x[pix];
  const TIn* f2row = f2 + row * (long)w2cat * c + lane * V;
  TOut* o = out + pix * (long)(lv.n * K);

  for (int l = 0; l < lv.n; ++l) {
    const float xl = xv * (1.0f / (float)(1 << l));
    const float b0 = floorf(xl);
    const float fr = xl - b0;
    const float last = (float)(lv.width[l] - 1);
    float win[K + 1];
#pragma unroll
    for (int d = 0; d <= K; ++d) {
      const float jf = b0 + (float)(d - R);
      float s = 0.f;
      if (jf >= 0.f && jf <= last) {  // false for NaN: warp-uniform branch
        const TIn* p2 = f2row + (long)(lv.off[l] + (int)jf) * c;
#pragma unroll
        for (int i = 0; i < kMaxChunks; ++i) {
          if (i < nchunk) {
            float b[V];
            Vec<TIn>::load(p2 + i * kChunk, b);
#pragma unroll
            for (int v = 0; v < V; ++v) s = fmaf(a[i][v], b[v], s);
          }
        }
#pragma unroll
        for (int m = 16; m > 0; m >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, m);
        s *= scale;
      }
      win[d] = s;
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (lane == k) put(o + l * K + k, win[k] * (1.f - fr) + win[k + 1] * fr);
  }
}

template <int R, typename TIn, typename TOut>
int launch(const void* f1, const void* f2, const float* x, void* out,
           long npix, int w1, int w2cat, int c, float scale,
           const Levels& lv, cudaStream_t stream) {
  const unsigned blocks =
      (unsigned)((npix + kWarpsPerBlock - 1) / kWarpsPerBlock);
  alt_corr_kernel<R, TIn, TOut><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      static_cast<const TIn*>(f1), static_cast<const TIn*>(f2), x,
      static_cast<TOut*>(out), npix, w1, w2cat, c, scale, lv);
  return (int)cudaGetLastError();
}

template <typename TIn, typename TOut>
int dispatch(int radius, const void* f1, const void* f2, const float* x,
             void* out, long npix, int w1, int w2cat, int c, float scale,
             const Levels& lv, cudaStream_t s) {
  switch (radius) {
#define ALT_CORR_CASE(r)                                                   \
  case r:                                                                  \
    return launch<r, TIn, TOut>(f1, f2, x, out, npix, w1, w2cat, c, scale, \
                                lv, s);
    ALT_CORR_CASE(1) ALT_CORR_CASE(2) ALT_CORR_CASE(3) ALT_CORR_CASE(4)
    ALT_CORR_CASE(5) ALT_CORR_CASE(6) ALT_CORR_CASE(7) ALT_CORR_CASE(8)
#undef ALT_CORR_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// fmap1 (B*H, W1, C), f2cat (B*H, W2cat, C), fp32 (in_bf16 = 0) or bf16
// (in_bf16 = 1); x (B*H, W1) fp32; out (B*H, W1, nlev*(2*radius+1)), fp32
// (out_bf16 = 0) or bf16; all contiguous.  C must be a multiple of 128
// (fp32) or 256 (bf16) and at most 512; radius 1..8; nlev <= 8.  Returns
// the CUDA error code of the launch (0 on success).
extern "C" int alt_corr_forward(const void* f1, const void* f2,
                                const float* x, void* out, long npix,
                                int w1, int w2cat, int c, int radius,
                                float scale, int nlev, const int* offsets,
                                const int* widths, int in_bf16, int out_bf16,
                                void* stream) {
  const int chunk = in_bf16 ? 256 : 128;
  if (nlev < 1 || nlev > kMaxLevels || c % chunk != 0 || c > 512)
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
    return dispatch<bf16, bf16>(radius, f1, f2, x, out, npix, w1, w2cat, c,
                                scale, lv, s);
  if (in_bf16)
    return dispatch<bf16, float>(radius, f1, f2, x, out, npix, w1, w2cat, c,
                                 scale, lv, s);
  if (out_bf16)
    return dispatch<float, bf16>(radius, f1, f2, x, out, npix, w1, w2cat, c,
                                 scale, lv, s);
  return dispatch<float, float>(radius, f1, f2, x, out, npix, w1, w2cat, c,
                                scale, lv, s);
}
