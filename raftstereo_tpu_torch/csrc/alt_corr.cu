// On-demand all-level correlation lookup for Hopper (sm_90a), fp32.
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
// Accumulation is fp32 FMAs throughout (no TF32).
//
// Design.  The TPU kernel computes whole (block x W2cat) correlation rows
// on its matrix unit and masks them.  Here only the K+1 window dot
// products a pixel needs are computed (40 dots of length 256 at the
// flagship shapes): one warp per pixel, each lane holding C/32 channels
// of fmap1 in registers and reading its slice of each fmap2 row with
// 16-byte loads, reduced across the warp with shuffles.  The W2 rows a
// pixel reads overlap its neighbours' rows, so the fmap2 pyramid is
// served mostly from L1/L2.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): at 144x240, C=256, 4 levels of radius 4 the call must read
// fmap1 (35 MB) and the fmap2 pyramid (up to 66 MB) once and does about
// 0.7 GFLOP, so it is bound by bytes, about 30 us.  What this design does
// about it: each fmap1 element is read once (registers), fmap2 rows are
// read through the caches, and nothing but the output is written.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxChunks = 4;  // C <= 4 * 128
constexpr int kWarpsPerBlock = 8;

struct Levels {
  int n;
  int off[kMaxLevels];    // first column of level l in the concatenated W2
  int width[kMaxLevels];  // real width w2_l of level l
};

template <int R>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
alt_corr_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                const float* __restrict__ x, float* __restrict__ out,
                long npix, int w1, int w2cat, int c, float scale,
                Levels lv) {
  constexpr int K = 2 * R + 1;
  const int lane = threadIdx.x & 31;
  const long pix = (long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pix >= npix) return;  // whole warps exit together
  const long row = pix / w1;
  const int nchunk = c >> 7;

  float4 a[kMaxChunks];
  const float* p1 = f1 + pix * c + lane * 4;
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i)
    if (i < nchunk) a[i] = *reinterpret_cast<const float4*>(p1 + i * 128);

  const float xv = x[pix];
  const float* f2row = f2 + row * (long)w2cat * c + lane * 4;
  float* o = out + pix * (long)(lv.n * K);

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
        const float* p2 = f2row + (long)(lv.off[l] + (int)jf) * c;
#pragma unroll
        for (int i = 0; i < kMaxChunks; ++i) {
          if (i < nchunk) {
            const float4 b = *reinterpret_cast<const float4*>(p2 + i * 128);
            s = fmaf(a[i].x, b.x, s);
            s = fmaf(a[i].y, b.y, s);
            s = fmaf(a[i].z, b.z, s);
            s = fmaf(a[i].w, b.w, s);
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
      if (lane == k) o[l * K + k] = win[k] * (1.f - fr) + win[k + 1] * fr;
  }
}

template <int R>
int launch(const float* f1, const float* f2, const float* x, float* out,
           long npix, int w1, int w2cat, int c, float scale,
           const Levels& lv, cudaStream_t stream) {
  const unsigned blocks =
      (unsigned)((npix + kWarpsPerBlock - 1) / kWarpsPerBlock);
  alt_corr_kernel<R><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      f1, f2, x, out, npix, w1, w2cat, c, scale, lv);
  return (int)cudaGetLastError();
}

}  // namespace

// fmap1 (B*H, W1, C), f2cat (B*H, W2cat, C), x (B*H, W1), all fp32 and
// contiguous; out (B*H, W1, nlev*(2*radius+1)).  C must be a multiple of
// 128 and at most 512; radius 1..8; nlev <= 8.  Returns the CUDA error
// code of the launch (0 on success).
extern "C" int alt_corr_forward(const float* f1, const float* f2,
                                const float* x, float* out, long npix,
                                int w1, int w2cat, int c, int radius,
                                float scale, int nlev, const int* offsets,
                                const int* widths, void* stream) {
  if (nlev < 1 || nlev > kMaxLevels || c % 128 != 0 || c > 128 * kMaxChunks)
    return (int)cudaErrorInvalidValue;
  if (npix == 0) return 0;
  Levels lv;
  lv.n = nlev;
  for (int l = 0; l < kMaxLevels; ++l) {
    lv.off[l] = l < nlev ? offsets[l] : 0;
    lv.width[l] = l < nlev ? widths[l] : 0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 1: return launch<1>(f1, f2, x, out, npix, w1, w2cat, c, scale, lv, s);
    case 2: return launch<2>(f1, f2, x, out, npix, w1, w2cat, c, scale, lv, s);
    case 3: return launch<3>(f1, f2, x, out, npix, w1, w2cat, c, scale, lv, s);
    case 4: return launch<4>(f1, f2, x, out, npix, w1, w2cat, c, scale, lv, s);
    case 5: return launch<5>(f1, f2, x, out, npix, w1, w2cat, c, scale, lv, s);
    case 6: return launch<6>(f1, f2, x, out, npix, w1, w2cat, c, scale, lv, s);
    case 7: return launch<7>(f1, f2, x, out, npix, w1, w2cat, c, scale, lv, s);
    case 8: return launch<8>(f1, f2, x, out, npix, w1, w2cat, c, scale, lv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
