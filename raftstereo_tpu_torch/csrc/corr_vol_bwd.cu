// Backward of the precomputed-volume correlation lookup for Hopper
// (sm_90a), fp32.
//
// Replaces the TPU kernel raftstereo_tpu/ops/pallas_corr.py
// `_lookup_bwd_kernel`, launched from `_lookup_bwd_impl` (the VJP of the
// `pallas` backend's lookup).  Function: the VJP of corr_vol.cu with
// respect to the volume, for the cotangent g (npix, L*K):
//   dvol_l[p, j] = sum_{k=0..K-1} g[p, l*K + k] * max(0, 1 - |j - t_k|),
//   t_k = x[p] * 2^-l + (k - r),
// for every column j = 0..w_l-1 of every level: the whole dense gradient
// volume is written, mostly zeros.  The sum runs over k in ascending
// order from 0, each product and each add rounded once, as the TPU
// kernel's `acc = acc + g * w`.  NaN, as in that dense form: a NaN
// coordinate makes every w(j) of the level NaN, and a non-finite g_k
// times a zero weight is NaN, so either poisons the pixel's whole level
// segment of dvol.
//
// Design.  One block per pixel: the pixel's cotangents go to shared
// memory, then each thread computes whole output values (columns),
// finding the column's level, recomputing the pixel's K taps in
// registers and summing its K terms in order.  No thread shares an
// output with another, so there are no atomics and two calls give the
// same bits.  The TPU kernel builds the same dense rows block by block
// in VMEM.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): at the training shape (6x80 rows of 180 pixels, level widths
// 180/90/45/22, 4 levels of radius 4) the call writes dvol, 116.5 MB,
// and reads g and x (12.8 MB): about 129 MB, 39 us.  Its 29M outputs
// take 9 taps of ~6 operations each, about 1.6 GFLOP (23 us), so it is
// bound by bytes.  What this design does about it: each output is
// written once, by consecutive threads to consecutive addresses; a
// pixel's x and g are read once per block.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 128;

struct Levels {
  int n;
  int off[kMaxLevels];    // first column of level l in the concatenated W2
  int width[kMaxLevels];  // real width w_l of level l
};

__global__ void __launch_bounds__(kThreads)
corr_vol_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                    float* __restrict__ dvol, int w2cat, int radius,
                    Levels lv) {
  extern __shared__ float gs[];  // the pixel's nlev * K cotangents
  const long pix = blockIdx.x;
  const int K = 2 * radius + 1;
  const int lk = lv.n * K;
  for (int i = threadIdx.x; i < lk; i += kThreads) gs[i] = g[pix * lk + i];
  __syncthreads();
  const float xv = x[pix];
  float* out = dvol + pix * w2cat;
  for (int j = threadIdx.x; j < w2cat; j += kThreads) {
    // The column's level, its first column and 2^-l, with compile-time
    // table indices (a runtime index would copy the table to local memory).
    int l = 0, off = 0;
    float inv = 1.f;
#pragma unroll
    for (int i = 1; i < kMaxLevels; ++i)
      if (i < lv.n && j >= lv.off[i]) {
        l = i;
        off = lv.off[i];
        inv = 1.0f / (float)(1 << i);
      }
    const float jf = (float)(j - off);
    const float xl = __fmul_rn(xv, inv);  // exact
    const float* gp = gs + l * K;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) {
      const float t = __fadd_rn(xl, (float)(k - radius));
      float w = 1.f - fabsf(jf - t);
      if (!isnan(w)) w = fmaxf(w, 0.f);  // fmaxf would drop a NaN
      acc = __fadd_rn(acc, __fmul_rn(gp[k], w));
    }
    out[j] = acc;
  }
}

}  // namespace

// x (npix,), g (npix, nlev*(2*radius+1)); writes dvol (npix, w2cat) in
// full.  All fp32 and contiguous; radius 0..64, nlev 1..8, widths summing
// to w2cat, npix < 2^31.  Returns the CUDA error code of the launch (0 on
// success).
extern "C" int corr_vol_backward(const float* x, const float* g, float* dvol,
                                 long npix, int w2cat, int radius, int nlev,
                                 const int* offsets, const int* widths,
                                 void* stream) {
  if (nlev < 1 || nlev > kMaxLevels || radius < 0 || radius > 64)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  lv.n = nlev;
  for (int l = 0; l < kMaxLevels; ++l) {
    lv.off[l] = l < nlev ? offsets[l] : 0;
    lv.width[l] = l < nlev ? widths[l] : 0;
  }
  if (npix == 0 || w2cat == 0) return 0;
  if (npix > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)nlev * (2 * radius + 1) * sizeof(float);
  corr_vol_bwd_kernel<<<(unsigned)npix, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      x, g, dvol, w2cat, radius, lv);
  return (int)cudaGetLastError();
}
