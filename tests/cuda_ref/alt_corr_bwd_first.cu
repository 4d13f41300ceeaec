// The first form of raftstereo_tpu_torch/csrc/alt_corr_bwd.cu (one block
// per image row, the fmaps read through L1/L2), kept unchanged as the
// reference whose bits tests/test_torch_port_cuda.py holds the current
// kernel to: both sum every output in the same order.
//
// Backward of the on-demand all-level correlation lookup for Hopper
// (sm_90a), fp32.
//
// Replaces the TPU kernel raftstereo_tpu/ops/pallas_alt.py
// `_alt_pyr_bwd_kernel`, launched from `_alt_pyr_bwd_impl` with the radial
// taps of `_make_alt_pyr_radial.bwd`.  Function: the VJP of alt_corr.cu.
// For an image row n, pixel i and level l with x_l = x[n,i] * 2^-l,
// b = floor(x_l) - r and f = x_l - floor(x_l), the forward's output tap k
// reads columns b+k (weight 1-f) and b+k+1 (weight f) of level l.  So
// column b+d of level l (d = 0..2r+1) carries the coefficient
//   c[n,i,l,d] = s * (g[n,i,l,d] * (1-f) + g[n,i,l,d-1] * f)
// (terms with d-1 < 0 or d > 2r dropped), s = C^-1/2, and
//   df1[n,i,:]    = sum_{l,d}   c[n,i,l,d] * f2_l[n, b+d, :]
//   df2_l[n,j,:]  = sum_{i,d: b+d=j} c[n,i,l,d] * f1[n,i,:]
// over columns inside [0, w2_l - 1]; the rest get nothing, as the TPU
// kernel discards the mass that lands on its lane padding.  A NaN
// coordinate, or a non-finite cotangent, of level l poisons that pixel's
// df1 and every column of level l in its row with NaN, as the TPU kernel's
// dense hat matrix max(0, 1 - |j - t|) does.
//
// Design.  The TPU kernel builds a dense (block x W2) hat matrix in VMEM
// and runs two matrix-unit products per block.  Here one block handles one
// image row n; the row's coefficients (W1 x L x (2r+2)) and window bases go
// to shared memory first.  df1 has the forward's gather pattern: one warp
// per pixel, each lane holding C/32 channels, summing its 2r+2 weighted
// fmap2 rows per level.  df2 is a scatter from pixels to columns, computed
// as a gather: one warp per column, which scans the row's pixels 32 at a
// time (a ballot of the pixels whose window covers the column) and sums
// their weighted fmap1 rows in ascending pixel order.  Every sum runs in a
// fixed order and no floating-point atomics are used, so two calls on the
// same inputs are bitwise equal.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): at 6x80 rows of 180 pixels, level widths 180/90/45/22, C=256 and
// 4 levels of radius 4, the call must read fmap1 (44 MB), the fmap2
// pyramid (83 MB), x and g (13 MB) and write df1 and df2 (127 MB): about
// 521 MB, 0.16 ms.  The useful work is about 3.5 GFLOP (0.05 ms), so it
// is bound by bytes.  What this design does about it: each output element
// is written once, and the rows a block re-reads (fmap1, fmap2 of its
// image row) stay in L1/L2.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxChunks = 4;  // C <= 4 * 128
constexpr int kWarpsPerBlock = 8;
constexpr int kFar = 0x40000000;      // window base that covers no column
constexpr int kPoisoned = 0x40000001; // window base of a NaN pixel/level
constexpr int kMaxSmem = 232448;      // bytes a block may opt in to

struct Levels {
  int n;
  int off[kMaxLevels];    // first column of level l in the concatenated W2
  int width[kMaxLevels];  // real width w2_l of level l
};

__device__ __forceinline__ void fma4(float4& acc, float s, const float4& v) {
  acc.x = fmaf(s, v.x, acc.x);
  acc.y = fmaf(s, v.y, acc.y);
  acc.z = fmaf(s, v.z, acc.z);
  acc.w = fmaf(s, v.w, acc.w);
}

template <int R>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
alt_corr_bwd_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                    const float* __restrict__ x, const float* __restrict__ g,
                    float* __restrict__ df1, float* __restrict__ df2, int w1,
                    int w2cat, int c, float scale, Levels lv) {
  constexpr int K = 2 * R + 1;
  constexpr int D = K + 1;  // columns a pixel's window covers per level
  extern __shared__ float smem[];
  __shared__ int poison;    // bit l: level l of this row is poisoned
  const int L = lv.n;
  float* coef = smem;                                        // [w1][L][D]
  int* base = reinterpret_cast<int*>(coef + (long)w1 * L * D);  // [w1][L]
  const long n = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nchunk = c >> 7;

  if (threadIdx.x == 0) poison = 0;
  __syncthreads();

  // Tables: one thread per (pixel, level).
  for (int t = threadIdx.x; t < w1 * L; t += blockDim.x) {
    const int i = t / L, l = t - (t / L) * L;
    const float xv = x[n * w1 + i];
    const float* gp = g + (n * w1 + i) * (long)(L * K) + l * K;
    float gk[K];
    bool bad = isnan(xv);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      gk[k] = gp[k];
      bad = bad || !isfinite(gk[k]);
    }
    const float xl = xv * (1.0f / (float)(1 << l));
    const float b0 = floorf(xl);
    const float fr = xl - b0;
    const float lo = b0 - (float)R;
    int b = kFar;
    if (bad) {
      b = kPoisoned;
      if (lv.width[l] > 0) atomicOr(&poison, 1 << l);
    } else if (lo <= (float)(lv.width[l] - 1) && lo + (float)K >= 0.f) {
      b = (int)lo;  // in [-K, width-1]: no overflow
    }
    base[t] = b;
    float* cp = coef + (long)t * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float v = 0.f;
      if (d < K) v = gk[d] * (1.f - fr);
      if (d > 0) v += gk[d - 1] * fr;
      cp[d] = v * scale;
    }
  }
  __syncthreads();

  // df1: one warp per pixel.
  const float* f2row = f2 + n * (long)w2cat * c + lane * 4;
  for (int i = warp; i < w1; i += kWarpsPerBlock) {
    float4 acc[kMaxChunks];
#pragma unroll
    for (int q = 0; q < kMaxChunks; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    bool bad = false;
    for (int l = 0; l < L; ++l) {
      const int b = base[i * L + l];
      if (b == kPoisoned) {
        bad = bad || lv.width[l] > 0;
        continue;
      }
      const float* cp = coef + (long)(i * L + l) * D;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int j = b + d;
        if (j < 0 || j >= lv.width[l]) continue;  // warp-uniform
        const float cf = cp[d];
        const float* p2 = f2row + (long)(lv.off[l] + j) * c;
#pragma unroll
        for (int q = 0; q < kMaxChunks; ++q)
          if (q < nchunk)
            fma4(acc[q], cf, *reinterpret_cast<const float4*>(p2 + q * 128));
      }
    }
    float* o = df1 + (n * w1 + i) * (long)c + lane * 4;
#pragma unroll
    for (int q = 0; q < kMaxChunks; ++q) {
      if (q < nchunk) {
        float4 v = acc[q];
        if (bad) v = make_float4(NAN, NAN, NAN, NAN);
        *reinterpret_cast<float4*>(o + q * 128) = v;
      }
    }
  }

  // df2: one warp per column of the concatenated pyramid.
  const float* f1row = f1 + n * (long)w1 * c + lane * 4;
  for (int jg = warp; jg < w2cat; jg += kWarpsPerBlock) {
    int l = 0;
    while (l + 1 < L && jg >= lv.off[l + 1]) ++l;
    const int jl = jg - lv.off[l];
    float4 acc[kMaxChunks];
#pragma unroll
    for (int q = 0; q < kMaxChunks; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i0 = 0; i0 < w1; i0 += 32) {
      const int i = i0 + lane;
      float cf = 0.f;
      bool hit = false;
      if (i < w1) {
        const int d = jl - base[i * L + l];  // sentinels give d < 0
        if (d >= 0 && d < D) {
          hit = true;
          cf = coef[(long)(i * L + l) * D + d];
        }
      }
      unsigned m = __ballot_sync(0xffffffffu, hit);
      while (m) {  // ascending pixel order
        const int src = __ffs(m) - 1;
        m &= m - 1;
        const float s = __shfl_sync(0xffffffffu, cf, src);
        const float* p1 = f1row + (long)(i0 + src) * c;
#pragma unroll
        for (int q = 0; q < kMaxChunks; ++q)
          if (q < nchunk)
            fma4(acc[q], s, *reinterpret_cast<const float4*>(p1 + q * 128));
      }
    }
    const bool bad = (poison >> l) & 1;
    float* o = df2 + (n * (long)w2cat + jg) * c + lane * 4;
#pragma unroll
    for (int q = 0; q < kMaxChunks; ++q) {
      if (q < nchunk) {
        float4 v = acc[q];
        if (bad) v = make_float4(NAN, NAN, NAN, NAN);
        *reinterpret_cast<float4*>(o + q * 128) = v;
      }
    }
  }
}

template <int R>
int launch(const float* f1, const float* f2, const float* x, const float* g,
           float* df1, float* df2, long rows, int w1, int w2cat, int c,
           float scale, const Levels& lv, cudaStream_t stream) {
  constexpr int D = 2 * R + 2;
  const long smem = (long)w1 * lv.n * (D + 1) * 4;
  if (smem > kMaxSmem - 64) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        alt_corr_bwd_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  alt_corr_bwd_kernel<R><<<(unsigned)rows, 32 * kWarpsPerBlock, (size_t)smem,
                           stream>>>(f1, f2, x, g, df1, df2, w1, w2cat, c,
                                     scale, lv);
  return (int)cudaGetLastError();
}

}  // namespace

// fmap1 (rows, W1, C), f2cat (rows, W2cat, C), x (rows, W1), g (rows, W1,
// nlev*(2*radius+1)), all fp32 and contiguous; writes df1 (rows, W1, C)
// and df2 (rows, W2cat, C) in full.  C must be a multiple of 128 and at
// most 512; radius 1..8; nlev <= 8; W2cat = sum(widths); the row's tables,
// W1 * nlev * (2*radius+3) floats, must fit in shared memory.  Returns the
// CUDA error code of the launch (0 on success).
extern "C" int alt_corr_backward(const float* f1, const float* f2,
                                 const float* x, const float* g, float* df1,
                                 float* df2, long rows, int w1, int w2cat,
                                 int c, int radius, float scale, int nlev,
                                 const int* offsets, const int* widths,
                                 void* stream) {
  if (nlev < 1 || nlev > kMaxLevels || c % 128 != 0 || c > 128 * kMaxChunks)
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || w1 == 0) return 0;
  Levels lv;
  lv.n = nlev;
  for (int l = 0; l < kMaxLevels; ++l) {
    lv.off[l] = l < nlev ? offsets[l] : 0;
    lv.width[l] = l < nlev ? widths[l] : 0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RS_CASE(r) \
  case r: return launch<r>(f1, f2, x, g, df1, df2, rows, w1, w2cat, c, scale, lv, s);
  switch (radius) {
    RS_CASE(1) RS_CASE(2) RS_CASE(3) RS_CASE(4)
    RS_CASE(5) RS_CASE(6) RS_CASE(7) RS_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef RS_CASE
}
