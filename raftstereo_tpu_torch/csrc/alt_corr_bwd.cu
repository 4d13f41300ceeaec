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
// kernel discards the mass that lands on its lane padding.  Non-finite
// values follow the TPU kernel's dense hat matrix max(0, 1 - |j - t|):
// a NaN coordinate, or a NaN cotangent, of level l makes that pixel's df1
// and every column of level l in its row NaN.  An infinite cotangent g_k
// at a finite coordinate gives the columns its tap weights (b+k with 1-f,
// b+k+1 with f; at most two) their dense value, +-inf through the sums
// (or NaN where inf - inf, inf * 0 or an fmap element of 0 make it so),
// and every other column of the level in that row NaN (inf * 0); the
// pixel's df1 is NaN unless the tap weights every column of the level.
// The row tables carry this: a coefficient is NaN where an infinite tap
// of its pixel does not reach its column, each level keeps the columns
// that every infinite pixel's window covers (the rest of the level is
// NaN), and each window base carries a bit that makes the pixel's df1
// NaN.  Finite inputs take none of these paths.
//
// Design.  The TPU kernel builds a dense (block x W2) hat matrix in VMEM
// and runs two matrix-unit products per block.  Here a block of 32 warps
// handles one image row n and one slice of 128 channels (2 slices of C =
// 256), so a call runs rows x C/128 blocks.  The block first builds the
// row's coefficients (W1 x L x (2r+2)) and window bases in shared memory
// (each slice of a row rebuilds them from the row's x and g, 26 KB read
// from L2 at the recipe).  df2 is a scatter from pixels to columns,
// computed as a gather: one warp per column of the concatenated pyramid
// scans the row's pixels 32 at a time (a ballot of the pixels whose
// window covers the column) and sums their weighted fmap1 rows in
// ascending pixel order, the rows of four hits in flight at a time.  df1
// has the forward's gather pattern: one warp per pixel, a level's 2r+2
// fmap2 rows loaded first (clamped into the level, so every load is in
// bounds), then summed in tap order.  Each lane holds 4 channels (one
// float4) of the slice.  The fmap rows come through L1: a block re-reads
// its slice of its row (fmap1 92 KB and the fmap2 pyramid 172 KB at the
// recipe) about 20 times over, and one 32-warp block holds the SM's L1
// beside its 32 KB of tables, where the first form of this kernel (about
// four 8-warp blocks per SM, each row's 529 KB for all 256 channels, one
// or two loads in flight per warp) read them from L2 (no profiler on the
// card's machine counts the hits).  Staging the slices in shared memory
// with `cp.async` was slower in every form tried (PERF.md §6): it left one
// block per SM waiting on its copy, and every FMA reading shared memory.
// Every sum runs in the first form's fixed order (df1: levels ascending,
// then taps ascending; df2: pixels ascending; one fmaf per term from 0),
// with no floating-point atomics, so two calls on the same inputs are
// bitwise equal, and equal to that form's.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): at 6x80 rows of 180 pixels, level widths 180/90/45/22, C=256 and
// 4 levels of radius 4, the call must read fmap1 (44 MB), the fmap2
// pyramid (83 MB), x and g (13 MB) and write df1 and df2 (127 MB): about
// 521 MB, 0.16 ms.  The useful work is about 3.5 GFLOP (0.05 ms), so it
// is bound by bytes.  What holds this design back from that: the reads
// that miss L1 (a pixel's windows lie where its disparity puts them, so
// random disparities scatter them over the row), df2's scan of every
// pixel of the row for each column's hits, the per-hit work (ballot,
// shuffle, address) spread over only 4 channels a lane, and the tables
// built once per slice.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarpsPerBlock = 32;
constexpr int kVec = 4;                // channels per lane
constexpr int kSlice = 32 * kVec;      // channels per block
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kFar = 0x20000000;      // window base that covers no column
constexpr int kMaxSmem = 232448;      // bytes a block may opt in to

struct Levels {
  int n;
  int off[kMaxLevels];    // first column of level l in the concatenated W2
  int width[kMaxLevels];  // real width w2_l of level l
};

struct Args {
  const float* f1;  // (rows, W1, C)
  const float* f2;  // (rows, W2cat, C)
  const float* x;   // (rows, W1)
  const float* g;   // (rows, W1, L*(2r+1))
  float* df1;
  float* df2;
  int w1, w2cat, c, nslice;
  float scale;
  Levels lv;
};

// The 4 floats at p (16-byte aligned).
__device__ __forceinline__ void load4(float (&v)[kVec], const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Shared memory of one block: the coefficients [W1*L][D] and the window
// bases [L][W1], each stored as 2 * base + (1 if the pixel's df1 is NaN
// through this level).  Static: the columns [keep_lo, keep_hi] of each
// level that stay finite in the row (64 bytes, kept free by `launch`).
template <int R>
long smem_bytes(int w1, int nlev) {
  return (long)w1 * nlev * (2 * R + 3) * 4;
}

template <int R>
__global__ void __launch_bounds__(kThreads)
alt_corr_bwd_kernel(const Args a) {
  constexpr int K = 2 * R + 1;
  constexpr int D = K + 1;  // columns a pixel's window covers per level
  extern __shared__ __align__(16) float smem[];
  // Level l's columns outside [keep_lo, keep_hi] are NaN in this row: the
  // intersection of its infinite pixels' windows, empty for a NaN one.
  __shared__ int keep_lo[kMaxLevels], keep_hi[kMaxLevels];
  const Levels& lv = a.lv;
  const int L = lv.n, w1 = a.w1, w2cat = a.w2cat, c = a.c;
  const long n = blockIdx.x / a.nslice;
  const int c0 = (blockIdx.x % a.nslice) * kSlice;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* coef = smem;                                            // [w1][L][D]
  int* base = reinterpret_cast<int*>(coef + (long)w1 * L * D);  // [L][w1]
  // This lane's channels of pixel i's fmap1 row and column j's fmap2 row.
  const float* f1row = a.f1 + n * (long)w1 * c + c0 + lane * kVec;
  const float* f2row = a.f2 + n * (long)w2cat * c + c0 + lane * kVec;

  if (threadIdx.x < kMaxLevels) {
    keep_lo[threadIdx.x] = INT_MIN;
    keep_hi[threadIdx.x] = INT_MAX;
  }
  __syncthreads();

  // Tables: one thread per (pixel, level).
  for (int t = threadIdx.x; t < w1 * L; t += blockDim.x) {
    const int i = t / L, l = t - (t / L) * L;
    const int width = lv.width[l];
    const float xv = a.x[n * w1 + i];
    const float* gp = a.g + (n * w1 + i) * (long)(L * K) + l * K;
    float gk[K];
    bool nan_in = isnan(xv);
    unsigned inf_taps = 0;  // bit k: g_k is infinite
#pragma unroll
    for (int k = 0; k < K; ++k) {
      gk[k] = gp[k];
      nan_in = nan_in || isnan(gk[k]);
      if (isinf(gk[k])) inf_taps |= 1u << k;
    }
    const float xl = xv * (1.0f / (float)(1 << l));
    const float b0 = floorf(xl);
    const float fr = xl - b0;
    const float lo = b0 - (float)R;
    int b = kFar;
    bool df1_nan = false;
    if (!nan_in && lo <= (float)(width - 1) && lo + (float)K >= 0.f)
      b = (int)lo;  // in [-K, width-1]: no overflow
    if (nan_in || (inf_taps && b == kFar)) {
      // Every column of the level in this row is NaN.
      b = kFar;
      df1_nan = true;
      atomicMax(&keep_lo[l], INT_MAX);
    } else if (inf_taps) {
      // Only the window's columns can stay finite; df1 is NaN if a column
      // of the level lies outside it.
      atomicMax(&keep_lo[l], b);
      atomicMin(&keep_hi[l], b + D - 1);
      df1_nan = b > 0 || b + D - 1 < width - 1;
    }
    base[l * w1 + i] = 2 * b + (int)df1_nan;
    float* cp = coef + (long)t * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float v = 0.f;
      if (d < K) v = gk[d] * (1.f - fr);
      if (d > 0) v += gk[d - 1] * fr;
      // Column b+d is weighted by taps d-1 and d only: an infinite tap
      // elsewhere puts inf * 0 on it.
      const unsigned reach =
          (d < K ? 1u << d : 0u) | (d > 0 ? 1u << (d - 1) : 0u);
      cp[d] = (inf_taps & ~reach) ? NAN : v * a.scale;
    }
  }
  __syncthreads();

  // df2: one warp per column of the concatenated pyramid.
  for (int jg = warp; jg < w2cat; jg += kWarpsPerBlock) {
    int l = 0;
    while (l + 1 < L && jg >= lv.off[l + 1]) ++l;
    const int jl = jg - lv.off[l];
    float acc[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
    for (int i0 = 0; i0 < w1; i0 += 32) {
      const int i = i0 + lane;
      float cf = 0.f;
      bool hit = false;
      if (i < w1) {
        const int d = jl - (base[l * w1 + i] >> 1);  // kFar gives d < 0
        if (d >= 0 && d < D) {
          hit = true;
          cf = coef[(long)(i * L + l) * D + d];
        }
      }
      unsigned m = __ballot_sync(0xffffffffu, hit);
      while (m) {  // ascending pixel order, four hits' loads at a time
        int src[4];
        bool has[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          has[h] = m != 0;
          src[h] = has[h] ? __ffs(m) - 1 : 0;
          m &= m - 1;
        }
        float s[4], v[4][kVec];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          s[h] = __shfl_sync(0xffffffffu, cf, src[h]);
          load4(v[h], f1row + (i0 + src[h]) * (long)c);
        }
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          if (!has[h]) break;  // warp-uniform
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[e] = fmaf(s[h], v[h][e], acc[e]);
        }
      }
    }
    if (jl < keep_lo[l] || jl > keep_hi[l]) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = NAN;
    }
    store4(a.df2 + (n * (long)w2cat + jg) * c + c0 + lane * kVec, acc);
  }

  // df1: one warp per pixel.  Per level the window's rows are loaded
  // first (clamped into the level, so every load is in bounds), then
  // summed in tap order, skipping the columns outside the level.
  for (int i = warp; i < w1; i += kWarpsPerBlock) {
    float acc[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
    bool bad = false;
    for (int l = 0; l < L; ++l) {
      const int bv = base[l * w1 + i], b = bv >> 1, width = lv.width[l];
      if (bv & 1) {
        bad = bad || width > 0;
        continue;
      }
      if (b == kFar || width == 0) continue;  // warp-uniform
      const float* cp = coef + (long)(i * L + l) * D;
      float v[D][kVec];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int j = min(max(b + d, 0), width - 1);
        load4(v[d], f2row + (lv.off[l] + j) * (long)c);
      }
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int j = b + d;
        if (j < 0 || j >= width) continue;  // warp-uniform
        const float cf = cp[d];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[e] = fmaf(cf, v[d][e], acc[e]);
      }
    }
    if (bad) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = NAN;
    }
    store4(a.df1 + (n * w1 + i) * (long)c + c0 + lane * kVec, acc);
  }
}

template <int R>
int launch(Args a, long rows, cudaStream_t stream) {
  const long smem = smem_bytes<R>(a.w1, a.lv.n);
  // 64 bytes stay free for keep_lo/keep_hi
  if (smem > kMaxSmem - 64) return (int)cudaErrorInvalidValue;
  auto kernel = alt_corr_bwd_kernel<R>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  a.nslice = a.c / kSlice;
  kernel<<<(unsigned)(rows * a.nslice), kThreads, (size_t)smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// fmap1 (rows, W1, C), f2cat (rows, W2cat, C), x (rows, W1), g (rows, W1,
// nlev*(2*radius+1)), all fp32 and contiguous, the fmaps 16-byte aligned;
// writes df1 (rows, W1, C) and df2 (rows, W2cat, C) in full.  C must be a
// multiple of 128 and at most 512; radius 1..8; nlev <= 8; W2cat =
// sum(widths); the row's tables, W1 * nlev * (2*radius+3) floats, must
// fit in shared memory.  Returns the CUDA error code of the launch (0 on
// success).
extern "C" int alt_corr_backward(const float* f1, const float* f2,
                                 const float* x, const float* g, float* df1,
                                 float* df2, long rows, int w1, int w2cat,
                                 int c, int radius, float scale, int nlev,
                                 const int* offsets, const int* widths,
                                 void* stream) {
  if (nlev < 1 || nlev > kMaxLevels || c % 128 != 0 || c > 512)
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || w1 == 0) return 0;
  Args a{f1, f2, x, g, df1, df2, w1, w2cat, c, 0, scale, {}};
  a.lv.n = nlev;
  for (int l = 0; l < kMaxLevels; ++l) {
    a.lv.off[l] = l < nlev ? offsets[l] : 0;
    a.lv.width[l] = l < nlev ? widths[l] : 0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RS_CASE(r) \
  case r: return launch<r>(a, rows, s);
  switch (radius) {
    RS_CASE(1) RS_CASE(2) RS_CASE(3) RS_CASE(4)
    RS_CASE(5) RS_CASE(6) RS_CASE(7) RS_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef RS_CASE
}
