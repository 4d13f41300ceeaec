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
// order from +0, each product and each add rounded once, as the TPU
// kernel's `acc = acc + g * w`.  NaN, as in that dense form: a NaN
// coordinate makes every w(j) of the level NaN, and a non-finite g_k
// times a zero weight is NaN, so either poisons the pixel's whole level
// segment of dvol.
//
// Where the value needs no arithmetic.  Call a pixel's level clean when x
// is not NaN and its K cotangents are finite.  The rounded taps t_k rise
// with k, so on a clean level every column j outside [floor(t_0),
// floor(t_{K-1}) + 1] has |j - t_k| >= 1, hat weight +0, for every k
// (the rounding of j - t_k is monotone): each product is +-0 and the
// ascending sum from +0 stays +0.  So those columns are exactly +0.0f,
// and only the window's columns (K+1 of them, K+2 where the taps' spacing
// rounds; clipped to the level) take the K-term sum.  A level that is not
// clean, or whose window is wider than K+2 (|x| near 2^23 or above, on a
// level that wide), takes the dense sum on every column: those are the
// NaN and +-inf cases, and rare.  Every value is the dense form's, bit
// for bit.
//
// Design: a store stream.  A block owns P consecutive pixels (P a
// multiple of 4, 32 at the flagship shapes), whose outputs are one
// contiguous run of P * W2cat floats.  The block stages the pixels' x and
// cotangents in shared memory, then each level's window (start, count;
// count -1 for the dense sum), then the window sums, one thread per
// (pixel, level, window column); then its threads walk the run with
// 16-byte streaming stores (a scalar head and tail where the run's ends
// are not 16-byte aligned), each value +0, a window sum read from shared
// memory, or a dense sum.  No thread shares an output with another, so
// there are no atomics and two calls give the same bits.  The TPU kernel
// builds the same dense rows block by block in VMEM.  Computing every
// output's K-term sum instead (its level found by a loop: ~100
// instructions an output) is bound by issue at about 5x the bytes bound.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): at the training shape (6x80 rows of 180 pixels, level widths
// 180/90/45/22, 4 levels of radius 4) the call writes dvol, 116.5 MB,
// and reads g and x (12.8 MB): about 129 MB, 39 us.  The window sums are
// ~40 of each pixel's 337 outputs, 9 taps of ~6 operations each, so it is
// bound by bytes.  What holds this design back from that: the per-output
// work of the stream (the pixel, level and window test, ~15 instructions
// an output) beside a store rate of one float4 per thread per few dozen
// cycles, and a block's setup (staging, windows, sums) before its first
// store, which other blocks on the SM overlap.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
constexpr int kMaxPixels = 32;       // pixels a block owns
constexpr int kSmemBudget = 48 * 1024;

struct Levels {
  int n;
  int off[kMaxLevels];    // first column of level l in the concatenated W2
  int width[kMaxLevels];  // real width w_l of level l
};

// Shared memory floats per pixel: cotangents, x, window sums, window info.
__host__ __device__ inline int floats_per_pixel(int nlev, int radius) {
  const int k = 2 * radius + 1;
  return nlev * k + 1 + nlev * (k + 2) + 2 * nlev;
}

// sum_k g_k * max(0, 1 - |jf - t_k|), k ascending from +0, each product
// and add rounded once; NaN weights kept (fmaxf would drop them).
__device__ __forceinline__ float hat_sum(float xl, const float* gp, int k_n,
                                         int radius, float jf) {
  float acc = 0.f;
  for (int k = 0; k < k_n; ++k) {
    const float t = __fadd_rn(xl, (float)(k - radius));
    float w = 1.f - fabsf(jf - t);
    if (!isnan(w)) w = fmaxf(w, 0.f);
    acc = __fadd_rn(acc, __fmul_rn(gp[k], w));
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
corr_vol_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                    float* __restrict__ dvol, long npix, int w2cat,
                    int radius, int pix_per_block, Levels lv) {
  extern __shared__ float smem[];
  __shared__ int off[kMaxLevels], width[kMaxLevels];
  __shared__ float inv[kMaxLevels];
  const int L = lv.n, K = 2 * radius + 1, LK = L * K, KW = K + 2;
  const long p0 = (long)blockIdx.x * pix_per_block;
  const int np = (int)min((long)pix_per_block, npix - p0);
  float* gs = smem;                                    // [np][LK]
  float* xs = gs + pix_per_block * LK;                 // [np]
  float* win = xs + pix_per_block;                     // [np][L][KW]
  int* info = reinterpret_cast<int*>(win + pix_per_block * L * KW);
  // info[(p * L + l) * 2 + 0 / 1]: the window's first column, its count
  // (-1: the dense sum on every column of the level)

  if (threadIdx.x < kMaxLevels) {
    const int l = threadIdx.x;
    off[l] = lv.off[l];
    width[l] = lv.width[l];
    inv[l] = 1.0f / (float)(1 << l);
  }
  for (int i = threadIdx.x; i < np * LK; i += kThreads)
    gs[i] = g[p0 * LK + i];
  for (int i = threadIdx.x; i < np; i += kThreads) xs[i] = x[p0 + i];
  __syncthreads();

  // Windows: one thread per (pixel, level).
  for (int t = threadIdx.x; t < np * L; t += kThreads) {
    const int p = t / L, l = t - p * L;
    const float xl = __fmul_rn(xs[p], inv[l]);  // exact
    const float* gp = gs + p * LK + l * K;
    bool clean = !isnan(xl);
    for (int k = 0; k < K; ++k) clean = clean && isfinite(gp[k]);
    // [floor(t_0), floor(t_{K-1}) + 1] clipped to the level; +-inf x
    // gives an empty window.
    const float lo = fmaxf(floorf(__fadd_rn(xl, (float)(-radius))), 0.f);
    const float hi = fminf(floorf(__fadd_rn(xl, (float)radius)) + 1.f,
                           (float)(width[l] - 1));
    int start = 0, count = 0;
    if (lo <= hi) {  // both within [0, width - 1]
      start = (int)lo;
      count = (int)hi - start + 1;
    }
    if (!clean || count > KW) count = -1;
    info[2 * t] = start;
    info[2 * t + 1] = count;
  }
  __syncthreads();

  // Window sums: one thread per (pixel, level, window column).
  for (int t = threadIdx.x; t < np * L * KW; t += kThreads) {
    const int pl = t / KW, d = t - pl * KW;
    const int count = info[2 * pl + 1];
    if (d >= count) continue;
    const int p = pl / L, l = pl - p * L;
    win[t] = hat_sum(__fmul_rn(xs[p], inv[l]), gs + p * LK + l * K, K,
                     radius, (float)(info[2 * pl] + d));
  }
  __syncthreads();

  // The store stream over the block's run of np * w2cat outputs.
  float* run = dvol + p0 * w2cat;
  const int n = np * w2cat;
  // The value at column jl of level l of pixel p.
  auto value = [&](int p, int l, int jl) -> float {
    const int pl = p * L + l;
    const int count = info[2 * pl + 1];
    if (count < 0)
      return hat_sum(__fmul_rn(xs[p], inv[l]), gs + p * LK + l * K, K,
                     radius, (float)jl);
    const unsigned d = (unsigned)(jl - info[2 * pl]);
    return d < (unsigned)count ? win[pl * KW + d] : 0.f;
  };
  // Pixel, level and column in the level of run element e.
  auto locate = [&](int e, int& p, int& l, int& jl) {
    p = e / w2cat;
    jl = e - p * w2cat;
    l = 0;
    while (l + 1 < L && jl >= off[l + 1]) ++l;
    jl -= off[l];
  };
  auto next = [&](int& p, int& l, int& jl) {
    ++jl;
    while (jl >= width[l]) {  // width-0 levels are skipped
      jl -= width[l];
      if (++l == L) {
        l = 0;
        ++p;
      }
    }
  };
  const int head = min(n, (int)((4 - ((uintptr_t)run >> 2)) & 3));
  const int nvec = (n - head) >> 2;
  for (int e = threadIdx.x; e < head; e += kThreads) {
    int p, l, jl;
    locate(e, p, l, jl);
    run[e] = value(p, l, jl);
  }
  for (int q = threadIdx.x; q < nvec; q += kThreads) {
    int p, l, jl;
    locate(head + 4 * q, p, l, jl);
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      v[u] = value(p, l, jl);
      if (u < 3) next(p, l, jl);
    }
    __stcs(reinterpret_cast<float4*>(run + head) + q,
           make_float4(v[0], v[1], v[2], v[3]));
  }
  for (int e = head + 4 * nvec + threadIdx.x; e < n; e += kThreads) {
    int p, l, jl;
    locate(e, p, l, jl);
    run[e] = value(p, l, jl);
  }
}

}  // namespace

// x (npix,), g (npix, nlev*(2*radius+1)); writes dvol (npix, w2cat) in
// full.  All fp32 and contiguous, dvol 4-byte aligned; radius 0..64, nlev
// 1..8, widths summing to w2cat, npix * w2cat < 2^31 per block run.
// Returns the CUDA error code of the launch (0 on success).
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
  // Pixels per block: a multiple of 4 (so each block's run starts 16-byte
  // aligned where dvol does), as many as fit the shared-memory budget.
  const int per_pixel = floats_per_pixel(nlev, radius) * (int)sizeof(float);
  int pix = kMaxPixels;
  while (pix > 4 && pix * per_pixel > kSmemBudget) pix -= 4;
  if ((long)pix * w2cat >= 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const long blocks = (npix + pix - 1) / pix;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  corr_vol_bwd_kernel<<<(unsigned)blocks, kThreads, (size_t)pix * per_pixel,
                        static_cast<cudaStream_t>(stream)>>>(
      x, g, dvol, npix, w2cat, radius, pix, lv);
  return (int)cudaGetLastError();
}
