// Precomputed-volume correlation lookup for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel raftstereo_tpu/ops/pallas_corr.py
// `_lookup_kernel`, launched from `_lookup_fwd_impl` (the `pallas`
// backend's per-iteration lookup over the W2-concatenated volume
// pyramid).  Function: for every pixel p = (b, y, x1), level l and tap
// k = 0..2r, with the level-0 coordinate x and t = x * 2^-l + (k - r),
//   out[p, l*K + k] = sum_j vol_l[p, j] * max(0, 1 - |j - t|)
// over the level's real columns j = 0..w_l-1, K = 2r+1.  The hat weight
// is nonzero at j = floor(t) and floor(t)+1 only, so
//   out = [f in level] vol_l[p, f] * (1 - |f - t|)
//       + [f+1 in level] vol_l[p, f+1] * (1 - |f+1 - t|),  f = floor(t);
// columns outside [0, w_l - 1] give 0.  A NaN coordinate makes every hat
// weight NaN, so it gives NaN (a level of width 0 gives 0, an empty sum).
// Each product and the sum are rounded once (__fmul_rn, __fadd_rn, no
// FMA contraction): the kernel computes the plain version's arithmetic
// bit for bit.
//
// Design.  The TPU kernel reduces each tap over the whole (lane-padded)
// W2 row with the dense hat weight, because its vector unit has no
// gather.  Here one thread computes one output value and reads only the
// two volume columns that carry weight, testing them against the level's
// real width in float before any integer cast (false for NaN).
//
// Bound on an H100 SXM (3.35 TB/s): at the serving shape (144x240
// pixels, 4 levels of radius 4, level widths 240/120/60/30) the function
// needs the taps' columns of the volume (at most 10 per pixel and level,
// about 5.5 MB), x and the output (5 MB): about 11 MB, 3 us; at the
// training shape (6x80x180) about 27 MB, 8 us.  Its arithmetic is a few
// operations per output, so it is bound by bytes.  What this design does
// about it: nothing but the needed columns is read; consecutive threads
// write consecutive outputs, and the 36 outputs of a pixel read one
// volume row, whose columns share cache lines.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;

struct Levels {
  int n;
  int off[kMaxLevels];    // first column of level l in the concatenated W2
  int width[kMaxLevels];  // real width w_l of level l
};

// Level l's first column, width and 2^-l, selected with compile-time
// indices so the table stays in the kernel's parameter space (a runtime
// index would copy it to local memory).
__device__ __forceinline__ void level_of(const Levels& lv, int l, int& off,
                                         int& width, float& inv) {
  off = lv.off[0];
  width = lv.width[0];
  inv = 1.f;
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i)
    if (i == l) {
      off = lv.off[i];
      width = lv.width[i];
      inv = 1.0f / (float)(1 << i);
    }
}

__global__ void __launch_bounds__(kThreads)
corr_vol_kernel(const float* __restrict__ vol, const float* __restrict__ x,
                float* __restrict__ out, unsigned nout, int w2cat, int radius,
                Levels lv) {
  const unsigned e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= nout) return;
  const unsigned K = 2 * radius + 1;
  const unsigned lk = lv.n * K;
  const unsigned pix = e / lk;
  const unsigned q = e - pix * lk;
  const int l = (int)(q / K);
  const int k = (int)(q - l * K);
  int off, width;
  float inv;
  level_of(lv, l, off, width, inv);
  float v = 0.f;
  if (width > 0) {
    // x * 2^-l is exact; the tap offset is one float add, as in JAX.
    const float t = __fadd_rn(__fmul_rn(x[pix], inv), (float)(k - radius));
    if (isnan(t)) {
      v = NAN;
    } else {
      const float f0 = floorf(t);
      const float f1 = f0 + 1.f;
      const float last = (float)(width - 1);
      const float* row = vol + (long)pix * w2cat + off;
      float p0 = 0.f, p1 = 0.f;
      if (f0 >= 0.f && f0 <= last)
        p0 = __fmul_rn(row[(int)f0], 1.f - fabsf(f0 - t));
      if (f1 >= 0.f && f1 <= last)
        p1 = __fmul_rn(row[(int)f1], 1.f - fabsf(f1 - t));
      v = __fadd_rn(p0, p1);
    }
  }
  out[e] = v;
}

}  // namespace

// vol (npix, w2cat): the volume pyramid concatenated along W2 at its real
// level widths; x (npix,): level-0 coordinates; out (npix,
// nlev*(2*radius+1)).  All fp32 and contiguous.  radius 0..64, nlev
// 1..8, widths summing to w2cat, fewer than 2^32 - 256 outputs.  Returns
// the CUDA error code of the launch (0 on success).
extern "C" int corr_vol_forward(const float* vol, const float* x, float* out,
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
  const long nout = npix * (long)nlev * (2 * radius + 1);
  if (nout == 0) return 0;
  if (nout > 0xffffff00L) return (int)cudaErrorInvalidValue;  // 32-bit index
  const unsigned blocks = (unsigned)((nout + kThreads - 1) / kThreads);
  corr_vol_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      vol, x, out, (unsigned)nout, w2cat, radius, lv);
  return (int)cudaGetLastError();
}
