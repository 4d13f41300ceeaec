// Backward of the all-level correlation lookup at caller-given taps, for
// Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel raftstereo_tpu/ops/pallas_alt.py
// `_alt_pyr_bwd_kernel` as `_make_alt_pyr.bwd` launches it (through
// `_alt_pyr_bwd_impl`) with arbitrary taps: the VJP of alt_corr_taps.cu.
// (alt_corr_bwd.cu is the same TPU kernel's radial form.)  For an image
// row n, pixel i and tap q of level l with local coordinate t, cotangent
// g and j0 = floor(t), f = t - j0, the hat puts weight 1 - f on column j0
// and f on j0 + 1 of level l, so with s = C^-1/2
//   dm_l[n,i,j] = s * sum_{q of level l} g[n,i,q] * hat_q(j)
//   df1[n,i,:]   = sum_{l, j in [0, w_l)} dm_l[n,i,j] * f2_l[n, j, :]
//   df2_l[n,j,:] = sum_i dm_l[n,i,j] * f1[n, i, :]
// Columns [0, w_l) of each given width receive mass; mass outside is
// dropped.  Non-finite inputs follow the TPU's dense hat: a NaN tap or a
// NaN cotangent of level l makes the pixel's hat row NaN (max(0, NaN) is
// NaN), which poisons its df1 and every column of level l in its row; an
// infinite cotangent gives +-inf on the columns its tap weights and NaN
// (inf * 0) on every other column of the level, so its pixel's df1 is
// NaN unless the tap weights every column.  The taps get no gradient (the
// JAX VJP returns zeros for them).
//
// Design.  The TPU kernel builds a dense (block x W2cat) hat matrix in VMEM
// and runs two matrix-unit products per block, accumulating df2 across the
// sequential grid.  Here one block owns one image row n and walks its
// pixels in tiles, in ascending order (one tile when the row's tables fit
// in shared memory, as at the model's widths).  Per tile, first one thread
// per (pixel, tap) writes the tap's first column and its two unscaled
// coefficients g * (1 - f) and g * f to shared memory.  df1 has the
// forward's gather pattern: one warp per pixel, lanes over C, walking its
// taps in order and merging the coefficients of consecutive equal columns
// before each fmap2 row read.  df2 is a scatter from pixels to columns,
// computed as a gather: one warp per column of the concatenated pyramid
// scans the tile's pixels 32 at a time (a lane sums its pixel's hits on
// the column over the level's taps in order), ballots the pixels that
// hit, and sums their weighted fmap1 rows in ascending pixel order.  A
// column stays with the same warp in every tile, so a later tile resumes
// the sum from the row's df2 in global memory, which only that warp's
// lanes wrote: the chain of FMAs is the one-tile chain.  Channels go in
// groups of 512 (four float4 per lane).  Every sum runs in a fixed order
// and no floating-point atomics are used, so two calls on the same inputs
// give equal bits.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): at 480 rows of 180 pixels, level widths 180/90/45/22, C=256 and
// 36 taps, the call must read fmap1 (88 MB), the fmap2 pyramid (166 MB),
// the taps and g (25 MB) and write df1 and df2 (254 MB): about 533 MB,
// 0.16 ms.  The useful work is at most 2 * 2 * 36 * 256 FLOPs per pixel
// for each gradient (3.2 GFLOP, 0.05 ms), so it is bound by bytes.  What
// this design does about it: each output element is written once, and the
// rows a block re-reads (fmap1 and fmap2 of its image row) stay in L1/L2.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxChunks = 4;  // channels per group: 4 * 128
constexpr int kWarpsPerBlock = 8;
constexpr int kFar = 0x40000000;  // first column of a tap that hits none
constexpr int kMaxSmem = 232448;  // bytes a block may opt in to

struct Levels {
  int n;
  int off[kMaxLevels];    // first column of level l in the concatenated W2
  int width[kMaxLevels];  // width w_l of level l
};

__device__ __forceinline__ void fma4(float4& acc, float s, const float4& v) {
  acc.x = fmaf(s, v.x, acc.x);
  acc.y = fmaf(s, v.y, acc.y);
  acc.z = fmaf(s, v.z, acc.z);
  acc.w = fmaf(s, v.w, acc.w);
}

// acc += coef * rows[col] over this lane's channels.
__device__ __forceinline__ void add_row(float4 (&acc)[kMaxChunks], float coef,
                                        const float* p, int nchunk) {
#pragma unroll
  for (int q = 0; q < kMaxChunks; ++q)
    if (q < nchunk)
      fma4(acc[q], coef, *reinterpret_cast<const float4*>(p + q * 128));
}

__device__ __forceinline__ void store(float* o, const float4 (&acc)[kMaxChunks],
                                      bool bad, int nchunk) {
#pragma unroll
  for (int q = 0; q < kMaxChunks; ++q) {
    if (q < nchunk) {
      float4 v = acc[q];
      if (bad) v = make_float4(NAN, NAN, NAN, NAN);
      *reinterpret_cast<float4*>(o + q * 128) = v;
    }
  }
}

// kSplit: the row in several tiles or C above 512; the other instance
// compiles the one-tile, one-group form of the model's widths.
template <bool kSplit>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
alt_corr_taps_bwd_kernel(const float* __restrict__ f1,
                         const float* __restrict__ f2,
                         const float* __restrict__ taps,
                         const float* __restrict__ g, float* __restrict__ df1,
                         float* __restrict__ df2, int w1, int w2cat, int c,
                         int kk, float scale, Levels lv, int tile) {
  extern __shared__ float smem[];
  __shared__ int poison;  // bit l: some pixel poisons level l of this row
  const int L = lv.n;
  const int lk = L * kk;
  float* c0 = smem;                            // [tile][lk]: g * (1 - f)
  float* c1 = c0 + (long)tile * lk;            // [tile][lk]: g * f
  int* base = reinterpret_cast<int*>(c1 + (long)tile * lk);  // [tile][lk]
  int* bad = base + (long)tile * lk;           // [tile][L]: NaN tap or g
  const long n = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* f1row = f1 + n * (long)w1 * c + lane * 4;
  const float* f2row = f2 + n * (long)w2cat * c + lane * 4;

  if (threadIdx.x == 0) poison = 0;
  // W1 = 0 still runs one (empty) tile: df2 is written as zeros.
  for (int p0 = 0;; p0 += tile) {
    const int np = kSplit ? min(tile, w1 - p0) : w1;
    const bool last = !kSplit || p0 + np >= w1;
    for (int t = threadIdx.x; t < np * L; t += blockDim.x) bad[t] = 0;
    __syncthreads();

    // Tables: one thread per (pixel, tap) of the tile.
    const long tap0 = (n * w1 + p0) * (long)lk;
    for (int t = threadIdx.x; t < np * lk; t += blockDim.x) {
      const int i = t / lk, q = t - i * lk, l = q / kk;
      const float tv = taps[tap0 + t];
      const float gv = g[tap0 + t];
      const int w = lv.width[l];
      int b = kFar;
      float a0 = 0.f, a1 = 0.f;
      if (isnan(tv) || isnan(gv)) {
        if (w > 0) {
          bad[i * L + l] = 1;  // every writer stores 1: no race on the value
          atomicOr(&poison, 1 << l);
        }
      } else if (tv > -1.f && tv < (float)w) {
        const float b0 = floorf(tv);
        const float f = tv - b0;
        b = (int)b0;  // in [-1, w - 1]
        a0 = __fmul_rn(gv, __fsub_rn(1.f, f));  // 1 - f > 0: inf iff g is
        a1 = __fmul_rn(gv, f);
      } else {
        a0 = gv;  // weights no column; isinf(a0) still marks an infinite g
      }
      base[t] = b;
      c0[t] = a0;
      c1[t] = a1;
    }
    __syncthreads();

    for (int cg = 0;; cg += 128 * kMaxChunks) {
      const int nchunk = min(kMaxChunks, (c - cg) >> 7);

      // df1: one warp per pixel; consecutive equal columns share one row
      // read.
      for (int i = warp; i < np; i += kWarpsPerBlock) {
        float4 acc[kMaxChunks];
#pragma unroll
        for (int q = 0; q < kMaxChunks; ++q)
          acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
        bool poisoned = false;
        for (int l = 0; l < L; ++l) {
          if (bad[i * L + l]) {
            poisoned = true;
            continue;
          }
          const int w = lv.width[l];
          const float* p2 = f2row + cg + (long)lv.off[l] * c;
          int pend = -1;  // column whose coefficient is being summed
          float coef = 0.f;
          for (int k = 0; k < kk; ++k) {
            const int t = i * lk + l * kk + k;
            const int b = base[t];
            // An infinite g puts inf * 0 = NaN on every column its tap
            // does not reach.
            if (isinf(c0[t]) && (b == kFar ? 0 : (b >= 0) + (b + 1 < w)) < w)
              poisoned = true;
            if (b == kFar) continue;
#pragma unroll
            for (int d = 0; d < 2; ++d) {
              const int j = b + d;
              if (j < 0 || j >= w) continue;  // warp-uniform
              const float a = d ? c1[t] : c0[t];
              if (j == pend) {
                coef = __fadd_rn(coef, a);
              } else {
                if (pend >= 0)
                  add_row(acc, __fmul_rn(coef, scale), p2 + (long)pend * c,
                          nchunk);
                pend = j;
                coef = a;
              }
            }
          }
          if (pend >= 0)
            add_row(acc, __fmul_rn(coef, scale), p2 + (long)pend * c, nchunk);
        }
        store(df1 + (n * w1 + p0 + i) * (long)c + cg + lane * 4, acc,
              poisoned, nchunk);
      }

      // df2: one warp per column of the concatenated pyramid.
      for (int jg = warp; jg < w2cat; jg += kWarpsPerBlock) {
        int l = 0;
        while (l + 1 < L && jg >= lv.off[l + 1]) ++l;
        const int jl = jg - lv.off[l];
        float* o = df2 + (n * (long)w2cat + jg) * c + cg + lane * 4;
        float4 acc[kMaxChunks];
#pragma unroll
        for (int q = 0; q < kMaxChunks; ++q)
          acc[q] = p0 == 0 || q >= nchunk
                       ? make_float4(0.f, 0.f, 0.f, 0.f)
                       : *reinterpret_cast<const float4*>(o + q * 128);
        for (int i0 = 0; i0 < np; i0 += 32) {
          const int i = i0 + lane;
          float coef = 0.f;
          bool hit = false, inf_elsewhere = false;
          if (i < np) {
            for (int k = 0; k < kk; ++k) {  // the level's taps, in order
              const int t = i * lk + l * kk + k;
              const int d = jl - base[t];  // kFar gives d < 0
              if (d == 0 || d == 1) {
                const float a = d ? c1[t] : c0[t];
                coef = hit ? __fadd_rn(coef, a) : a;
                hit = true;
              } else if (isinf(c0[t])) {
                inf_elsewhere = true;  // inf * 0 on this column
              }
            }
            if (inf_elsewhere) {
              coef = NAN;
              hit = true;
            }
          }
          unsigned m = __ballot_sync(0xffffffffu, hit);
          while (m) {  // ascending pixel order
            const int src = __ffs(m) - 1;
            m &= m - 1;
            const float s = __shfl_sync(0xffffffffu, coef, src);
            add_row(acc, __fmul_rn(s, scale),
                    f1row + cg + (long)(p0 + i0 + src) * c, nchunk);
          }
        }
        store(o, acc, last && ((poison >> l) & 1), nchunk);
      }
      if (!kSplit || cg + 128 * kMaxChunks >= c) break;
    }
    if (last) break;
    __syncthreads();  // the next tile overwrites the tables
  }
}

// Shared memory the tables of one tile of `tile` pixels take.
long tile_smem(int tile, int nlev, int kk) {
  return (long)tile * nlev * (kk * 3 + 1) * 4;
}

}  // namespace

// Pixels per tile: the whole row W1 where its tables fit in shared
// memory, else the most that fit, rounded down to a multiple of 32 where
// that leaves any; 0 where not one pixel's tables fit.
extern "C" int alt_corr_taps_backward_tile(int w1, int nlev, int kk) {
  const long per = tile_smem(1, nlev, kk), cap = kMaxSmem - 64;
  if (tile_smem(w1, nlev, kk) <= cap) return w1;
  const long fit = cap / per;
  return (int)(fit >= 32 ? fit / 32 * 32 : fit);
}

// fmap1 (rows, W1, C), f2cat (rows, W2cat, C), taps and g (rows, W1,
// nlev*kk), all fp32 and contiguous; writes df1 (rows, W1, C) and df2
// (rows, W2cat, C) in full.  C must be a multiple of 128; nlev <= 8;
// W2cat = sum(widths); alt_corr_taps_backward_tile must be at least 1.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int alt_corr_taps_backward(const float* f1, const float* f2,
                                      const float* taps, const float* g,
                                      float* df1, float* df2, long rows,
                                      int w1, int w2cat, int c, int kk,
                                      float scale, int nlev,
                                      const int* offsets, const int* widths,
                                      void* stream) {
  if (nlev < 1 || nlev > kMaxLevels || c % 128 != 0 || c < 128 || kk < 1)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int tile = w1 ? alt_corr_taps_backward_tile(w1, nlev, kk) : 1;
  if (tile < 1) return (int)cudaErrorInvalidValue;
  const long smem = tile_smem(tile, nlev, kk);
  Levels lv;
  lv.n = nlev;
  for (int l = 0; l < kMaxLevels; ++l) {
    lv.off[l] = l < nlev ? offsets[l] : 0;
    lv.width[l] = l < nlev ? widths[l] : 0;
  }
  const bool split = tile < w1 || c > 128 * kMaxChunks;
  auto kernel = split ? alt_corr_taps_bwd_kernel<true>
                      : alt_corr_taps_bwd_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)rows, 32 * kWarpsPerBlock, (size_t)smem,
           static_cast<cudaStream_t>(stream)>>>(
      f1, f2, taps, g, df1, df2, w1, w2cat, c, kk, scale, lv, tile);
  return (int)cudaGetLastError();
}
