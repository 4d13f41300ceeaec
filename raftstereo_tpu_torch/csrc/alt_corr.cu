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
// staged as bf16 and widened to fp32 exactly at the FMA (products of bf16
// values are exact in fp32), as the TPU's matrix unit takes them with
// preferred_element_type=float32; a bf16 output is the fp32 result
// rounded once.
//
// Design.  The TPU kernel computes whole (block x W2cat) correlation rows
// on its matrix unit and masks them.  Here only the K+1 window dot products
// a pixel needs are computed (40 dots of length 256 at the flagship
// shapes), from shared memory.  A block owns one image row and a tile of
// kTilePix consecutive pixels.  Per level, the tile's windows lie in one
// span of columns, [min floor(x_l) - r, max floor(x_l) + r + 1] clipped to
// the level (NaN pixels and pixels whose window misses the level left
// out); the levels' spans are allotted rows of a staging buffer of
// kSpanRows rows in level order, and a level whose span does not fit is
// "wide".  The tile's fmap1 rows and the staged spans' fmap2 rows go to
// shared memory in 128-byte channel chunks (32 fp32 or 64 bf16 channels)
// through a kStages-deep `cp.async` ring, so each fmap2 row is read from
// L2 once per tile, not once per pixel whose window covers it.  Each thread
// owns whole dot products: one pixel and a group of its window's columns
// (one level), fmap1's 16-byte slot in registers, reused across those
// columns.  Within a chunk, lane i reads slot (s + i) mod 8 at step s of
// both its fmap1 row and its columns' rows: the 8 lanes of a quarter-warp
// read 8 different slots, so the rows they read, whichever they are, hit
// different banks (a row is 128 bytes, all 32 banks).  No shuffles: a
// thread sums its own dots in fp32 FMAs over the chunks.  A wide level (a
// disparity jump inside the tile) is summed after the staged ones, inside
// this kernel, from global memory (`wide_dots`): a warp per pixel, lanes
// across the channels, the window's rows loaded together and reduced by
// shuffles, as many rows in flight as a staged pass keeps (one thread per
// dot reading 16-byte slots from global memory made a tile with a jump
// several times slower than a staged one, and the kernel's tail with it:
// PERF.md section 6).  The window sums go to shared memory; then the tile's
// contiguous output is written by consecutive threads, lerp and scale as
// before.  The staging and the dot loop (`TileSpans`, `plan_spans`,
// `issue_chunk`, `wide_dots`, `lookup_tile`) live in alt_corr_tile.cuh,
// shared with the lookup with convc1 fused (alt_corr_epi.cu); each kernel
// gives `lookup_tile` its own output step.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): at 144x240, C=256, 4 levels of radius 4 the call must read fmap1
// (35 MB) and the fmap2 pyramid (up to 66 MB) once and does about 0.7
// GFLOP, so it is bound by bytes, about 30 us.  In bf16 (the bf16 serving
// path: fmap1 17.7 MB, the pyramid 33.2 MB, a bf16 output 2.5 MB) about 53
// MB, about 16 us.  What holds this design back from that: every FMA reads
// one 4-byte fmap2 operand from shared memory (the dots share no operand
// in registers across pixels), so shared memory's 128 bytes a cycle per SM
// cap it near 50 us at the flagship shapes; few blocks per SM (3, by
// shared memory) to hide each chunk's copy and barrier; a tile whose
// disparities spread re-reads, from L2, the fmap2 rows that its
// neighbouring tiles stage too (~3x the pyramid on the smoke's random
// [-60, 0] field, ~1.5x on a smooth one); and a block's setup (spans, the
// ring's first chunk) before its first FMA.  The whole tile x span product
// on the tensor cores (3xTF32 mma.sync in fp32, bf16 m16n8k16), windows
// picked after, was slower in fp32 and no faster in bf16 than this form at
// 3 blocks per SM (PERF.md section 6).

#include "alt_corr_tile.cuh"

#include <type_traits>

namespace {

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One block's tile: the window sums, then the tile's contiguous output,
// consecutive threads writing consecutive values (lerp and scale).
template <int R, typename TIn, typename TOut>
__device__ __forceinline__ void lookup_out(
    const TIn* __restrict__ f1, const TIn* __restrict__ f2,
    const float* __restrict__ x, TOut* __restrict__ out, int w1, int w2cat,
    int c, float scale, int ntiles, int groups, const Levels& lv) {
  constexpr int K = 2 * R + 1;
  constexpr int D = K + 1;
  lookup_tile<R>(
      f1, f2, x, w1, w2cat, c, scale, ntiles, groups, lv,
      [&](char*, const float* xs, const float* win, long row, int p0,
          int np) {
        const int L = lv.n;
        const int lk = L * K;
        TOut* o = out + (row * w1 + p0) * (long)lk;
        for (int e = threadIdx.x; e < np * lk; e += kThreads) {
          const int p = e / lk, r = e - p * lk;
          const int lv_ = r / K, k = r - lv_ * K;
          const float xl = xs[p] * (1.0f / (float)(1 << lv_));
          const float fr = xl - floorf(xl);
          const float* w = win + (p * L + lv_) * D;
          put(o + e, w[k] * (1.f - fr) + w[k + 1] * fr);
        }
      });
}

// fp32 feature maps: no minimum of blocks an SM; ptxas keeps ~72
// registers at radius 4, so shared memory sets 3 blocks an SM.  A form
// that took 108 or 128 registers (2 blocks an SM) ran ~30% slower
// (PERF.md section 6).
template <int R, typename TOut>
__global__ void __launch_bounds__(kThreads)
alt_corr_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                const float* __restrict__ x, TOut* __restrict__ out, int w1,
                int w2cat, int c, float scale, int ntiles, int groups,
                Levels lv) {
  lookup_out<R>(f1, f2, x, out, w1, w2cat, c, scale, ntiles, groups, lv);
}

// bf16 feature maps: at most 85 registers, so 3 blocks share an SM
// whatever ptxas would take unbounded.
template <int R, typename TOut>
__global__ void __launch_bounds__(kThreads, 3)
alt_corr_bf16_kernel(const __nv_bfloat16* __restrict__ f1,
                     const __nv_bfloat16* __restrict__ f2,
                     const float* __restrict__ x, TOut* __restrict__ out,
                     int w1, int w2cat, int c, float scale, int ntiles,
                     int groups, Levels lv) {
  lookup_out<R>(f1, f2, x, out, w1, w2cat, c, scale, ntiles, groups, lv);
}

template <int R, typename TIn, typename TOut>
int launch(const void* f1, const void* f2, const float* x, void* out,
           long npix, int w1, int w2cat, int c, float scale,
           const Levels& lv, cudaStream_t stream) {
  void (*kernel)(const TIn*, const TIn*, const float*, TOut*, int, int, int,
                 float, int, int, Levels);
  if constexpr (std::is_same<TIn, float>::value)
    kernel = alt_corr_kernel<R, TOut>;
  else
    kernel = alt_corr_bf16_kernel<R, TOut>;
  const size_t smem = smem_bytes<R>(lv.n);
  static bool opted = false;  // one attribute call per instance
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<R>(kMaxLevels));
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  // Column groups per window: as many units (pixel, level, group) as fit
  // the block's threads, at most one column each.
  const int groups = max(1, min(2 * R + 2, kThreads / (kTilePix * lv.n)));
  const int ntiles = (w1 + kTilePix - 1) / kTilePix;
  const long blocks = npix / w1 * ntiles;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const TIn*>(f1), static_cast<const TIn*>(f2), x,
      static_cast<TOut*>(out), w1, w2cat, c, scale, ntiles, groups, lv);
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
// (out_bf16 = 0) or bf16; all contiguous, the feature maps 16-byte
// aligned.  C must be a multiple of 128 (fp32) or 256 (bf16) and at most
// 512; radius 1..8; nlev <= 8; npix a multiple of W1.  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int alt_corr_forward(const void* f1, const void* f2,
                                const float* x, void* out, long npix,
                                int w1, int w2cat, int c, int radius,
                                float scale, int nlev, const int* offsets,
                                const int* widths, int in_bf16, int out_bf16,
                                void* stream) {
  const int chunk = in_bf16 ? 256 : 128;
  if (nlev < 1 || nlev > kMaxLevels || c % chunk != 0 || c > 512 ||
      w1 < 1 || npix % w1 != 0)
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
