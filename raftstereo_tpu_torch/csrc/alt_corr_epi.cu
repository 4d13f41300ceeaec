// On-demand correlation lookup with the motion encoder's 1x1 convc1 fused
// in as its epilogue, for Hopper (sm_90a): fp32 or bf16 feature maps in,
// bf16 out.
//
// Replaces the TPU kernel raftstereo_tpu/ops/pallas_alt.py
// `_alt_pyr_radial_epi_kernel` (the epilogue branch of
// `_alt_pyr_radial_fwd_impl`, entry `pallas_alt_pyramid_radial_epi_flat`),
// which the JAX model takes in bf16 test mode when the GRU step is the
// module step.  Function, per pixel: the L*K correlation columns of
// alt_corr.cu (window dots of fmap1 with each fmap2 level, lerp by
// frac(x_l), fp32), each rounded to bf16, then
//   out[n] = relu(bf16(sum_j col[j] * W[j, n]) + b[n])   (the add in bf16)
// with W (L*K, 64) and b (64) in bf16 and the sum in fp32, as the TPU's
// matrix unit takes bf16 operands with preferred_element_type=float32.
// relu keeps NaN (a NaN coordinate poisons the pixel, as on the TPU).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 on the tensor cores,
// 67 TFLOP/s fp32 outside them): at 144x240, C=256, 4 levels of radius 4,
// bf16 feature maps, the call must read fmap1 (17.7 MB) and the fmap2
// pyramid (33.2 MB) once and write 4.4 MB of output, about 55 MB, about
// 17 us; its 1.4 GFLOP (the window dots and the 36x64 product) take
// about 21 us in fp32 FMAs on the CUDA cores, 1.4 us on the tensor cores.
// So it is bound by bytes.
//
// Design.  Row 1's staged tiles (alt_corr_tile.cuh, shared with
// alt_corr.cu, whose note describes them): a 256-thread block per (image
// row, 32-pixel tile) stages the tile's fmap1 rows and each level's span
// of fmap2 rows in shared memory through a 2-stage `cp.async` ring, each
// thread sums whole window dots in fp32 FMAs, a level whose span outgrows
// the staging buffer is summed from global memory a warp per pixel
// (`wide_dots`), and the window sums land in shared memory.  Only the
// output step differs from row 1's: in the staging ring's shared memory,
// now free, the block lerps the tile's 32 x L*K columns and rounds them
// to bf16, and copies W (4.6 KB at L*K = 36) beside them; then each thread
// computes 8 outputs of one pixel, fp32 FMAs over the columns in order
// (exact bf16 products, fp32 sums), rounds, adds the bias in bf16, applies
// relu, and writes its 8 bf16 outputs as one 16-byte store: the block's
// 32 x 64 outputs are one contiguous 4 KB run.  The raw columns never
// reach device memory.  (The product as bf16 `mma.sync.m16n8k16` tiles,
// L*K padded to a multiple of 16 by zero rows of W, the columns and W
// transposed through shared memory for `ldmatrix`, was 10-11% slower:
// PERF.md section 6.)
// What still holds it back: row 1's limits (every FMA of the window dots
// reads a 4-byte operand from shared memory; 3 blocks an SM to hide each
// chunk's copy and barrier; tiles whose disparities spread re-read, from
// L2, fmap2 rows their neighbours stage too; a level whose span outgrows
// the staging buffer, summed by `wide_dots` a warp per pixel, costs more
// than the parent's warp-per-pixel form did there), and the product,
// about a fifth of the dots' FMAs, after the dots with no overlap.

#include "alt_corr_tile.cuh"

#include <type_traits>

namespace {

constexpr int kOut = 64;  // convc1 output channels
constexpr int kOutPerThread = kOut * kTilePix / kThreads;  // 8: 16 bytes
static_assert(kOutPerThread == 8, "one 16-byte store of outputs a thread");

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float relu_keep_nan(float v) {
  return v < 0.f ? 0.f : v;
}

__device__ __forceinline__ float convc1_out(float acc, float b) {
  return relu_keep_nan(round_bf16(round_bf16(acc) + b));
}

// The tile's column j of pixel p, rounded to bf16 (the lerp of its window
// sums by frac(x_l)).
template <int K>
__device__ __forceinline__ float column(const float* xs, const float* win,
                                        int L, int p, int j) {
  const int lv_ = j / K, k = j - lv_ * K;
  const float xl = xs[p] * (1.0f / (float)(1 << lv_));
  const float fr = xl - floorf(xl);
  const float* wv = win + (p * L + lv_) * (K + 1);
  return round_bf16(wv[k] * (1.f - fr) + wv[k + 1] * fr);
}

// The tile's convc1 on the CUDA cores: thread = pixel p, outputs n0 ..
// n0 + 7.  A warp reads 4 pixels' column (4 words in distinct banks: lk =
// L * K with K odd and L <= 8 is not a multiple of 16) and one 128-byte
// row of W per step.
template <int K>
__device__ __forceinline__ void product(
    char* stage, const float* xs, const float* win,
    const __nv_bfloat16* __restrict__ w,
    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ o,
    int L, int np) {
  const int lk = L * K;
  // cols[p * lk + j]: pixel p's column j, a bf16 value held as fp32;
  // ws[j * kOut + n]: W, as bf16 (16-byte aligned: lk * 128 bytes).
  float* cols = reinterpret_cast<float*>(stage);
  __nv_bfloat16* ws =
      reinterpret_cast<__nv_bfloat16*>(stage + kTilePix * lk * 4);
  for (int q = threadIdx.x; q < lk * kOut / 8; q += kThreads)
    reinterpret_cast<uint4*>(ws)[q] =
        __ldg(reinterpret_cast<const uint4*>(w) + q);
  for (int e = threadIdx.x; e < np * lk; e += kThreads) {
    const int p = e / lk;
    cols[e] = column<K>(xs, win, L, p, e - p * lk);
  }
  __syncthreads();
  const int p = threadIdx.x / (kOut / kOutPerThread);
  const int n0 = threadIdx.x % (kOut / kOutPerThread) * kOutPerThread;
  if (p >= np) return;
  float acc[kOutPerThread];
#pragma unroll
  for (int v = 0; v < kOutPerThread; ++v) acc[v] = 0.f;
  const float* cp = cols + p * lk;
#pragma unroll 4
  for (int j = 0; j < lk; ++j) {
    float wf[kOutPerThread];
    Vec<__nv_bfloat16>::widen(
        *reinterpret_cast<const uint4*>(ws + j * kOut + n0), wf);
    const float cj = cp[j];
#pragma unroll
    for (int v = 0; v < kOutPerThread; ++v) acc[v] = fmaf(cj, wf[v], acc[v]);
  }
  float bf[kOutPerThread];
  Vec<__nv_bfloat16>::widen(__ldg(reinterpret_cast<const uint4*>(bias + n0)),
                            bf);
  unsigned packed[kOutPerThread / 2];
#pragma unroll
  for (int v = 0; v < kOutPerThread; v += 2) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(
        convc1_out(acc[v], bf[v]), convc1_out(acc[v + 1], bf[v + 1]));
    packed[v / 2] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(o + (long)p * kOut + n0) =
      make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

// One block's tile: the window sums, then the fused convc1 (see the note).
template <int R, typename TIn>
__device__ __forceinline__ void lookup_epi(
    const TIn* __restrict__ f1, const TIn* __restrict__ f2,
    const float* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
    int w1, int w2cat, int c, float scale, int ntiles, int groups,
    const Levels& lv) {
  constexpr int K = 2 * R + 1;
  lookup_tile<R>(f1, f2, x, w1, w2cat, c, scale, ntiles, groups, lv,
                 [&](char* stage, const float* xs, const float* win,
                     long row, int p0, int np) {
                   product<K>(stage, xs, win, w, bias,
                              out + (row * w1 + p0) * (long)kOut, lv.n, np);
                 });
}

// fp32 feature maps: no minimum of blocks an SM, as row 1's fp32 form.
template <int R>
__global__ void __launch_bounds__(kThreads)
alt_corr_epi_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                    const float* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    const __nv_bfloat16* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, int w1, int w2cat, int c,
                    float scale, int ntiles, int groups, Levels lv) {
  lookup_epi<R>(f1, f2, x, w, bias, out, w1, w2cat, c, scale, ntiles, groups,
                lv);
}

// bf16 feature maps: 3 blocks an SM, as row 1's bf16 form.
template <int R>
__global__ void __launch_bounds__(kThreads, 3)
alt_corr_epi_bf16_kernel(const __nv_bfloat16* __restrict__ f1,
                         const __nv_bfloat16* __restrict__ f2,
                         const float* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w,
                         const __nv_bfloat16* __restrict__ bias,
                         __nv_bfloat16* __restrict__ out, int w1, int w2cat,
                         int c, float scale, int ntiles, int groups,
                         Levels lv) {
  lookup_epi<R>(f1, f2, x, w, bias, out, w1, w2cat, c, scale, ntiles, groups,
                lv);
}

template <int R, typename TIn>
int launch(const void* f1, const void* f2, const float* x, const void* w,
           const void* bias, void* out, long npix, int w1, int w2cat, int c,
           float scale, const Levels& lv, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  void (*kernel)(const TIn*, const TIn*, const float*, const bf16*,
                 const bf16*, bf16*, int, int, int, float, int, int, Levels);
  if constexpr (std::is_same<TIn, float>::value)
    kernel = alt_corr_epi_kernel<R>;
  else
    kernel = alt_corr_epi_bf16_kernel<R>;
  const size_t smem = smem_bytes<R>(lv.n);
  static bool opted = false;  // one attribute call per instance
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<R>(kMaxLevels));
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  const int groups = max(1, min(2 * R + 2, kThreads / (kTilePix * lv.n)));
  const int ntiles = (w1 + kTilePix - 1) / kTilePix;
  const long blocks = npix / w1 * ntiles;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const TIn*>(f1), static_cast<const TIn*>(f2), x,
      static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), w1, w2cat, c, scale, ntiles, groups, lv);
  return (int)cudaGetLastError();
}

template <typename TIn>
int dispatch(int radius, const void* f1, const void* f2, const float* x,
             const void* w, const void* bias, void* out, long npix, int w1,
             int w2cat, int c, float scale, const Levels& lv,
             cudaStream_t s) {
  switch (radius) {
#define EPI_CASE(r)                                                      \
  case r:                                                                \
    return launch<r, TIn>(f1, f2, x, w, bias, out, npix, w1, w2cat, c,   \
                          scale, lv, s);
    EPI_CASE(1) EPI_CASE(2) EPI_CASE(3) EPI_CASE(4)
    EPI_CASE(5) EPI_CASE(6) EPI_CASE(7) EPI_CASE(8)
#undef EPI_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// fmap1 (B*H, W1, C), f2cat (B*H, W2cat, C), fp32 (in_bf16 = 0) or bf16
// (in_bf16 = 1); x (B*H, W1) fp32; w (nlev*(2*radius+1), 64) and b (64)
// bf16; out (B*H, W1, 64) bf16; all contiguous, the feature maps, w, b and
// out 16-byte aligned.  C must be a multiple of 128 (fp32) or 256 (bf16)
// and at most 512; radius 1..8; nlev <= 8; npix a multiple of W1.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int alt_corr_epi_forward(const void* f1, const void* f2,
                                    const float* x, const void* w,
                                    const void* bias, void* out, long npix,
                                    int w1, int w2cat, int c, int radius,
                                    float scale, int nlev,
                                    const int* offsets, const int* widths,
                                    int in_bf16, void* stream) {
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
  if (in_bf16)
    return dispatch<__nv_bfloat16>(radius, f1, f2, x, w, bias, out, npix,
                                   w1, w2cat, c, scale, lv, s);
  return dispatch<float>(radius, f1, f2, x, w, bias, out, npix, w1, w2cat,
                         c, scale, lv, s);
}
