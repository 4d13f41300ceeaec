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
// Design.  Row 1's warp-per-pixel form (alt_corr.cu): each lane holds
// C/32 channels of fmap1 in registers and reads its slice of each fmap2
// row with 16-byte loads; the K+1 window dots of a level are reduced
// across the warp with shuffles, so every lane ends with every column.
// W (4.6 KB at L*K = 36) is held in shared memory as bf16 pairs; lane i
// computes outputs 2i and 2i+1 from the columns in registers and stores
// them as one bf16 pair, so the warp writes the pixel's 64 outputs (128 B)
// in one coalesced store.  The raw columns never reach device memory.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 on the tensor cores,
// 67 TFLOP/s fp32 outside them): at 144x240, C=256, 4 levels of radius 4,
// bf16 feature maps, the call must read fmap1 (17.7 MB) and the fmap2
// pyramid (33.2 MB) once and write 4.4 MB of output, about 55 MB, about
// 17 us; its 1.4 GFLOP (the window dots and the 36x64 product) take
// about 21 us in fp32 FMAs on the CUDA cores, 1.4 us on the tensor cores.
// So it is bound by bytes; this form does its arithmetic on the CUDA
// cores, each fmap1 element read once and fmap2 rows through the caches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarpsPerBlock = 8;
constexpr int kOut = 64;  // convc1 output channels: two per lane

struct Levels {
  int n;
  int off[kMaxLevels];    // first column of level l in the concatenated W2
  int width[kMaxLevels];  // real width w2_l of level l
};

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

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float relu_keep_nan(float v) {
  return v < 0.f ? 0.f : v;
}

template <int R, typename TIn>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
alt_corr_epi_kernel(const TIn* __restrict__ f1, const TIn* __restrict__ f2,
                    const float* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    const __nv_bfloat16* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, long npix, int w1,
                    int w2cat, int c, float scale, Levels lv) {
  constexpr int K = 2 * R + 1;
  constexpr int V = Vec<TIn>::V;
  constexpr int kChunk = 32 * V;
  constexpr int kMaxChunks = 512 / kChunk;
  extern __shared__ __nv_bfloat162 ws[];  // (L*K, kOut / 2)
  const int lk = lv.n * K;
  for (int i = threadIdx.x; i < lk * kOut / 2; i += blockDim.x)
    ws[i] = reinterpret_cast<const __nv_bfloat162*>(w)[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long pix = (long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pix >= npix) return;  // whole warps exit together, after the sync
  const long row = pix / w1;
  const int nchunk = c / kChunk;

  float a[kMaxChunks][V];
  const TIn* p1 = f1 + pix * c + lane * V;
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i)
    if (i < nchunk) Vec<TIn>::load(p1 + i * kChunk, a[i]);

  const float xv = x[pix];
  const TIn* f2row = f2 + row * (long)w2cat * c + lane * V;
  float y0 = 0.f, y1 = 0.f;  // outputs 2 * lane, 2 * lane + 1

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
    for (int k = 0; k < K; ++k) {
      const float col = round_bf16(win[k] * (1.f - fr) + win[k + 1] * fr);
      const float2 wk = __bfloat1622float2(ws[(l * K + k) * (kOut / 2) + lane]);
      y0 = fmaf(col, wk.x, y0);
      y1 = fmaf(col, wk.y, y1);
    }
  }
  const float2 bb =
      __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(bias)[lane]);
  const float o0 = relu_keep_nan(round_bf16(round_bf16(y0) + bb.x));
  const float o1 = relu_keep_nan(round_bf16(round_bf16(y1) + bb.y));
  reinterpret_cast<__nv_bfloat162*>(out + pix * kOut)[lane] =
      __floats2bfloat162_rn(o0, o1);
}

template <int R, typename TIn>
int launch(const void* f1, const void* f2, const float* x, const void* w,
           const void* bias, void* out, long npix, int w1, int w2cat, int c,
           float scale, const Levels& lv, cudaStream_t stream) {
  const unsigned blocks =
      (unsigned)((npix + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const size_t smem = sizeof(__nv_bfloat16) * lv.n * (2 * R + 1) * kOut;
  alt_corr_epi_kernel<R, TIn>
      <<<blocks, 32 * kWarpsPerBlock, smem, stream>>>(
          static_cast<const TIn*>(f1), static_cast<const TIn*>(f2), x,
          static_cast<const __nv_bfloat16*>(w),
          static_cast<const __nv_bfloat16*>(bias),
          static_cast<__nv_bfloat16*>(out), npix, w1, w2cat, c, scale, lv);
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
// bf16; out (B*H, W1, 64) bf16; all contiguous.  C must be a multiple of
// 128 (fp32) or 256 (bf16) and at most 512; radius 1..8; nlev <= 8.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int alt_corr_epi_forward(const void* f1, const void* f2,
                                    const float* x, const void* w,
                                    const void* bias, void* out, long npix,
                                    int w1, int w2cat, int c, int radius,
                                    float scale, int nlev,
                                    const int* offsets, const int* widths,
                                    int in_bf16, void* stream) {
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
  if (in_bf16)
    return dispatch<__nv_bfloat16>(radius, f1, f2, x, w, bias, out, npix,
                                   w1, w2cat, c, scale, lv, s);
  return dispatch<float>(radius, f1, f2, x, w, bias, out, npix, w1, w2cat,
                         c, scale, lv, s);
}
