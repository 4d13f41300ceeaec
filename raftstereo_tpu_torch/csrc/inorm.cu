// Stand-alone instance norm (no affine, eps 1e-5), with an optional fused
// relu, for Hopper (sm_90a): NCHW, fp32 or bf16.  Two kernels, two
// launches, as on the TPU:
//
// * inorm_stats: per (image, channel) plane, fp32 sums of x and x^2 over
//   (H, W), then mean = s1 / n, var = max(s2 / n - mean^2, 0) and
//   rstd = 1 / sqrt(var + 1e-5), written as (B, 2, C) fp32.  Replaces
//   raftstereo_tpu/ops/pallas_norm.py `_in_stats_kernel` as
//   `_pallas_forward` launches it (pallas_norm.py:90; the few (B, C)
//   operations that follow it in XLA are this kernel's epilogue here).
//   It is its own kernel, not enc_stats.cu's plane sums: it reads bf16
//   too and ends in the mean and rstd.
// * inorm_apply: y = (x - mean) * rstd with mean and rstd cast to x's
//   dtype first, then relu if asked, written in x's dtype.  Replaces
//   `_in_apply_kernel` (launched at pallas_norm.py:115).  In bf16 every
//   operation rounds to bf16, as XLA's bf16 arithmetic does.
//
// Every fp32 operation of the epilogue and of the apply rounds once
// (__fmul_rn and friends keep nvcc from contracting them into FMAs), so the
// results follow the plain version's arithmetic; only the order of the
// plane sums differs.  A NaN input gives NaN, as jnp.maximum and relu
// propagate it.
//
// Design.  The TPU kernel walks row blocks of an NHWC image in a
// sequential grid, carrying the sums in its output block.  NCHW keeps a
// plane contiguous, so here one block of 256 threads sums one plane with
// 16-byte loads (4 fp32 or 8 bf16 values a thread), then a butterfly per
// warp and the 8 warps in order: a fixed order, so two calls give equal
// bits.  The apply is a streaming elementwise pass, one thread per 16
// bytes.  It could be a Triton kernel; it is CUDA so that the port keeps
// one build path (nvcc, ctypes) and one launcher style.
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  The stats read x once, the
// apply reads it and writes y: at 2x64x288x480 fp32 (fnet's first norm at
// a 576x960 bucket) three passes of 70.8 MB, 63 us; about 3 FLOPs per
// element in each pass.  What this design does about it: each pass reads
// and writes every element once with 16-byte accesses, and the (B, C)
// statistics never leave the stats launch as sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int V = 4;
  using Raw = float4;
  __device__ __forceinline__ static void unpack(const Raw& r, float* v) {
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
  __device__ __forceinline__ static Raw pack(const float* v) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ __forceinline__ static float one(float x) { return x; }
  __device__ __forceinline__ static float put(float v) { return v; }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int V = 8;
  using Raw = uint4;
  __device__ __forceinline__ static void unpack(const Raw& r, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static Raw pack(const float* v) {
    Raw r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i],
                                                            v[2 * i + 1]);
    return r;
  }
  __device__ __forceinline__ static float one(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ __forceinline__ static __nv_bfloat16 put(float v) {
    return __float2bfloat16_rn(v);
  }
};

// Round to the storage dtype and back: bf16 arithmetic rounds each result.
__device__ __forceinline__ float rnd(float v, float) { return v; }
__device__ __forceinline__ float rnd(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
inorm_stats_kernel(const T* __restrict__ x, float* __restrict__ stats, int c,
                   long hw) {
  using P = Pack<T>;
  const int ch = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const T* p = x + ((long)b * c + ch) * hw;
  float s = 0.f, q = 0.f;
  if (hw % P::V == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const typename P::Raw* pv = reinterpret_cast<const typename P::Raw*>(p);
    for (long i = tid; i < hw / P::V; i += kThreads) {
      float v[P::V];
      P::unpack(pv[i], v);
#pragma unroll
      for (int k = 0; k < P::V; ++k) {
        s += v[k];
        q = fmaf(v[k], v[k], q);
      }
    }
  } else {
    for (long i = tid; i < hw; i += kThreads) {
      const float v = P::one(p[i]);
      s += v;
      q = fmaf(v, v, q);
    }
  }
  __shared__ float red[kThreads / 32][2];
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, m);
    q += __shfl_xor_sync(0xffffffffu, q, m);
  }
  if (lane == 0) {
    red[warp][0] = s;
    red[warp][1] = q;
  }
  __syncthreads();
  if (tid == 0) {
    float s1 = 0.f, s2 = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) {
      s1 += red[w][0];
      s2 += red[w][1];
    }
    const float n = (float)hw;
    const float mean = __fdiv_rn(s1, n);
    float var = __fsub_rn(__fdiv_rn(s2, n), __fmul_rn(mean, mean));
    if (!(var >= 0.f) && !isnan(var)) var = 0.f;  // max(var, 0), NaN kept
    const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, 1e-5f)));
    stats[((long)b * 2) * c + ch] = mean;
    stats[((long)b * 2 + 1) * c + ch] = rstd;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
inorm_apply_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                   T* __restrict__ y, int c, long hw, int relu) {
  using P = Pack<T>;
  const long plane = blockIdx.x;
  const long b = plane / c, ch = plane - b * c;
  const float m = rnd(stats[(b * 2) * c + ch], T());
  const float s = rnd(stats[(b * 2 + 1) * c + ch], T());
  const T* px = x + plane * hw;
  T* py = y + plane * hw;
  const long i0 = ((long)blockIdx.y * kThreads + threadIdx.x) * P::V;
  if (i0 >= hw) return;
  auto norm = [&](float v) {
    float r = rnd(__fmul_rn(rnd(__fsub_rn(v, m), T()), s), T());
    if (relu && !(r > 0.f) && !isnan(r)) r = 0.f;
    return r;
  };
  if (hw % P::V == 0 && (reinterpret_cast<uintptr_t>(px) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(py) & 15) == 0) {
    float v[P::V];
    P::unpack(*reinterpret_cast<const typename P::Raw*>(px + i0), v);
#pragma unroll
    for (int k = 0; k < P::V; ++k) v[k] = norm(v[k]);
    *reinterpret_cast<typename P::Raw*>(py + i0) = P::pack(v);
  } else {
    for (long i = i0; i < i0 + P::V && i < hw; ++i)
      py[i] = P::put(norm(P::one(px[i])));
  }
}

}  // namespace

// x (B, C, H*W) contiguous, fp32 (bf16 = 0) or bf16 (bf16 = 1) -> stats
// (B, 2, C) fp32: per plane the mean, then the rstd.  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int inorm_stats_forward(const void* x, float* stats, int batch,
                                   int c, long hw, int bf16, void* stream) {
  if (batch < 1 || c < 1 || hw < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(c, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    inorm_stats_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), stats, c, hw);
  else
    inorm_stats_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), stats, c, hw);
  return (int)cudaGetLastError();
}

// x and y (B, C, H*W) contiguous, one dtype (fp32 or bf16, as above);
// stats from inorm_stats_forward.  y = (x - mean) * rstd, then relu when
// relu = 1.  Returns the CUDA error code of the launch (0 on success).
extern "C" int inorm_apply_forward(const void* x, const float* stats, void* y,
                                   int batch, int c, long hw, int relu,
                                   int bf16, void* stream) {
  const int v = bf16 ? 8 : 4;
  const long chunks = (hw + (long)kThreads * v - 1) / ((long)kThreads * v);
  if (batch < 1 || c < 1 || hw < 1 || chunks > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((long)batch * c), (unsigned)chunks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    inorm_apply_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), stats,
        static_cast<__nv_bfloat16*>(y), c, hw, relu);
  else
    inorm_apply_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), stats, static_cast<float*>(y), c, hw,
        relu);
  return (int)cudaGetLastError();
}
