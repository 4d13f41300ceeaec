// Per-(image, channel) fp32 plane sums of NCHW tensors, for Hopper
// (sm_90a).  Two entry points share one design:
//
// * enc_stats_forward: stats[b, 0, c] = sum_{y,x} x[b, c, y, x] and
//   stats[b, 1, c] = sum_{y,x} x[b, c, y, x]^2.  Replaces the TPU kernel
//   raftstereo_tpu/ops/pallas_norm.py `_in_stats_kernel`, as the fused
//   encoder stage reaches it through raftstereo_tpu/ops/pallas_encoder.py
//   `_packed_stats` (row 10: the statistics of a conv1 output that the
//   stage did not compute itself); it is also the body of that file's
//   stand-alone instance-norm stats.
// * enc_dual_sums_forward: sums[b, 0, c] = sum_{y,x} u[b, c, y, x] and
//   sums[b, 1, c] = sum_{y,x} u[b, c, y, x] * v[b, c, y, x].  Replaces
//   raftstereo_tpu/ops/pallas_encoder.py `_dual_sum_kernel` (row 14, the
//   two reductions of the instance-norm VJP, mean(u) and mean(u * xhat),
//   reached from `_in_bwd_means` five times per stage backward).  The TPU
//   kernel sums a packed pixel-pair view and halves its channel axis
//   afterwards; NCHW keeps a plane contiguous, so this one sums the plane
//   directly.
//
// Design.  One block per (image, channel) plane, which NCHW keeps
// contiguous: each of 256 threads sums a strided share of the plane with
// 16-byte loads (552,960 values of a 576x960 plane are 2,160 per thread),
// then a butterfly per warp and the 8 warps in order.  Blocked partial
// sums keep E[x^2] - mean^2 well inside the envelope a single running sum
// would leave, and the fixed order makes two calls bitwise equal.
//
// Bound on an H100 SXM (3.35 TB/s): bytes, one read of each input (stats:
// 141.6 MB per 64-channel 576x960 image, 42 us; dual sums at the training
// recipe's fnet backward, u and v each 12x64x320x720: 1.416 GB, 0.42 ms);
// two FLOPs per element and input.  The design reads each element once;
// enough planes are in flight (B x 64 of them, each thread with two
// 16-byte loads outstanding for the dual sums) to keep every SM's loads
// busy.
//
// With `bf16` set, each entry runs its bf16 form: the same kernel over
// bf16 planes, 8 values a 16-byte load converted to fp32 in registers,
// fp32 sums.  enc_stats_forward's is row 10's (the TPU kernel reads its
// input's dtype and sums `x.astype(float32)`, pallas_norm.py:58-63);
// bound: bytes, half the fp32 form's (70.8 MB per 64-channel 576x960
// image, 21 us).  enc_dual_sums_forward's is row 14's, which the JAX
// package runs when it trains the fused encoder in bf16: its kernel
// upcasts u and v in registers (pallas_encoder.py:1158-1159) and keeps
// them in their storage dtype in memory, since an fp32 copy of a recipe
// tensor would take 708 MB; each product of two bf16 values is exact in
// fp32.  Bound: bytes, u and v each 12x64x320x720 in bf16 (707.8 MB
// together), 0.2113 ms.

#include "enc_bf16.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Warp butterflies, then the 8 warps' partials in order; thread 0 and 1
// store the plane's two sums at out[(b * 2 + k) * c + ch].
__device__ __forceinline__ void block_store(float s, float q, float* out,
                                            int c, int ch, int b) {
  __shared__ float s_red[8][2];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, m);
    q += __shfl_xor_sync(0xffffffffu, q, m);
  }
  if (lane == 0) {
    s_red[warp][0] = s;
    s_red[warp][1] = q;
  }
  __syncthreads();
  if (tid < 2) {
    float t = 0.f;
    for (int w = 0; w < 8; ++w) t += s_red[w][tid];
    out[((long)b * 2 + tid) * c + ch] = t;
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
enc_plane_stats_kernel(const T* __restrict__ x, float* __restrict__ stats,
                       int c, long hw) {
  constexpr int kV = 16 / sizeof(T);
  const int ch = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const T* p = x + ((long)b * c + ch) * hw;
  float s = 0.f, q = 0.f;
  if (hw % kV == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint4* p16 = reinterpret_cast<const uint4*>(p);
    for (long i = tid; i < hw / kV; i += 256) {
      Pack16<T> u;
      u.u = __ldg(p16 + i);
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        const float v = to_f(u.v[e]);
        s += v;
        q = fmaf(v, v, q);
      }
    }
  } else {
    for (long i = tid; i < hw; i += 256) {
      const float v = to_f(__ldg(p + i));
      s += v;
      q = fmaf(v, v, q);
    }
  }
  block_store(s, q, stats, c, ch, b);
}

template <typename T>
__global__ void __launch_bounds__(256)
enc_dual_sums_kernel(const T* __restrict__ u, const T* __restrict__ v,
                     float* __restrict__ sums, int c, long hw) {
  constexpr int kV = 16 / sizeof(T);
  const int ch = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const long off = ((long)b * c + ch) * hw;
  const T* pu = u + off;
  const T* pv = v + off;
  float s = 0.f, q = 0.f;
  if (hw % kV == 0 && (reinterpret_cast<uintptr_t>(pu) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(pv) & 15) == 0) {
    const uint4* u16 = reinterpret_cast<const uint4*>(pu);
    const uint4* v16 = reinterpret_cast<const uint4*>(pv);
#pragma unroll 2
    for (long i = tid; i < hw / kV; i += 256) {
      Pack16<T> a, w;
      a.u = __ldg(u16 + i);
      w.u = __ldg(v16 + i);
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        const float x = to_f(a.v[e]);
        s += x;
        q = fmaf(x, to_f(w.v[e]), q);
      }
    }
  } else {
    for (long i = tid; i < hw; i += 256) {
      const float x = to_f(__ldg(pu + i));
      s += x;
      q = fmaf(x, to_f(__ldg(pv + i)), q);
    }
  }
  block_store(s, q, sums, c, ch, b);
}

}  // namespace

// x (B, C, H*W) contiguous, fp32 or (bf16 set) bf16 -> stats (B, 2, C)
// fp32: sums, then sums of squares.  Returns the CUDA error code of the
// launch (0 on success).
extern "C" int enc_stats_forward(const void* x, float* stats, int batch,
                                 int c, long hw, int bf16, void* stream) {
  if (batch < 1 || c < 1 || hw < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(c, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    enc_plane_stats_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), stats, c, hw);
  else
    enc_plane_stats_kernel<float><<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), stats, c, hw);
  return (int)cudaGetLastError();
}

// u, v (B, C, H*W) contiguous, both fp32 or (bf16 set) both bf16 -> sums
// (B, 2, C) fp32: sums of u, then sums of u * v.  Returns the CUDA error
// code of the launch (0 on success).
extern "C" int enc_dual_sums_forward(const void* u, const void* v,
                                     float* sums, int batch, int c, long hw,
                                     int bf16, void* stream) {
  if (batch < 1 || c < 1 || hw < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(c, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    enc_dual_sums_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(u),
        static_cast<const __nv_bfloat16*>(v), sums, c, hw);
  else
    enc_dual_sums_kernel<float><<<grid, 256, 0, s>>>(
        static_cast<const float*>(u), static_cast<const float*>(v), sums, c,
        hw);
  return (int)cudaGetLastError();
}
