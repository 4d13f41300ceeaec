// Per-(image, channel) fp32 sum and sum of squares of an NCHW tensor, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel raftstereo_tpu/ops/pallas_norm.py
// `_in_stats_kernel`, as the fused encoder stage reaches it through
// raftstereo_tpu/ops/pallas_encoder.py `_packed_stats` (row 10: the
// statistics of a conv1 output that the stage did not compute itself);
// it is also the body of that file's stand-alone instance-norm stats.
// Function: stats[b, 0, c] = sum_{y,x} x[b, c, y, x] and
// stats[b, 1, c] = sum_{y,x} x[b, c, y, x]^2, in fp32.
//
// Design.  One block per (image, channel) plane, which NCHW keeps
// contiguous: each of 256 threads sums a strided share of the plane with
// 16-byte loads (552,960 values of a 576x960 plane are 2,160 per thread),
// then a butterfly per warp and the 8 warps in order.  Blocked partial
// sums keep E[x^2] - mean^2 well inside the envelope a single running sum
// would leave, and the fixed order makes two calls bitwise equal.
//
// Bound on an H100 SXM (3.35 TB/s): bytes, one read of the tensor (141.6
// MB per 64-channel 576x960 image, 42 us); two FLOPs per element.  The
// design reads each element once; enough planes are in flight (B x 64 of
// them) to keep every SM's loads busy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(256)
enc_plane_stats_kernel(const float* __restrict__ x, float* __restrict__ stats,
                       int c, long hw) {
  __shared__ float s_red[8][2];
  const int ch = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* p = x + ((long)b * c + ch) * hw;
  float s = 0.f, q = 0.f;
  if ((hw & 3) == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
    for (long i = tid; i < hw / 4; i += 256) {
      const float4 v = __ldg(p4 + i);
      s += v.x; q = fmaf(v.x, v.x, q);
      s += v.y; q = fmaf(v.y, v.y, q);
      s += v.z; q = fmaf(v.z, v.z, q);
      s += v.w; q = fmaf(v.w, v.w, q);
    }
  } else {
    for (long i = tid; i < hw; i += 256) {
      const float v = __ldg(p + i);
      s += v;
      q = fmaf(v, v, q);
    }
  }
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
    stats[((long)b * 2 + tid) * c + ch] = t;
  }
}

}  // namespace

// x (B, C, H*W) fp32 contiguous -> stats (B, 2, C): sums, then sums of
// squares.  Returns the CUDA error code of the launch (0 on success).
extern "C" int enc_stats_forward(const float* x, float* stats, int batch,
                                 int c, long hw, void* stream) {
  if (batch < 1 || c < 1 || hw < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  enc_plane_stats_kernel<<<dim3(c, batch), 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(x, stats, c,
                                                                hw);
  return (int)cudaGetLastError();
}
