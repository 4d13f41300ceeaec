// The fused encoder stages' finish for Hopper (sm_90a), fp32, NCHW:
//   out = relu(relu(a' + relu(b*sb + tb)) + relu(c*sc + tc))
// with a' = relu(a*sa + ta) (stem + layer1: t0 + u2, then + v2) or
// a' = a*sa + ta (layer2: the projection norm has no relu), and (s, t) the
// per-(image, channel) prep affines.
//
// Replaces the TPU kernels raftstereo_tpu/ops/pallas_encoder.py
// `_enc_finish_kernel` (row 11, launched from `_stage_on_packed`) and
// raftstereo_tpu/ops/pallas_layer2.py `_l2_finish_kernel` (row 17).
//
// Design.  Elementwise: each thread takes 4 neighbouring elements of one
// plane with 16-byte loads and stores (when H*W is a multiple of 4),
// looks up its plane's six affine values, and walks the tensor in a
// grid-stride loop.
//
// Bound on an H100 SXM (3.35 TB/s): bytes, three reads and one write of
// the tensor (566 MB per 64-channel 576x960 image, 0.17 ms); about 12
// FLOPs per element.  The design moves each byte once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Args {
  const float* a;
  const float* b;
  const float* c;
  const float* sa;
  const float* ta;
  const float* sb;
  const float* tb;
  const float* sc;
  const float* tc;
  float* out;
  long hw, n;
};

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

template <bool A_RELU>
__device__ __forceinline__ float finish(const Args& g, float va, float vb,
                                        float vc, long plane) {
  float t0 = fmaf(va, __ldg(g.sa + plane), __ldg(g.ta + plane));
  if (A_RELU) t0 = relu(t0);
  const float u = relu(fmaf(vb, __ldg(g.sb + plane), __ldg(g.tb + plane)));
  const float v = relu(fmaf(vc, __ldg(g.sc + plane), __ldg(g.tc + plane)));
  return relu(relu(t0 + u) + v);
}

template <bool A_RELU, bool VEC4>
__global__ void __launch_bounds__(256) enc_finish_kernel(const Args g) {
  const long stride = (long)gridDim.x * blockDim.x;
  if (VEC4) {
    for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < g.n / 4;
         i += stride) {
      const long plane = i * 4 / g.hw;
      const float4 a = __ldg(reinterpret_cast<const float4*>(g.a) + i);
      const float4 b = __ldg(reinterpret_cast<const float4*>(g.b) + i);
      const float4 c = __ldg(reinterpret_cast<const float4*>(g.c) + i);
      float4 o;
      o.x = finish<A_RELU>(g, a.x, b.x, c.x, plane);
      o.y = finish<A_RELU>(g, a.y, b.y, c.y, plane);
      o.z = finish<A_RELU>(g, a.z, b.z, c.z, plane);
      o.w = finish<A_RELU>(g, a.w, b.w, c.w, plane);
      reinterpret_cast<float4*>(g.out)[i] = o;
    }
  } else {
    for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < g.n;
         i += stride)
      g.out[i] = finish<A_RELU>(g, __ldg(g.a + i), __ldg(g.b + i),
                                __ldg(g.c + i), i / g.hw);
  }
}

template <bool A_RELU, bool VEC4>
int launch(const Args& g, cudaStream_t s) {
  const long work = VEC4 ? g.n / 4 : g.n;
  long blocks = (work + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;
  enc_finish_kernel<A_RELU, VEC4><<<(unsigned)blocks, 256, 0, s>>>(g);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// a, b, c, out (B, C, H, W) fp32 contiguous; sa..tc (B, C) affines;
// a_relu 1 for the stem + layer1 form, 0 for layer2's.  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int enc_finish_forward(const float* a, const float* sa,
                                  const float* ta, const float* b,
                                  const float* sb, const float* tb,
                                  const float* c, const float* sc,
                                  const float* tc, float* out, long planes,
                                  long hw, int a_relu, void* stream) {
  if (planes < 1 || hw < 1) return (int)cudaErrorInvalidValue;
  const Args g{a, b, c, sa, ta, sb, tb, sc, tc, out, hw, planes * hw};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = hw % 4 == 0 && aligned16(a) && aligned16(b) &&
                    aligned16(c) && aligned16(out);
  if (a_relu) return vec4 ? launch<true, true>(g, s) : launch<true, false>(g, s);
  return vec4 ? launch<false, true>(g, s) : launch<false, false>(g, s);
}
