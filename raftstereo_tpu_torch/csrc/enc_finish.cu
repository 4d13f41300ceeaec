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
//
// The bf16 form (`enc_finish_forward` with `bf16` set: the JAX kernels at
// dt=bfloat16, the fast and turbo tiers on a fused base) is the same
// kernel on bf16 elements, 8 a 16-byte access (when H*W is a multiple of
// 8), and rounds as the TPU kernels' `_prep` does: each affine cast to
// bf16, then every product and every sum rounded to bf16 (fp32 products
// of bf16 values are exact; the fp32 sum is rounded once more to bf16),
// never a fused multiply-add.  So it is bitwise equal to its plain
// version, the same formula on bf16 tensors in PyTorch.  Bound: bytes,
// half the fp32 form's (283 MB per 64-channel 576x960 image, 0.084 ms).

#include "enc_bf16.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
struct Args {
  const T* a;
  const T* b;
  const T* c;
  const float* sa;
  const float* ta;
  const float* sb;
  const float* tb;
  const float* sc;
  const float* tc;
  T* out;
  long hw, n;
};

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// One element in fp32: the affines in fp32 FMAs.
template <bool A_RELU>
__device__ __forceinline__ float finish(const Args<float>& g, float va,
                                        float vb, float vc, long plane) {
  float t0 = fmaf(va, __ldg(g.sa + plane), __ldg(g.ta + plane));
  if (A_RELU) t0 = relu(t0);
  const float u = relu(fmaf(vb, __ldg(g.sb + plane), __ldg(g.tb + plane)));
  const float v = relu(fmaf(vc, __ldg(g.sc + plane), __ldg(g.tc + plane)));
  return relu(relu(t0 + u) + v);
}

// One element in bf16: each op rounded to bf16, as the TPU kernels'.
template <bool A_RELU>
__device__ __forceinline__ float finish(const Args<__nv_bfloat16>& g,
                                        float va, float vb, float vc,
                                        long plane) {
  float t0 = prep_bf16(va, __ldg(g.sa + plane), __ldg(g.ta + plane));
  if (A_RELU) t0 = relu(t0);
  const float u =
      relu(prep_bf16(vb, __ldg(g.sb + plane), __ldg(g.tb + plane)));
  const float v =
      relu(prep_bf16(vc, __ldg(g.sc + plane), __ldg(g.tc + plane)));
  return relu(rbf(__fadd_rn(relu(rbf(__fadd_rn(t0, u))), v)));
}

template <typename T, bool A_RELU, bool VEC>
__global__ void __launch_bounds__(256) enc_finish_kernel(const Args<T> g) {
  constexpr int kV = 16 / sizeof(T);
  const long stride = (long)gridDim.x * blockDim.x;
  if (VEC) {
    for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < g.n / kV;
         i += stride) {
      const long plane = i * kV / g.hw;
      Pack16<T> a, b, c, o;
      a.u = __ldg(reinterpret_cast<const uint4*>(g.a) + i);
      b.u = __ldg(reinterpret_cast<const uint4*>(g.b) + i);
      c.u = __ldg(reinterpret_cast<const uint4*>(g.c) + i);
#pragma unroll
      for (int e = 0; e < kV; ++e)
        o.v[e] = from_f<T>(finish<A_RELU>(g, to_f(a.v[e]), to_f(b.v[e]),
                                          to_f(c.v[e]), plane));
      reinterpret_cast<uint4*>(g.out)[i] = o.u;
    }
  } else {
    for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < g.n;
         i += stride)
      g.out[i] = from_f<T>(finish<A_RELU>(g, to_f(__ldg(g.a + i)),
                                          to_f(__ldg(g.b + i)),
                                          to_f(__ldg(g.c + i)), i / g.hw));
  }
}

template <typename T, bool A_RELU, bool VEC>
int launch(const Args<T>& g, cudaStream_t s) {
  const long work = VEC ? g.n / (16 / sizeof(T)) : g.n;
  long blocks = (work + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;
  enc_finish_kernel<T, A_RELU, VEC><<<(unsigned)blocks, 256, 0, s>>>(g);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int forward(const Args<T>& g, int a_relu, cudaStream_t s) {
  const bool vec = g.hw % (16 / sizeof(T)) == 0 && aligned16(g.a) &&
                   aligned16(g.b) && aligned16(g.c) && aligned16(g.out);
  if (a_relu)
    return vec ? launch<T, true, true>(g, s) : launch<T, true, false>(g, s);
  return vec ? launch<T, false, true>(g, s) : launch<T, false, false>(g, s);
}

template <typename T>
Args<T> args(const void* a, const float* sa, const float* ta, const void* b,
             const float* sb, const float* tb, const void* c,
             const float* sc, const float* tc, void* out, long planes,
             long hw) {
  return Args<T>{static_cast<const T*>(a), static_cast<const T*>(b),
                 static_cast<const T*>(c), sa, ta, sb, tb, sc, tc,
                 static_cast<T*>(out), hw, planes * hw};
}

}  // namespace

// a, b, c, out (B, C, H, W) contiguous, fp32 or (bf16 set) bf16; sa..tc
// (B, C) fp32 affines; a_relu 1 for the stem + layer1 form, 0 for
// layer2's.  Returns the CUDA error code of the launch (0 on success).
extern "C" int enc_finish_forward(const void* a, const float* sa,
                                  const float* ta, const void* b,
                                  const float* sb, const float* tb,
                                  const void* c, const float* sc,
                                  const float* tc, void* out, long planes,
                                  long hw, int a_relu, int bf16,
                                  void* stream) {
  if (planes < 1 || hw < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return forward(args<__nv_bfloat16>(a, sa, ta, b, sb, tb, c, sc, tc, out,
                                       planes, hw),
                   a_relu, s);
  return forward(
      args<float>(a, sa, ta, b, sb, tb, c, sc, tc, out, planes, hw), a_relu,
      s);
}
