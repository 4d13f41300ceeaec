// bf16 arithmetic shared by the fused encoder's kernels (enc_conv.cu,
// enc_conv_tc.cu, enc_finish.cu, enc_stats.cu): the tensor cores' bf16
// product, and the per-op rounding of the TPU kernels' bf16 prep
// (raftstereo_tpu/ops/pallas_encoder.py `_prep`, pallas_layer2.py
// `_prep_f`).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// d = a * b + 0 (a fresh partial sum) or d += a * b: bf16 operands, fp32
// accumulation (the products exact).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1, bool fresh) {
  if (fresh)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(0.f));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v rounded to bf16, as a float; a bf16's bits as a float.
__device__ __forceinline__ float rbf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float bf_bits(unsigned short u) {
  return __uint_as_float((uint32_t)u << 16);
}

// x*s + t, the fp32 affine cast to bf16, each op rounded to bf16: never
// one fused multiply-add (nvcc contracts a*b + c by default, one rounding
// too few).
__device__ __forceinline__ float prep_bf16(float x, float s, float t) {
  return rbf(__fadd_rn(rbf(__fmul_rn(x, rbf(s))), rbf(t)));
}

// An element as a float, and a float stored as an element (bf16: rounded
// to nearest even).
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 16 bytes of elements, for vector loads and stores.
template <typename T>
union Pack16 {
  uint4 u;
  T v[16 / sizeof(T)];
};

}  // namespace
