// Int8 all-pairs correlation volume with its dequant epilogue for Hopper
// (sm_90a).
//
// Replaces the TPU kernel raftstereo_tpu/ops/quant.py
// `_int8_volume_kernel`, launched from `pallas_int8_corr_volume` (the
// `corr_quant` volume).  Function: for every image row n (of B*H) and
// pixel pair (i, j),
//   acc[n, i, j] = sum_c q1[n, i, c] * q2[n, j, c]       (int8 -> int32)
//   out[n, i, j] = (float(acc) * (s1[n, i] * s2[n, j])) * inv
// with inv = 1 / sqrt(C) computed in fp32 by the caller.  The integer sum
// is exact, so its order does not matter; the epilogue rounds each of its
// three products once (__fmul_rn, association as in JAX), so the kernel
// is bitwise equal to the plain version and to the JAX package's
// `_int8_volume_xla`.
//
// Design.  The TPU kernel runs the int8 product on its matrix unit, eight
// image rows per grid step.  This first form uses the integer pipes, not
// the tensor cores: one block computes a 64x64 tile of one image row's
// W1 x W2 product; the two 64-pixel slabs of q1 and q2 go through shared
// memory 256 channels at a time as packed int32 words (16-byte loads),
// and each of the 256 threads accumulates a 4x4 sub-tile with __dp4a
// (four int8 products and their sum per instruction).
//
// Bound on an H100 SXM (3.35 TB/s; 1,979 TOP/s int8 on the tensor
// cores): at the serving shape (144 rows, W1 = W2 = 240, C = 256) the
// call reads q1 and q2 (17.7 MB) and the scales (0.3 MB) and writes the
// fp32 volume (33.2 MB): about 51 MB, 15 us; its 4.2 GOP are 2 us on the
// tensor cores, so the function is bound by bytes.  This form was
// designed against the dp4a rate instead: 64 lanes per SM (the int32
// rate) x 132 SMs x 1.98 GHz, 16.7 T dp4a/s = 134 TOP/s, about 32 us for
// the call, so the kernel itself is bound by its operations, about twice
// the bytes bound.  Tensor cores (mma.sync s8 or wgmma) are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;     // outputs per block side
constexpr int kWords = 64;    // int32 words (256 channels) per stage
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
int8_volume_kernel(const int8_t* __restrict__ q1,
                   const int8_t* __restrict__ q2,
                   const float* __restrict__ s1, const float* __restrict__ s2,
                   float* __restrict__ out, int w1, int w2, int cw, int tiles2,
                   float inv) {
  __shared__ int a[kTile][kWords + 1];
  __shared__ int b[kTile][kWords + 1];
  const long n = blockIdx.x;
  const int r0 = (blockIdx.y / tiles2) * kTile;
  const int c0 = (blockIdx.y % tiles2) * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int* p1 = reinterpret_cast<const int*>(q1) + n * (long)w1 * cw;
  const int* p2 = reinterpret_cast<const int*>(q2) + n * (long)w2 * cw;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < cw; k0 += kWords) {
    for (int v = threadIdx.x; v < kTile * (kWords / 4); v += kThreads) {
      const int row = v / (kWords / 4);
      const int q = (v % (kWords / 4)) * 4;
      const int kw = k0 + q;  // cw % 4 == 0: a 4-word group is all in or out
      int4 va = make_int4(0, 0, 0, 0), vb = make_int4(0, 0, 0, 0);
      if (kw < cw) {
        if (r0 + row < w1)
          va = *reinterpret_cast<const int4*>(p1 + (long)(r0 + row) * cw + kw);
        if (c0 + row < w2)
          vb = *reinterpret_cast<const int4*>(p2 + (long)(c0 + row) * cw + kw);
      }
      a[row][q] = va.x; a[row][q + 1] = va.y;
      a[row][q + 2] = va.z; a[row][q + 3] = va.w;
      b[row][q] = vb.x; b[row][q + 1] = vb.y;
      b[row][q + 2] = vb.z; b[row][q + 3] = vb.w;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kWords; ++k) {
      int av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b[tx + 16 * j][k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= w1) continue;
    const float sa = s1[n * w1 + r];
    float* o = out + (n * w1 + r) * (long)w2;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col >= w2) continue;
      const float scale = __fmul_rn(sa, s2[n * w2 + col]);
      o[col] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), scale), inv);
    }
  }
}

}  // namespace

// q1 (rows, w1, c) and q2 (rows, w2, c) int8, s1 (rows, w1) and s2
// (rows, w2) fp32, all contiguous, q1 and q2 16-byte aligned; writes out
// (rows, w1, w2) fp32.  c must be a multiple of 16.  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int int8_volume_forward(const int8_t* q1, const int8_t* q2,
                                   const float* s1, const float* s2,
                                   float* out, long rows, int w1, int w2,
                                   int c, float inv, void* stream) {
  if (c <= 0 || c % 16 != 0 || rows > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || w1 == 0 || w2 == 0) return 0;
  const int tiles1 = (w1 + kTile - 1) / kTile;
  const int tiles2 = (w2 + kTile - 1) / kTile;
  if ((long)tiles1 * tiles2 > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)rows, (unsigned)(tiles1 * tiles2));
  int8_volume_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q1, q2, s1, s2, out, w1, w2, c / 4, tiles2, inv);
  return (int)cudaGetLastError();
}
