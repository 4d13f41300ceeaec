// Int8 all-pairs correlation volume with its dequant epilogue for Hopper
// (sm_90a), fp32 or bf16 out.
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
// `_int8_volume_xla`.  The bf16 form (the int8 tier's volume, `out_dtype`
// bf16 in JAX) rounds that fp32 value to bf16 once, at the store
// (`.astype(out_ref.dtype)`), round to nearest even.
//
// Design.  The TPU kernel runs the int8 product on its matrix unit, eight
// image rows per grid step.  Here the product runs on the int8 tensor
// cores, `mma.sync.m16n8k32.s32.s8.s8.s32`: q1 (W1, C) is its A operand
// row-major and q2 (W2, C) its B operand column-major, K contiguous in
// both, so `ldmatrix` reads both fragments from shared memory as they lie
// in device memory.  A block owns kMT m16 tiles of one image row's W1 (48
// rows: 240 = 5 blocks of 48, no padded work) against kNChunk columns of
// W2 at a time (two passes of 128 at serving), and brings the two int8
// slabs and the tile's scales in with `cp.async`, kKChunk channels at a
// time in kStages commit groups, so the products of the first channels
// start while the rest arrive; a k-step past C (C = 16 or 48) is
// zero-filled in shared memory, as are rows past W1 or W2.  Each of the 8 warps takes kNTW n8
// tiles of the chunk against all kMT m-tiles.  The epilogue scales the
// accumulators in their fragments, stages the fp32 tile in shared memory
// (over the operand slabs) and writes each output row, a contiguous run
// of the chunk's columns, as 16-byte coalesced stores of 4 fp32 values
// where W2 % 4 == 0, a warp a row, or in bf16 of 8 values rounded from
// the stage where W2 % 8 == 0, dealt over all the block's threads (a
// warp a row left half of each warp idle at 128 columns: 9% slower)
// (scalar coalesced stores for ragged widths), marked evict-first so the
// 33 MB (bf16: 16.6 MB) of output do not push the operands out of L2.  Four blocks fit an
// SM (48 KB of shared memory, 64 registers a thread), so one's epilogue
// overlaps the others' copies and products.  Slower forms (PERF.md,
// forms tried): persistent blocks that keep a row's q2 slab and
// prefetch the next tile (one block an SM runs each tile's copy, product,
// epilogue and store in lockstep), and q2's rows multicast by bulk copies
// across a cluster of a row's blocks (the cluster's barriers and 256-byte
// copies cost more than the L2 reads they save).
//
// Bound on an H100 SXM (3.35 TB/s; 1,979 TOP/s int8 on the tensor
// cores): at the serving shape (144 rows, W1 = W2 = 240, C = 256) the
// call reads q1 and q2 (17.7 MB) and the scales (0.3 MB) and writes the
// fp32 volume (33.2 MB): about 51 MB, 15 us (the bf16 volume, 16.6 MB:
// about 35 MB, 10 us); its 4.2 GOP are 2 us on the tensor cores, so the
// function is bound by bytes, and by the stores most.  The first form ran on the dp4a integer pipes (134 TOP/s,
// about 32 us for the product alone).  What this design leaves: each
// block re-reads its image row's q2 slab from L2 (5 blocks a row at
// serving, ~44 MB of L2 reads in all) and its q1 slab once a pass, and a
// block's copies, products and stores follow each other, overlapped only
// by the SM's other blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMT = 3;          // m16 tiles per block: 48 rows of W1
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kNChunk = 128;    // W2 columns per pass
constexpr int kNTW = kNChunk / 8 / kWarps;  // n8 tiles per warp
constexpr int kKChunk = 256;    // channels (bytes) per pass: 8 k32 steps
constexpr int kStages = 2;      // commit groups a channel chunk
constexpr int kRowBytes = kKChunk + 16;    // conflict-free ldmatrix rows
constexpr int kOutStride = kNChunk + 8;    // staged floats a row (8 mod 32)
constexpr int kARows = kMT * 16;
constexpr int kSlabBytes = (kARows + kNChunk) * kRowBytes;
constexpr int kSmemBytes = kSlabBytes + (kARows + kNChunk) * 4;
static_assert(kARows * kOutStride * 4 <= kSlabBytes, "stage fits the slabs");
static_assert(kStages >= 1 && kStages <= 4, "cp_async_wait takes 0..3");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most `pending` of this thread's commit groups are in
// flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::); break;
  }
}

// Copies 16-byte chunks q0 .. q0+nq-1 of `slab_rows` rows into a slab:
// row r from src + r * c where r < nrows and the chunk lies within kc
// channels, zeros elsewhere.  The thread's (row, chunk) steps by kThreads
// without a division per chunk.
__device__ __forceinline__ void fill_slab(unsigned char* dst, int slab_rows,
                                          const int8_t* src, int nrows,
                                          int c, int kc, int q0, int nq) {
  if (nq <= 0) return;
  const int dr = kThreads / nq, dq = kThreads - dr * nq;
  int row = threadIdx.x / nq, q = threadIdx.x - row * nq;
  while (row < slab_rows) {
    const int qq = q0 + q;
    unsigned char* d = dst + row * kRowBytes + qq * 16;
    if (row < nrows && qq * 16 < kc)
      cp_async16(d, src + (long)row * c + qq * 16);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    row += dr;
    q += dq;
    if (q >= nq) {
      q -= nq;
      ++row;
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16, packed low first (little-endian order).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// OutT: float or __nv_bfloat16, the volume's element.
template <typename OutT>
__global__ void __launch_bounds__(kThreads, 4)
int8_volume_kernel(const int8_t* __restrict__ q1,
                   const int8_t* __restrict__ q2,
                   const float* __restrict__ s1, const float* __restrict__ s2,
                   OutT* __restrict__ out, int w1, int w2, int c, int slabs,
                   float inv) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sa = smem;                        // [kARows][kRowBytes]
  unsigned char* sb = smem + kARows * kRowBytes;   // [kNChunk][kRowBytes]
  float* stage = reinterpret_cast<float*>(smem);   // [kARows][kOutStride]
  float* s1s = reinterpret_cast<float*>(smem + kSlabBytes);  // [kARows]
  float* s2s = s1s + kARows;                                 // [kNChunk]
  const long n = blockIdx.x / slabs;
  const int r0 = (int)(blockIdx.x % slabs) * kARows;
  const int rows = min(kARows, w1 - r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int8_t* ag = q1 + (n * w1 + r0) * (long)c;
  const int8_t* bg = q2 + n * w2 * (long)c;

  for (int n0 = 0; n0 < w2; n0 += kNChunk) {
    const int cols = min(kNChunk, w2 - n0);
    int acc[kMT][kNTW][4];
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int j = 0; j < kNTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] = 0;

    for (int k0 = 0; k0 < c; k0 += kKChunk) {
      const int kc = min(kKChunk, c - k0);
      const int ksteps = (kc + 31) >> 5;
      // The slabs in kStages commit groups of k-steps (the first with the
      // tile's scales); 16-byte chunks past kc are zero-filled.
      for (int st = 0; st < kStages; ++st) {
        const int q0 = 2 * (st * ksteps / kStages);
        const int nq = 2 * ((st + 1) * ksteps / kStages) - q0;
        fill_slab(sa, kARows, ag + k0, rows, c, kc, q0, nq);
        fill_slab(sb, kNChunk, bg + (long)n0 * c + k0, cols, c, kc, q0, nq);
        if (st == 0 && k0 == 0) {
          const int t = threadIdx.x;
          if (t < rows) cp_async4(s1s + t, s1 + n * w1 + r0 + t);
          for (int e = t; e < cols; e += kThreads)
            cp_async4(s2s + e, s2 + n * w2 + n0 + e);
        }
        cp_async_commit();
      }

      for (int st = 0; st < kStages; ++st) {
        cp_async_wait(kStages - 1 - st);
        __syncthreads();
        const int ks1 = (st + 1) * ksteps / kStages;
        for (int ks = st * ksteps / kStages; ks < ks1; ++ks) {
          uint32_t a[kMT][4];
#pragma unroll
          for (int m = 0; m < kMT; ++m)
            ldmatrix_x4(a[m], sa + (m * 16 + (lane & 15)) * kRowBytes +
                                  ks * 32 + (lane >> 4) * 16);
#pragma unroll
          for (int j = 0; j < kNTW; j += 2) {
            const int nt = warp * kNTW + j;   // this pair's first n8 tile
            if (nt * 8 >= cols) break;        // warp-uniform
            uint32_t b[4];  // tile nt: b[0], b[1]; tile nt + 1: b[2], b[3]
            ldmatrix_x4(b, sb + ((nt + (lane >> 4)) * 8 + (lane & 7)) *
                                    kRowBytes +
                                ks * 32 + ((lane >> 3) & 1) * 16);
#pragma unroll
            for (int m = 0; m < kMT; ++m) {
              mma_s8(acc[m][j], a[m], b[0], b[1]);
              mma_s8(acc[m][j + 1], a[m], b[2], b[3]);
            }
          }
        }
      }
      __syncthreads();   // the slabs are refilled or become the stage
    }

    // Epilogue: (float(acc) * (s1 * s2)) * inv into the stage.
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      const int ra = m * 16 + g, rb = ra + 8;   // stage rows
      const float sa0 = s1s[ra], sa1 = s1s[rb];
#pragma unroll
      for (int j = 0; j < kNTW; ++j) {
        const int col = (warp * kNTW + j) * 8 + 2 * tq;
        if (col - 2 * tq >= cols) break;   // warp-uniform
        const float sb0 = s2s[col], sb1 = s2s[col + 1];
        const int* d = acc[m][j];
        *reinterpret_cast<float2*>(stage + ra * kOutStride + col) =
            make_float2(
                __fmul_rn(__fmul_rn(__int2float_rn(d[0]), __fmul_rn(sa0, sb0)),
                          inv),
                __fmul_rn(__fmul_rn(__int2float_rn(d[1]), __fmul_rn(sa0, sb1)),
                          inv));
        *reinterpret_cast<float2*>(stage + rb * kOutStride + col) =
            make_float2(
                __fmul_rn(__fmul_rn(__int2float_rn(d[2]), __fmul_rn(sa1, sb0)),
                          inv),
                __fmul_rn(__fmul_rn(__int2float_rn(d[3]), __fmul_rn(sa1, sb1)),
                          inv));
      }
    }
    __syncthreads();

    // The store stream: each output row's `cols` values are contiguous.
    if constexpr (std::is_same<OutT, float>::value) {
      for (int r = warp; r < rows; r += kWarps) {
        float* o = out + (n * w1 + r0 + r) * (long)w2 + n0;
        const float* st = stage + r * kOutStride;
        if ((cols & 3) == 0 && (((uintptr_t)o) & 15) == 0) {
          for (int q = lane; q < (cols >> 2); q += 32)
            __stcs(reinterpret_cast<float4*>(o) + q,
                   reinterpret_cast<const float4*>(st)[q]);
        } else {
          for (int e = lane; e < cols; e += 32) __stcs(o + e, st[e]);
        }
      }
    } else if ((cols & 7) == 0 && (w2 & 7) == 0 &&
               (((uintptr_t)out) & 15) == 0) {
      // bf16, every row 16-byte aligned: 8 staged values rounded into one
      // 16-byte store, the block's stores dealt over all its threads (a
      // row of 128 columns is only 16 of them)
      const int nq = cols >> 3;
      for (int i = threadIdx.x; i < rows * nq; i += kThreads) {
        const int r = i / nq, q = i - r * nq;
        const float4* st =
            reinterpret_cast<const float4*>(stage + r * kOutStride);
        const float4 a = st[2 * q], b = st[2 * q + 1];
        __stcs(reinterpret_cast<uint4*>(out + (n * w1 + r0 + r) * (long)w2 +
                                        n0) + q,
               make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                          pack_bf16(b.x, b.y), pack_bf16(b.z, b.w)));
      }
    } else {
      for (int r = warp; r < rows; r += kWarps) {
        OutT* o = out + (n * w1 + r0 + r) * (long)w2 + n0;
        const float* st = stage + r * kOutStride;
        for (int e = lane; e < cols; e += 32)
          __stcs(reinterpret_cast<unsigned short*>(o) + e,
                 __bfloat16_as_ushort(__float2bfloat16_rn(st[e])));
      }
    }
    __syncthreads();   // the stage is refilled by the next chunk's slabs
  }
}

template <typename OutT>
int forward(const int8_t* q1, const int8_t* q2, const float* s1,
            const float* s2, OutT* out, long rows, int w1, int w2, int c,
            float inv, void* stream) {
  if (c <= 0 || c % 16 != 0) return (int)cudaErrorInvalidValue;
  if (rows == 0 || w1 == 0 || w2 == 0) return 0;
  const int slabs = (w1 + kARows - 1) / kARows;
  if (rows * slabs > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      int8_volume_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int8_volume_kernel<OutT><<<(unsigned)(rows * slabs), kThreads, kSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      q1, q2, s1, s2, out, w1, w2, c, slabs, inv);
  return (int)cudaGetLastError();
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
  return forward(q1, q2, s1, s2, out, rows, w1, w2, c, inv, stream);
}

// The same with a bf16 out (2-byte aligned): the fp32 epilogue's value
// rounded once.
extern "C" int int8_volume_forward_bf16(const int8_t* q1, const int8_t* q2,
                                        const float* s1, const float* s2,
                                        void* out, long rows, int w1, int w2,
                                        int c, float inv, void* stream) {
  return forward(q1, q2, s1, s2, static_cast<__nv_bfloat16*>(out), rows, w1,
                 w2, c, inv, stream);
}
