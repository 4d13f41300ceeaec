// On-demand all-level correlation lookup for Hopper (sm_90a): fp32 or bf16
// feature maps in, fp32 or bf16 correlation features out.
//
// Replaces the TPU kernel raftstereo_tpu/ops/pallas_alt.py
// `_alt_pyr_radial_kernel` (core `_radial_cols`), launched from
// `_alt_pyr_radial_fwd_impl`.  Function: for every pixel (b, y, x1) and
// level l, with the level-0 coordinate x and x_l = x * 2^-l,
//   win[d] = <fmap1[b,y,x1,:], fmap2_l[b,y,floor(x_l)+d-r,:]> / sqrt(C)
//            for d = 0..2r+1, and 0 where the index is outside [0, w2_l-1]
//   out[b,y,x1,l*K+k] = (1-f)*win[k] + f*win[k+1],  f = x_l - floor(x_l)
// which is the align-corners hat interpolation of the `alt` backend.  A
// NaN coordinate gives f = NaN and poisons the output, as on the TPU.
// Accumulation is fp32 FMAs throughout (no TF32).  bf16 feature maps are
// staged as bf16 and widened to fp32 exactly at the FMA (products of bf16
// values are exact in fp32), as the TPU's matrix unit takes them with
// preferred_element_type=float32; a bf16 output is the fp32 result
// rounded once.
//
// Design.  The TPU kernel computes whole (block x W2cat) correlation rows
// on its matrix unit and masks them.  Here only the K+1 window dot products
// a pixel needs are computed (40 dots of length 256 at the flagship
// shapes), from shared memory.  A block owns one image row and a tile of
// kTilePix consecutive pixels.  Per level, the tile's windows lie in one
// span of columns, [min floor(x_l) - r, max floor(x_l) + r + 1] clipped to
// the level (NaN pixels and pixels whose window misses the level left
// out); the levels' spans are allotted rows of a staging buffer of
// kSpanRows rows in level order, and a level whose span does not fit is
// "wide".  The tile's fmap1 rows and the staged spans' fmap2 rows go to
// shared memory in 128-byte channel chunks (32 fp32 or 64 bf16 channels)
// through a kStages-deep `cp.async` ring, so each fmap2 row is read from
// L2 once per tile, not once per pixel whose window covers it.  Each thread
// owns whole dot products: one pixel and a group of its window's columns
// (one level), fmap1's 16-byte slot in registers, reused across those
// columns.  Within a chunk, lane i reads slot (s + i) mod 8 at step s of
// both its fmap1 row and its columns' rows: the 8 lanes of a quarter-warp
// read 8 different slots, so the rows they read, whichever they are, hit
// different banks (a row is 128 bytes, all 32 banks).  No shuffles: a
// thread sums its own dots in fp32 FMAs over the chunks.  A wide level (a
// disparity jump inside the tile) is summed after the staged ones, inside
// this kernel, from global memory (`wide_dots`): a warp per pixel, lanes
// across the channels, the window's rows loaded together and reduced by
// shuffles, as many rows in flight as a staged pass keeps (one thread per
// dot reading 16-byte slots from global memory made a tile with a jump
// several times slower than a staged one, and the kernel's tail with it:
// PERF.md section 6).  The window sums go to shared memory; then the tile's
// contiguous output is written by consecutive threads, lerp and scale as
// before.  The staging (`TileSpans`, `issue_chunk`) does not depend on what
// consumes the rows, so the lookup with convc1 fused (alt_corr_epi.cu) can
// take it over.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): at 144x240, C=256, 4 levels of radius 4 the call must read fmap1
// (35 MB) and the fmap2 pyramid (up to 66 MB) once and does about 0.7
// GFLOP, so it is bound by bytes, about 30 us.  In bf16 (the bf16 serving
// path: fmap1 17.7 MB, the pyramid 33.2 MB, a bf16 output 2.5 MB) about 53
// MB, about 16 us.  What holds this design back from that: every FMA reads
// one 4-byte fmap2 operand from shared memory (the dots share no operand
// in registers across pixels), so shared memory's 128 bytes a cycle per SM
// cap it near 50 us at the flagship shapes; few blocks per SM (3, by
// shared memory) to hide each chunk's copy and barrier; a tile whose
// disparities spread re-reads, from L2, the fmap2 rows that its
// neighbouring tiles stage too (~3x the pyramid on the smoke's random
// [-60, 0] field, ~1.5x on a smooth one); and a block's setup (spans, the
// ring's first chunk) before its first FMA.  The whole tile x span product
// on the tensor cores (3xTF32 mma.sync in fp32, bf16 m16n8k16), windows
// picked after, was slower in fp32 and no faster in bf16 than this form at
// 3 blocks per SM (PERF.md section 6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
constexpr int kTilePix = 32;      // pixels of one image row per block
constexpr int kSpanRows = 224;    // fmap2 rows a stage holds
constexpr int kStages = 2;        // depth of the cp.async ring
constexpr int kRowBytes = 128;    // one row's chunk: 8 slots of 16 bytes
constexpr int kStageRows = kTilePix + kSpanRows;
constexpr int kStageBytes = kStageRows * kRowBytes;

struct Levels {
  int n;
  int off[kMaxLevels];    // first column of level l in the concatenated W2
  int width[kMaxLevels];  // real width w2_l of level l
};

// 16 bytes of a feature map, widened to fp32: 4 fp32 or 8 bf16 values.
template <typename T>
struct Vec;

// kUnroll: the steps of a chunk unrolled together in the dot loop, the
// faster count at the flagship shapes (PERF.md section 6).
template <>
struct Vec<float> {
  static constexpr int V = 4;
  static constexpr int kUnroll = 8;
  __device__ __forceinline__ static void widen(const uint4& r, float* out) {
    out[0] = __uint_as_float(r.x);
    out[1] = __uint_as_float(r.y);
    out[2] = __uint_as_float(r.z);
    out[3] = __uint_as_float(r.w);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int V = 8;
  static constexpr int kUnroll = 4;
  __device__ __forceinline__ static void widen(const uint4& r, float* out) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its fp32
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The staging plan of one tile: per level the span's first column, last
// column and first stage row (kWide: not staged; kEmpty: no window of the
// tile meets the level), and each staged row's column in f2cat.
constexpr int kWide = -1;
constexpr int kEmpty = -2;

struct TileSpans {
  int lo[kMaxLevels], hi[kMaxLevels], row0[kMaxLevels];
  int nrows;
  unsigned used;  // bit i: pixel i's window meets some level
  int col[kSpanRows];
};

// Plans the spans of the tile's pixels xs[0..np) (all threads call it).
// Uses bmin/bmax as scratch.
template <int R>
__device__ void plan_spans(TileSpans& sp, int (&bmin)[kMaxLevels],
                           int (&bmax)[kMaxLevels], const float* xs, int np,
                           const Levels& lv) {
  const int L = lv.n;
  if (threadIdx.x < kMaxLevels) {
    bmin[threadIdx.x] = INT_MAX;
    bmax[threadIdx.x] = INT_MIN;
  }
  if (threadIdx.x == 0) sp.used = 0;
  __syncthreads();
  for (int t = threadIdx.x; t < kTilePix * L; t += kThreads) {
    const int i = t % kTilePix, l = t / kTilePix;
    if (i >= np) continue;
    const float b0 = floorf(xs[i] * (1.0f / (float)(1 << l)));
    // false for NaN and +-inf: such a pixel's window misses every level
    if (b0 - (float)R <= (float)(lv.width[l] - 1) &&
        b0 + (float)(R + 1) >= 0.f) {
      atomicMin(&bmin[l], (int)b0);
      atomicMax(&bmax[l], (int)b0);
      atomicOr(&sp.used, 1u << i);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int used = 0;
    for (int l = 0; l < L; ++l) {
      const int lo = max(bmin[l] - R, 0);
      const int hi = min(bmax[l] + R + 1, lv.width[l] - 1);
      sp.lo[l] = lo;
      sp.hi[l] = hi;
      if (bmin[l] > bmax[l] || lo > hi) {
        sp.row0[l] = kEmpty;
      } else if (used + (hi - lo + 1) <= kSpanRows) {
        sp.row0[l] = used;
        used += hi - lo + 1;
      } else {
        sp.row0[l] = kWide;
      }
    }
    sp.nrows = used;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < sp.nrows; r += kThreads) {
    int l = 0;
    while (sp.row0[l] < 0 || r >= sp.row0[l] + sp.hi[l] - sp.lo[l] + 1) ++l;
    sp.col[r] = lv.off[l] + sp.lo[l] + (r - sp.row0[l]);
  }
  __syncthreads();
}

// Copies chunk `chunk` (128 bytes of each row) of the tile's fmap1 rows
// and of the staged fmap2 rows into `stage`, with 16-byte cp.async.
// f1row / f2row: the tile's first fmap1 row and the image row's first
// f2cat column, as bytes; rowb: bytes of one column (C * element size).
__device__ __forceinline__ void issue_chunk(char* stage, const TileSpans& sp,
                                            const char* f1row,
                                            const char* f2row, long rowb,
                                            int np, int chunk) {
  const int units = (kTilePix + sp.nrows) * 8;
  for (int u = threadIdx.x; u < units; u += kThreads) {
    const int r = u >> 3, q = u & 7;
    const char* src;
    if (r < kTilePix) {
      if (!((sp.used >> r) & 1)) continue;  // no window to sum, or past
      src = f1row + r * rowb;               // the image row's end
    } else {
      src = f2row + sp.col[r - kTilePix] * rowb;
    }
    cp_async16(stage + r * kRowBytes + q * 16,
               src + chunk * kRowBytes + q * 16);
  }
}

// The window sums of the tile's wide levels (spans that the staging
// buffer cannot hold), from global memory: a warp per pixel, its lanes
// across the channels (16 bytes each, so each row is read coalesced), the
// window's in-level columns kWideCols at a time, each column's lane sums
// then reduced by xor shuffles.  Every warp of the block keeps kWideCols
// whole rows in flight, where one thread per dot kept a few 16-byte
// slots, so a tile with a disparity jump costs about one staged pass, not
// a long chain of dependent loads.  5 columns kept the staged loop's
// registers (10 raised the fp32 kernel to 2 blocks an SM).
constexpr int kWideCols = 5;
template <int R, typename TIn>
__device__ __forceinline__ void wide_dots(float* win, const TileSpans& sp,
                                          const float* xs, int np,
                                          const char* f1row,
                                          const char* f2row, long rowb,
                                          float scale, const Levels& lv) {
  constexpr int D = 2 * R + 2;
  constexpr int B = D < kWideCols ? D : kWideCols;
  constexpr int V = Vec<TIn>::V;
  const int L = lv.n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int l = 0; l < L; ++l) {
    if (sp.row0[l] != kWide) continue;  // block-uniform
    const int width = lv.width[l];
    for (int i = warp; i < np; i += kThreads / 32) {
      const float b0 = floorf(xs[i] * (1.0f / (float)(1 << l)));
      unsigned in = 0;  // bit d: column b0 - R + d lies in the level
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float jf = b0 + (float)(d - R);
        if (jf >= 0.f && jf <= (float)(width - 1)) in |= 1u << d;  // NaN: 0
      }
      // f2cat column of window column 0; only in-level columns are read
      const long c0 = in ? (long)lv.off[l] + (long)b0 - R : 0;
      float* w = win + (i * L + l) * D;
#pragma unroll 1
      for (int d0 = 0; d0 < D; d0 += B) {
        const unsigned m = (in >> d0) & ((1u << B) - 1);
        float acc[B];
#pragma unroll
        for (int u = 0; u < B; ++u) acc[u] = 0.f;
        if (m) {  // warp-uniform
          for (long q = lane * 16; q < rowb; q += 32 * 16) {
            float av[V], bv[V];
            Vec<TIn>::widen(
                __ldg(reinterpret_cast<const uint4*>(f1row + i * rowb + q)),
                av);
            uint4 raw[B];
#pragma unroll
            for (int u = 0; u < B; ++u)
              if ((m >> u) & 1)
                raw[u] = __ldg(reinterpret_cast<const uint4*>(
                    f2row + (c0 + d0 + u) * rowb + q));
#pragma unroll
            for (int u = 0; u < B; ++u) {
              if ((m >> u) & 1) {
                Vec<TIn>::widen(raw[u], bv);
#pragma unroll
                for (int v = 0; v < V; ++v)
                  acc[u] = fmaf(av[v], bv[v], acc[u]);
              }
            }
          }
#pragma unroll
          for (int u = 0; u < B; ++u)
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
              acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], o);
        }
        if (lane == 0) {
#pragma unroll
          for (int u = 0; u < B; ++u)
            if (d0 + u < D) w[d0 + u] = (m >> u) & 1 ? acc[u] * scale : 0.f;
        }
      }
    }
  }
}

// One block's tile: the body of both kernels below.
template <int R, typename TIn, typename TOut>
__device__ __forceinline__ void lookup_tile(
    const TIn* __restrict__ f1, const TIn* __restrict__ f2,
    const float* __restrict__ x, TOut* __restrict__ out, int w1, int w2cat,
    int c, float scale, int ntiles, int groups, const Levels& lv) {
  constexpr int K = 2 * R + 1;
  constexpr int D = K + 1;  // window columns per level
  constexpr int V = Vec<TIn>::V;
  extern __shared__ __align__(16) char smem[];
  __shared__ TileSpans sp;
  __shared__ int bmin[kMaxLevels], bmax[kMaxLevels];
  __shared__ float xs[kTilePix];
  const int L = lv.n;
  float* win = reinterpret_cast<float*>(smem + kStages * kStageBytes);
  // win[(i * L + l) * D + d]: pixel i's window sum d of level l

  const long row = blockIdx.x / ntiles;
  const int p0 = (blockIdx.x % ntiles) * kTilePix;
  const int np = min(kTilePix, w1 - p0);
  for (int i = threadIdx.x; i < np; i += kThreads)
    xs[i] = x[row * w1 + p0 + i];
  __syncthreads();
  plan_spans<R>(sp, bmin, bmax, xs, np, lv);

  const long rowb = (long)c * sizeof(TIn);
  const char* f1row =
      reinterpret_cast<const char*>(f1) + (row * w1 + p0) * rowb;
  const char* f2row = reinterpret_cast<const char*>(f2) + row * w2cat * rowb;
  // A tile with no staged level stages nothing: none of its windows meets
  // a level (a diverged disparity field; its sums are 0), or every level
  // they meet is wide.
  const int nchunk = sp.nrows ? (int)(rowb / kRowBytes) : 0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunk)
      issue_chunk(smem + s * kStageBytes, sp, f1row, f2row, rowb, np, s);
    cp_async_commit();
  }

  // This thread's unit: pixel i, level l, window columns [d0, d0 + G).
  const int G = (D + groups - 1) / groups;
  const int u = threadIdx.x;
  const int i = u % kTilePix;
  const int grp = (u / kTilePix) % groups;
  const int l = u / (kTilePix * groups);
  const int d0 = grp * G;
  // warp-uniform: a warp's 32 lanes are 32 pixels of one (level, group)
  const bool unit = l < L && d0 < D;
  int mode = kEmpty;
  float b0 = 0.f;
  bool hits = false;  // the pixel's window meets the level
  int idx[D];         // per column: byte offset of its staged row
  if (unit) {
    mode = sp.row0[l] >= 0 ? 0 : sp.row0[l];
    const float xl = i < np ? xs[i] * (1.0f / (float)(1 << l)) : NAN;
    b0 = floorf(xl);
    hits = b0 - (float)R <= (float)(lv.width[l] - 1) &&
           b0 + (float)(R + 1) >= 0.f;
    const int b = hits ? (int)b0 - R : sp.lo[l];
#pragma unroll
    for (int g = 0; g < D; ++g) {
      if (g < G) {  // clamped into the span: a column the tile staged
        const int col = min(max(b + d0 + g, sp.lo[l]), sp.hi[l]);
        idx[g] = (kTilePix + sp.row0[l] + col - sp.lo[l]) * kRowBytes;
      }
    }
  }
  // A pixel whose window misses the level computes nothing (its window
  // sums are 0): a diverged disparity field skips most of the work.  The
  // units of a wide level leave their sums to `wide_dots`.
  const bool active = unit && mode == 0 && hits;

  float acc[D];
#pragma unroll
  for (int g = 0; g < D; ++g) acc[g] = 0.f;
  const int lane = threadIdx.x & 31;
  for (int ch = 0; ch < nchunk; ++ch) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = ch + kStages - 1;
    if (next < nchunk)
      issue_chunk(smem + (next % kStages) * kStageBytes, sp, f1row, f2row,
                  rowb, np, next);
    cp_async_commit();
    if (!active) continue;
    const char* stage = smem + (ch % kStages) * kStageBytes;
    const char* arow = stage + i * kRowBytes;
#pragma unroll (Vec<TIn>::kUnroll)
    for (int s = 0; s < 8; ++s) {
      const int q = ((s + lane) & 7) * 16;
      float av[V], bv[V];
      Vec<TIn>::widen(*reinterpret_cast<const uint4*>(arow + q), av);
#pragma unroll
      for (int g = 0; g < D; ++g) {
        if (g < G) {
          Vec<TIn>::widen(
              *reinterpret_cast<const uint4*>(stage + idx[g] + q), bv);
#pragma unroll
          for (int v = 0; v < V; ++v) acc[g] = fmaf(av[v], bv[v], acc[g]);
        }
      }
    }
  }

  if (unit && i < np && mode != kWide) {
    const int width = lv.width[l];
    float* w = win + (i * L + l) * D;
#pragma unroll
    for (int g = 0; g < D; ++g) {
      const int d = d0 + g;
      if (g < G && d < D) {
        const float jf = b0 + (float)(d - R);
        // false for NaN and for columns outside the level
        const bool in =
            mode != kEmpty && jf >= 0.f && jf <= (float)(width - 1);
        w[d] = in ? acc[g] * scale : 0.f;
      }
    }
  }
  wide_dots<R, TIn>(win, sp, xs, np, f1row, f2row, rowb, scale, lv);
  __syncthreads();

  // The tile's output, contiguous: consecutive threads, consecutive values.
  const int lk = L * K;
  TOut* o = out + (row * w1 + p0) * (long)lk;
  for (int e = threadIdx.x; e < np * lk; e += kThreads) {
    const int p = e / lk, r = e - p * lk;
    const int lv_ = r / K, k = r - lv_ * K;
    const float xl = xs[p] * (1.0f / (float)(1 << lv_));
    const float fr = xl - floorf(xl);
    const float* w = win + (p * L + lv_) * D;
    put(o + e, w[k] * (1.f - fr) + w[k + 1] * fr);
  }
}

// fp32 feature maps: no minimum of blocks an SM; ptxas keeps ~72
// registers at radius 4, so shared memory sets 3 blocks an SM.  A form
// that took 108 or 128 registers (2 blocks an SM) ran ~30% slower
// (PERF.md section 6).
template <int R, typename TOut>
__global__ void __launch_bounds__(kThreads)
alt_corr_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                const float* __restrict__ x, TOut* __restrict__ out, int w1,
                int w2cat, int c, float scale, int ntiles, int groups,
                Levels lv) {
  lookup_tile<R>(f1, f2, x, out, w1, w2cat, c, scale, ntiles, groups, lv);
}

// bf16 feature maps: at most 85 registers, so 3 blocks share an SM
// whatever ptxas would take unbounded.
template <int R, typename TOut>
__global__ void __launch_bounds__(kThreads, 3)
alt_corr_bf16_kernel(const __nv_bfloat16* __restrict__ f1,
                     const __nv_bfloat16* __restrict__ f2,
                     const float* __restrict__ x, TOut* __restrict__ out,
                     int w1, int w2cat, int c, float scale, int ntiles,
                     int groups, Levels lv) {
  lookup_tile<R>(f1, f2, x, out, w1, w2cat, c, scale, ntiles, groups, lv);
}

template <int R>
size_t smem_bytes(int nlev) {
  return (size_t)kStages * kStageBytes +
         (size_t)kTilePix * nlev * (2 * R + 2) * sizeof(float);
}

template <int R, typename TIn, typename TOut>
int launch(const void* f1, const void* f2, const float* x, void* out,
           long npix, int w1, int w2cat, int c, float scale,
           const Levels& lv, cudaStream_t stream) {
  void (*kernel)(const TIn*, const TIn*, const float*, TOut*, int, int, int,
                 float, int, int, Levels);
  if constexpr (std::is_same<TIn, float>::value)
    kernel = alt_corr_kernel<R, TOut>;
  else
    kernel = alt_corr_bf16_kernel<R, TOut>;
  const size_t smem = smem_bytes<R>(lv.n);
  static bool opted = false;  // one attribute call per instance
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<R>(kMaxLevels));
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  // Column groups per window: as many units (pixel, level, group) as fit
  // the block's threads, at most one column each.
  const int groups = max(1, min(2 * R + 2, kThreads / (kTilePix * lv.n)));
  const int ntiles = (w1 + kTilePix - 1) / kTilePix;
  const long blocks = npix / w1 * ntiles;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const TIn*>(f1), static_cast<const TIn*>(f2), x,
      static_cast<TOut*>(out), w1, w2cat, c, scale, ntiles, groups, lv);
  return (int)cudaGetLastError();
}

template <typename TIn, typename TOut>
int dispatch(int radius, const void* f1, const void* f2, const float* x,
             void* out, long npix, int w1, int w2cat, int c, float scale,
             const Levels& lv, cudaStream_t s) {
  switch (radius) {
#define ALT_CORR_CASE(r)                                                   \
  case r:                                                                  \
    return launch<r, TIn, TOut>(f1, f2, x, out, npix, w1, w2cat, c, scale, \
                                lv, s);
    ALT_CORR_CASE(1) ALT_CORR_CASE(2) ALT_CORR_CASE(3) ALT_CORR_CASE(4)
    ALT_CORR_CASE(5) ALT_CORR_CASE(6) ALT_CORR_CASE(7) ALT_CORR_CASE(8)
#undef ALT_CORR_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// fmap1 (B*H, W1, C), f2cat (B*H, W2cat, C), fp32 (in_bf16 = 0) or bf16
// (in_bf16 = 1); x (B*H, W1) fp32; out (B*H, W1, nlev*(2*radius+1)), fp32
// (out_bf16 = 0) or bf16; all contiguous, the feature maps 16-byte
// aligned.  C must be a multiple of 128 (fp32) or 256 (bf16) and at most
// 512; radius 1..8; nlev <= 8; npix a multiple of W1.  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int alt_corr_forward(const void* f1, const void* f2,
                                const float* x, void* out, long npix,
                                int w1, int w2cat, int c, int radius,
                                float scale, int nlev, const int* offsets,
                                const int* widths, int in_bf16, int out_bf16,
                                void* stream) {
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
  using bf16 = __nv_bfloat16;
  if (in_bf16 && out_bf16)
    return dispatch<bf16, bf16>(radius, f1, f2, x, out, npix, w1, w2cat, c,
                                scale, lv, s);
  if (in_bf16)
    return dispatch<bf16, float>(radius, f1, f2, x, out, npix, w1, w2cat, c,
                                 scale, lv, s);
  if (out_bf16)
    return dispatch<float, bf16>(radius, f1, f2, x, out, npix, w1, w2cat, c,
                                 scale, lv, s);
  return dispatch<float, float>(radius, f1, f2, x, out, npix, w1, w2cat, c,
                                scale, lv, s);
}
