// The staged window dots of the on-demand correlation lookup, shared by
// the lookup (alt_corr.cu, row 1) and the lookup with convc1 fused
// (alt_corr_epi.cu, row 18).  Each kernel runs `lookup_tile` per block and
// hands it its own output step, a functor called once the tile's window
// sums are in shared memory.  The design is described in alt_corr.cu's
// note: a block per (image row, tile of kTilePix pixels); per level the
// span of fmap2 columns the tile's windows cover, staged in shared memory
// (kSpanRows rows in level order, a level that does not fit being "wide")
// with the tile's fmap1 rows in 128-byte channel chunks through a
// kStages-deep `cp.async` ring; each thread sums whole window dots in fp32
// FMAs; the wide levels summed after from global memory (`wide_dots`).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

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

// One block's tile: the window sums of its pixels, then `emit`, the
// kernel's own output step, called by every thread once the sums are in
// shared memory as
//   emit(stage, xs, win, row, p0, np)
// with stage the staging ring's shared memory (kStages * kStageBytes
// bytes, free by then), xs[i] pixel i's coordinate, win[(i * L + l) * D +
// d] pixel i's window sum d of level l (0 outside the level), row the
// image row (b * H + y), p0 the tile's first pixel and np its pixel count.
template <int R, typename TIn, typename Emit>
__device__ __forceinline__ void lookup_tile(
    const TIn* __restrict__ f1, const TIn* __restrict__ f2,
    const float* __restrict__ x, int w1, int w2cat, int c, float scale,
    int ntiles, int groups, const Levels& lv, Emit&& emit) {
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
  emit(smem, xs, win, row, p0, np);
}

template <int R>
size_t smem_bytes(int nlev) {
  return (size_t)kStages * kStageBytes +
         (size_t)kTilePix * nlev * (2 * R + 2) * sizeof(float);
}

}  // namespace
