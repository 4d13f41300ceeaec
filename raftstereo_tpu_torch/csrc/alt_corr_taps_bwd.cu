// Backward of the all-level correlation lookup at caller-given taps, for
// Hopper (sm_90a), fp32 and bf16 feature maps.
//
// Replaces the TPU kernel raftstereo_tpu/ops/pallas_alt.py
// `_alt_pyr_bwd_kernel` as `_make_alt_pyr.bwd` launches it (through
// `_alt_pyr_bwd_impl`) with arbitrary taps: the VJP of alt_corr_taps.cu.
// (alt_corr_bwd.cu is the same TPU kernel's radial form; its taps follow
// from one coordinate per level, so it keeps its own tables and shares
// no code with this one.)  For an image
// row n, pixel i and tap q of level l with local coordinate t, cotangent
// g and j0 = floor(t), f = t - j0, the hat puts weight 1 - f on column j0
// and f on j0 + 1 of level l, so with s = C^-1/2
//   dm_l[n,i,j] = s * sum_{q of level l} g[n,i,q] * hat_q(j)
//   df1[n,i,:]   = sum_{l, j in [0, w_l)} dm_l[n,i,j] * f2_l[n, j, :]
//   df2_l[n,j,:] = sum_i dm_l[n,i,j] * f1[n, i, :]
// Columns [0, w_l) of each given width receive mass; mass outside is
// dropped.  Non-finite inputs follow the TPU's dense hat: a NaN tap or a
// NaN cotangent of level l makes the pixel's hat row NaN (max(0, NaN) is
// NaN), which poisons its df1 and every column of level l in its row; an
// infinite cotangent gives +-inf on the columns its tap weights and NaN
// (inf * 0) on every other column of the level, so its pixel's df1 is
// NaN unless the tap weights every column.  The taps get no gradient (the
// JAX VJP returns zeros for them).
//
// Design.  The TPU kernel builds a dense (block x W2cat) hat matrix in VMEM
// and runs two matrix-unit products per block, accumulating df2 across the
// sequential grid.  Here two kernels run: one that turns each image row's
// taps into sparse lists, once per row, and one that sums the fmap rows
// the lists name, per row and channel slice.
// - The lists (`alt_corr_taps_bwd_lists_kernel`, a block per image row):
//   the row's taps are read into shared memory as tables (each tap's
//   first column and its two unscaled coefficients g * (1 - f) and
//   g * f).  df1's list has the forward's gather pattern: one thread per
//   pixel walks its taps, levels ascending and taps ascending, summing the
//   coefficients of consecutive equal columns into runs, and writes the
//   runs.  df2's list is column-major: per column the (pixel,
//   coefficient) entries of the pixels whose taps weight it, pixels
//   ascending, each coefficient the sum in tap order of the pixel's taps
//   on that column.  A stable counting sort by column builds it: counts
//   and a scan give each column's start; a bitmask per column of the
//   pixels that hit it gives an entry's rank (a popcount), and the
//   pixel's first tap on the column writes it.  A row whose tables
//   outgrow shared memory is walked in tiles of pixels, and a pyramid too
//   wide for the masks in chunks of columns.  The lists go to a workspace
//   in global memory (they stay in L2 for the next kernel): per row 16
//   bytes a tap for df1's runs and 8 bytes an entry for df2's (at most
//   one per pixel and run), so up to 32 bytes a tap.  A call whose rows
//   need more than kWorkBytes runs in batches of rows that fit (at least
//   one row a batch), each batch's two kernels reusing the workspace in
//   stream order.  The flags that the dense hat's non-finite values need
//   go with them: per pixel, whether its df1 is NaN; per row, the levels
//   a NaN poisons and, per level, the columns that every infinite
//   cotangent's tap weights (the rest NaN).
// - The sums (`alt_corr_taps_bwd_grads_kernel`): a block of 32 warps per
//   image row and slice of 128 channels (a lane holds 4, one float4), so
//   a call runs rows x C/128 blocks, and the slice's fmap rows come
//   through L1 (the block uses no shared memory, so L1 keeps 256 KB; at
//   the recipe's row the fmap2 slice is 172 KB and the fmap1 slice 92
//   KB).  df1: one warp per pixel reads its runs 32 at a time and sums
//   their fmap2 rows, kBatch rows in flight.  df2: one warp per column
//   reads its entries and sums their fmap1 rows the same way.
// Every sum runs in the first form of this kernel's fixed order (df1:
// levels ascending, then taps ascending, consecutive equal columns merged
// before their row is read; df2: pixels ascending, each pixel's
// coefficient summed over its taps in order; one fmaf per term from 0),
// with no floating-point atomics, so two calls on the same inputs give
// equal bits, and equal to that form's.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): at 480 rows of 180 pixels, level widths 180/90/45/22, C=256 and
// 36 taps, the call must read fmap1 (88 MB), the fmap2 pyramid (166 MB),
// the taps and g (25 MB) and write df1 and df2 (254 MB): about 533 MB,
// 0.16 ms.  The useful work is at most 2 * 2 * 36 * 256 FLOPs per pixel
// for each gradient (3.2 GFLOP, 0.05 ms), so it is bound by bytes.  What
// holds this design back from that: about 56 fmap rows a pixel for each
// gradient, re-read from L1 (and from L2 where L1 misses), the lists'
// round trip through L2 (about 80 MB written, then read once per slice),
// the lists kernel's serial walks (0.26 ms of 1.02 at the recipe's op
// shape, PERF.md section 6), and the
// per-run and per-entry work (a shuffle, an address, a load) spread over
// only 4 channels a lane.
//
// The bf16 form (`alt_corr_taps_backward_bf16`: bf16 fmaps, fp32 taps and
// cotangent, bf16 df1 and df2) is the TPU kernel with bf16 feature maps:
// each pixel's dense `dm` entry (the sum in tap order of its taps' terms
// on a column, scaled) is rounded to bf16 once, before both products;
// each product of two bf16 values is exact in fp32 and summed in fp32,
// and df1 and df2 are rounded to bf16 once at the end.  With arbitrary
// taps one pixel can weight one column with several taps that are not
// consecutive, so rounding per run (or per tap) would round partial sums.
// So in this form df1's runs are one per (pixel, column), as df2's
// entries already are: a pixel's first tap on a column writes the sum in
// tap order of all its taps on it (the lists kernel's `kMerge`).  The
// sums round the scaled coefficient to bf16 and read 8 bf16 channels a
// lane, a 256-channel slice a block.  At the recipe's op shape the call
// must move about 266 MB: 0.080 ms at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarps = 32;
constexpr int kThreads = 32 * kWarps;  // the sums' block
constexpr int kListThreads = 512;      // the lists' block
constexpr int kBatch = 3;              // fmap rows in flight per warp
constexpr int kFar = 0x40000000;       // first column of a tap that hits none
constexpr int kNan = kFar + 1;         // ... of a NaN tap or cotangent
constexpr int kMaxSmem = 232448;       // bytes a block may opt in to
constexpr int kFlags = 1 + 2 * kMaxLevels;  // per row: poison, keep_lo, hi
constexpr unsigned kPoisoned = 0x80000000u;  // a pixel's run count: df1 NaN
constexpr long kWorkBytes = 256L << 20;  // a batch's workspace (a row fits)

struct Levels {
  int n;
  int off[kMaxLevels];    // first column of level l in the concatenated W2
  int width[kMaxLevels];  // width w_l of level l
};

// A list entry: a pyramid column (df1's runs) or a pixel (df2's entries),
// and its unscaled coefficient's bits.
struct Entry {
  int at;
  int coef;
};

// The workspace, per row: run counts [W1], runs [W1][R], column starts
// [W2cat + 1], column cursors [W2cat], entries [H], flags [kFlags].
struct Work {
  Entry* runs;
  Entry* hits;
  unsigned* nrun;
  int* start;
  int* cursor;
  int* flags;
  long r, h;  // runs per pixel (2 L K), entries per row (W1 min(2 L K, W2cat))
};

template <typename T>
struct Args {
  const T* f1;        // (rows, W1, C)
  const T* f2;        // (rows, W2cat, C)
  const float* taps;  // (rows, W1, L*K)
  const float* g;     // (rows, W1, L*K)
  T* df1;
  T* df2;
  int w1, w2cat, c, kk, nslice;
  int tile, chunk;  // the lists' pixels per tile and columns per chunk
  float scale;
  Levels lv;
  Work wk;
};

// One tap: its first column (kFar: it weights none; kNan: NaN tap or g)
// and the unscaled coefficients g * (1 - f) on column b and g * f on
// b + 1.  Two products and a difference, each rounded.
struct Tap {
  int b;
  float a0, a1;
};

__device__ __forceinline__ Tap read_tap(float tv, float gv, int w) {
  Tap p{kFar, 0.f, 0.f};
  if (isnan(tv) || isnan(gv)) {
    p.b = kNan;
  } else if (tv > -1.f && tv < (float)w) {
    const float b0 = floorf(tv);
    const float f = tv - b0;
    p.b = (int)b0;  // in [-1, w - 1]
    p.a0 = __fmul_rn(gv, __fsub_rn(1.f, f));  // 1 - f > 0: inf iff g is
    p.a1 = __fmul_rn(gv, f);
  } else {
    p.a0 = gv;  // weights no column; isinf(a0) still marks an infinite g
  }
  return p;
}

// A pixel's coefficient on column j: cf, its first tap k's term there,
// plus the terms of its later taps of the level (from t0) on j, in tap
// order, each sum rounded.
__device__ __forceinline__ float column_sum(const int* tb, const float* ta0,
                                            const float* ta1, int t0, int k,
                                            int kk, int j, float cf) {
  for (int e = k + 1; e < kk; ++e) {
    const int o = tb[t0 + e];
    if (o == j) cf = __fadd_rn(cf, ta0[t0 + e]);
    else if (o < kFar && o + 1 == j) cf = __fadd_rn(cf, ta1[t0 + e]);
  }
  return cf;
}

long list_smem(int tile, int chunk, int lk) {
  return 12L * tile * lk + 4L * chunk * ((tile + 31) / 32);
}

// The lists of one image row.  kMerge (the bf16 form): df1's runs are
// one per (pixel, column), each the sum in tap order of the pixel's taps
// on the column, as df2's entries are.
template <bool kMerge, typename T>
__global__ void __launch_bounds__(kListThreads)
alt_corr_taps_bwd_lists_kernel(const Args<T> a) {
  extern __shared__ __align__(16) int lsm[];
  __shared__ int poison, keep_lo[kMaxLevels], keep_hi[kMaxLevels];
  __shared__ int scan[kListThreads / 32];
  const Levels& lv = a.lv;
  const int L = lv.n, kk = a.kk, lk = L * kk, w1 = a.w1, w2cat = a.w2cat;
  const long n = blockIdx.x;
  const int tile = a.tile, chunk = a.chunk, words = (tile + 31) / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* tb = lsm;                                       // [tile][lk]
  float* ta0 = reinterpret_cast<float*>(tb + (long)tile * lk);
  float* ta1 = ta0 + (long)tile * lk;
  unsigned* mask = reinterpret_cast<unsigned*>(ta1 + (long)tile * lk);
  const float* trow = a.taps + n * (long)w1 * lk;
  const float* grow = a.g + n * (long)w1 * lk;
  const Work& wk = a.wk;
  Entry* runs = wk.runs + n * w1 * wk.r;
  Entry* hits = wk.hits + n * wk.h;
  unsigned* nrun = wk.nrun + n * w1;
  int* start = wk.start + n * (w2cat + 1L);
  int* cursor = wk.cursor + n * (long)w2cat;
  // one tile and one chunk: pass 1's masks serve pass 2
  const bool keep_masks = tile >= w1 && chunk >= w2cat;

  if (threadIdx.x == 0) poison = 0;
  if (threadIdx.x < kMaxLevels) {
    keep_lo[threadIdx.x] = INT_MIN;
    keep_hi[threadIdx.x] = INT_MAX;
  }
  for (int x = threadIdx.x; x <= w2cat; x += kListThreads) start[x] = 0;
  __syncthreads();  // the flags are set before any tap updates them

  // The tables of a tile, and (in pass 1) the row's flags.
  auto tables = [&](int p0, int np, bool flags) {
    for (int t = threadIdx.x; t < np * lk; t += kListThreads) {
      const int q = t % lk, l = q / kk, w = lv.width[l];
      const long at = (long)p0 * lk + t;
      const Tap p = read_tap(trow[at], grow[at], w);
      tb[t] = p.b;
      ta0[t] = p.a0;
      ta1[t] = p.a1;
      if (!flags || w == 0) continue;
      if (p.b == kNan) {
        atomicOr(&poison, 1 << l);
      } else if (isinf(p.a0)) {  // the tap's columns {b, b+1}, or none
        atomicMax(&keep_lo[l], p.b == kFar ? INT_MAX : p.b);
        atomicMin(&keep_hi[l], p.b + 1);
      }
    }
  };
  // Bit i of mask word [x][i / 32]: the tile's pixel i weights chunk
  // column x.
  auto masks = [&](int np, int cb, int nc) {
    for (int t = threadIdx.x; t < nc * words; t += kListThreads)
      mask[t] = 0u;
    __syncthreads();
    for (int t = threadIdx.x; t < np * lk; t += kListThreads) {
      const int i = t / lk, l = (t - i * lk) / kk;
      const int b = tb[t], w = lv.width[l];
      if (b >= kFar) continue;
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const int x = lv.off[l] + b + d - cb;
        if (b + d >= 0 && b + d < w && x >= 0 && x < nc)
          atomicOr(&mask[x * words + (i >> 5)], 1u << (i & 31));
      }
    }
    __syncthreads();
  };

  // Pass 1: tables, df1's runs, each column's entry count.
  const int ntile = max(1, (w1 + tile - 1) / tile);
  for (int p0 = 0; p0 < w1; p0 += tile) {
    const int np = min(tile, w1 - p0);
    if (p0) __syncthreads();  // the last tile's tables are read
    tables(p0, np, true);
    __syncthreads();
    for (int i = threadIdx.x; i < np; i += kListThreads) {
      unsigned r = 0;
      bool bad = false;
      Entry* out = runs + (long)(p0 + i) * wk.r;
      Entry held{0, 0};  // a run waiting for its pair: 16-byte stores
      auto put = [&](int col, float cf) {
        const Entry e{col, __float_as_int(cf)};
        if (r & 1)
          *reinterpret_cast<int4*>(out + r - 1) =
              make_int4(held.at, held.coef, e.at, e.coef);
        else
          held = e;
        ++r;
      };
      for (int l = 0; l < L; ++l) {
        const int w = lv.width[l], off = lv.off[l];
        int pend = -1;  // column whose coefficient is being summed
        float coef = 0.f;
        for (int k = 0; k < kk; ++k) {
          const int t = i * lk + l * kk + k, b = tb[t];
          if (b == kNan) {
            bad = bad || w > 0;
            continue;
          }
          // An infinite g puts inf * 0 = NaN on every column its tap does
          // not reach.
          const int reach = b == kFar ? 0 : (b >= 0) + (b + 1 < w);
          if (isinf(ta0[t]) && reach < w) bad = true;
          if (b == kFar) continue;
          if constexpr (kMerge) {
            const int t0 = i * lk + l * kk;  // the level's taps
#pragma unroll
            for (int d = 0; d < 2; ++d) {
              const int j = b + d;
              if (j < 0 || j >= w) continue;
              bool first = true;
              for (int e = 0; e < k && first; ++e) {
                const int o = tb[t0 + e];
                first = o >= kFar || (o != j && o + 1 != j);
              }
              if (first) put(off + j, column_sum(tb, ta0, ta1, t0, k, kk, j,
                                                 d ? ta1[t] : ta0[t]));
            }
            continue;
          }
#pragma unroll
          for (int d = 0; d < 2; ++d) {
            const int j = b + d;
            if (j < 0 || j >= w) continue;
            const float av = d ? ta1[t] : ta0[t];
            if (j == pend) {
              coef = __fadd_rn(coef, av);
            } else {
              if (pend >= 0) put(off + pend, coef);
              pend = j;
              coef = av;
            }
          }
        }
        if (pend >= 0) put(off + pend, coef);
      }
      if (r & 1) out[r - 1] = held;
      nrun[p0 + i] = r | (bad ? kPoisoned : 0u);
    }
    for (int cb = 0; cb < w2cat; cb += chunk) {
      const int nc = min(chunk, w2cat - cb);
      masks(np, cb, nc);
      for (int x = threadIdx.x; x < nc; x += kListThreads) {
        int cnt = 0;
        for (int e = 0; e < words; ++e) cnt += __popc(mask[x * words + e]);
        start[cb + x + 1] += cnt;  // this thread's column alone
      }
      __syncthreads();
    }
  }

  // Each column's start: an exclusive scan of the counts, in steps of
  // kListThreads columns, carried from step to step.
  int carry = 0;
  for (int x0 = 1; x0 <= w2cat; x0 += kListThreads) {
    const int x = x0 + threadIdx.x;
    const int v = x <= w2cat ? start[x] : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) scan[warp] = incl;
    __syncthreads();
    int before = carry;
    for (int e = 0; e < warp; ++e) before += scan[e];
    int total = carry;
    for (int e = 0; e < kListThreads / 32; ++e) total += scan[e];
    if (x <= w2cat) {
      start[x] = before + incl;
      cursor[x - 1] = before + incl - v;
    }
    carry = total;
    __syncthreads();
  }

  // Pass 2: df2's entries.  One thread per (pixel, tap): the pixel's
  // first tap on a column writes, at the pixel's rank in the column's
  // mask, the sum in tap order of its taps on that column.
  for (int p0 = 0; p0 < w1; p0 += tile) {
    const int np = min(tile, w1 - p0);
    if (ntile > 1) {
      tables(p0, np, false);
      __syncthreads();
    }
    for (int cb = 0; cb < w2cat; cb += chunk) {
      const int nc = min(chunk, w2cat - cb);
      if (!keep_masks) masks(np, cb, nc);
      for (int t = threadIdx.x; t < np * lk; t += kListThreads) {
        const int i = t / lk, q = t - i * lk, l = q / kk, k = q - l * kk;
        const int b = tb[t], w = lv.width[l];
        if (b >= kFar) continue;
        const int t0 = i * lk + l * kk;  // the level's taps
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          const int j = b + d, x = lv.off[l] + j - cb;
          if (j < 0 || j >= w || x < 0 || x >= nc) continue;
          bool first = true;
          for (int e = 0; e < k && first; ++e) {
            const int o = tb[t0 + e];
            first = o >= kFar || (o != j && o + 1 != j);
          }
          if (!first) continue;
          const float cf =
              column_sum(tb, ta0, ta1, t0, k, kk, j, d ? ta1[t] : ta0[t]);
          const unsigned* m = mask + x * words;
          int r = cursor[cb + x] + __popc(m[i >> 5] & ((1u << (i & 31)) - 1u));
          for (int e = 0; e < (i >> 5); ++e) r += __popc(m[e]);
          hits[r] = Entry{p0 + i, __float_as_int(cf)};
        }
      }
      __syncthreads();
      for (int x = threadIdx.x; x < nc; x += kListThreads) {
        int cnt = 0;
        for (int e = 0; e < words; ++e) cnt += __popc(mask[x * words + e]);
        cursor[cb + x] += cnt;
      }
      __syncthreads();
    }
  }
  int* flags = wk.flags + n * kFlags;
  if (threadIdx.x == 0) flags[0] = poison;
  if (threadIdx.x < kMaxLevels) {
    flags[1 + threadIdx.x] = keep_lo[threadIdx.x];
    flags[1 + kMaxLevels + threadIdx.x] = keep_hi[threadIdx.x];
  }
}

// One lane's channels: a 16-byte vector of the fmaps' type, 4 fp32 or
// 8 bf16 channels, summed in fp32.
template <typename T>
struct Lane;
template <>
struct Lane<float> {
  static constexpr int kVec = 4;
  using Raw = float4;
  __device__ static void fma(float (&acc)[kVec], float s, const Raw& v) {
    acc[0] = fmaf(s, v.x, acc[0]);
    acc[1] = fmaf(s, v.y, acc[1]);
    acc[2] = fmaf(s, v.z, acc[2]);
    acc[3] = fmaf(s, v.w, acc[3]);
  }
  __device__ static Raw pack(const float (&v)[kVec]) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ static float coef(float v) { return v; }
};
template <>
struct Lane<__nv_bfloat16> {
  static constexpr int kVec = 8;
  using Raw = uint4;
  // Each product of two bf16 values is exact in fp32.
  __device__ static void fma(float (&acc)[kVec], float s, const Raw& t) {
    const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[2 * e] = fmaf(s, __uint_as_float(w[e] << 16), acc[2 * e]);
      acc[2 * e + 1] =
          fmaf(s, __uint_as_float(w[e] & 0xffff0000u), acc[2 * e + 1]);
    }
  }
  __device__ static Raw pack(const float (&v)[kVec]) {
    unsigned w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
      w[e] = *reinterpret_cast<const unsigned*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  // dm.astype(bf16): the scaled fp32 coefficient rounded once.
  __device__ static float coef(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

template <typename T>
__device__ __forceinline__ void store(T* p, float (&v)[Lane<T>::kVec],
                                      bool bad) {
  if (bad) {
#pragma unroll
    for (int e = 0; e < Lane<T>::kVec; ++e) v[e] = NAN;
  }
  *reinterpret_cast<typename Lane<T>::Raw*>(p) = Lane<T>::pack(v);
}

// acc += sum over list[0, n) in order of scale * coef * rows[at] (this
// lane's channels; the scaled coefficient rounded to T): 32 entries read
// at once, kBatch rows in flight.
template <typename T>
__device__ __forceinline__ void sum_rows(float (&acc)[Lane<T>::kVec],
                                         const Entry* list, int n,
                                         const T* rows, int c, float scale,
                                         int lane) {
  using Raw = typename Lane<T>::Raw;
  for (int e0 = 0; e0 < n; e0 += 32) {
    const Entry mine = e0 + lane < n ? list[e0 + lane] : Entry{0, 0};
    const int m = min(32, n - e0);
    for (int h0 = 0; h0 < m; h0 += kBatch) {
      float s[kBatch];
      Raw v[kBatch];
#pragma unroll
      for (int h = 0; h < kBatch; ++h) {
        const int at = __shfl_sync(0xffffffffu, mine.at, (h0 + h) & 31);
        const int cf = __shfl_sync(0xffffffffu, mine.coef, (h0 + h) & 31);
        s[h] = Lane<T>::coef(__fmul_rn(__int_as_float(cf), scale));
        if (h0 + h < m)  // warp-uniform
          v[h] = *reinterpret_cast<const Raw*>(rows + (long)at * c);
      }
#pragma unroll
      for (int h = 0; h < kBatch; ++h)
        if (h0 + h < m) Lane<T>::fma(acc, s[h], v[h]);
    }
  }
}

// df1 and df2 of one image row and channel slice, from its lists.
template <typename T>
__global__ void __launch_bounds__(kThreads)
alt_corr_taps_bwd_grads_kernel(const Args<T> a) {
  constexpr int kVec = Lane<T>::kVec;  // channels per lane
  constexpr int kSlice = 32 * kVec;    // channels per block
  __shared__ int flags[kFlags];
  const Levels& lv = a.lv;
  const int L = lv.n, c = a.c, w1 = a.w1, w2cat = a.w2cat;
  const long n = blockIdx.x / a.nslice;
  const int c0 = (blockIdx.x % a.nslice) * kSlice;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Work& wk = a.wk;
  const T* f1row = a.f1 + n * (long)w1 * c + c0 + lane * kVec;
  const T* f2row = a.f2 + n * (long)w2cat * c + c0 + lane * kVec;
  if (threadIdx.x < kFlags)
    flags[threadIdx.x] = wk.flags[n * kFlags + threadIdx.x];
  __syncthreads();

  // df1: one warp per pixel.
  for (int i = warp; i < w1; i += kWarps) {
    const unsigned nr = wk.nrun[n * w1 + i];
    float acc[kVec] = {};
    sum_rows<T>(acc, wk.runs + (n * w1 + i) * wk.r, (int)(nr & ~kPoisoned),
                f2row, c, a.scale, lane);
    store<T>(a.df1 + (n * w1 + i) * (long)c + c0 + lane * kVec, acc,
             nr & kPoisoned);
  }

  // df2: one warp per column.
  const int* start = wk.start + n * (w2cat + 1L);
  for (int x = warp; x < w2cat; x += kWarps) {
    int l = 0;
    while (l + 1 < L && x >= lv.off[l + 1]) ++l;
    const int jl = x - lv.off[l];
    float acc[kVec] = {};
    const int s0 = start[x];
    sum_rows<T>(acc, wk.hits + n * wk.h + s0, start[x + 1] - s0, f1row, c,
                a.scale, lane);
    const bool bad = ((flags[0] >> l) & 1) || jl < flags[1 + l] ||
                     jl > flags[1 + kMaxLevels + l];
    store<T>(a.df2 + (n * (long)w2cat + x) * c + c0 + lane * kVec, acc, bad);
  }
}

// The lists' pixels per tile and columns per chunk: the whole row and the
// whole pyramid where the tables and masks fit in shared memory, else
// the largest tile (the row, then multiples of 32, then powers of two)
// that fits, then narrower chunks.  False where not one pixel's tables
// fit (about 19,000 taps a pixel).
bool plan(int w1, int w2cat, int lk, int* tile, int* chunk) {
  const int chunks[] = {w2cat, 1024, 256, 32};
  for (int cw : chunks) {
    cw = max(1, min(cw, w2cat));
    for (int t = max(w1, 1); t >= 1;) {
      if (list_smem(t, cw, lk) <= kMaxSmem - 256) {
        *tile = t;
        *chunk = cw;
        return true;
      }
      t = t > 32 ? (t - 1) / 32 * 32 : t / 2;
    }
  }
  return false;
}

// The workspace of a call, laid out from `base` (nullptr: sizes only);
// returns its bytes.
long layout(Work* wk, char* base, long rows, int w1, int w2cat, int lk) {
  wk->r = 2L * lk;
  wk->h = (long)w1 * min(2L * lk, (long)w2cat);
  long at = 0;
  auto take = [&](long bytes) {
    char* p = base ? base + at : nullptr;
    at += (bytes + 255) / 256 * 256;
    return p;
  };
  wk->runs = reinterpret_cast<Entry*>(take(rows * w1 * wk->r * 8));
  wk->hits = reinterpret_cast<Entry*>(take(rows * wk->h * 8));
  wk->nrun = reinterpret_cast<unsigned*>(take(rows * w1 * 4));
  wk->start = reinterpret_cast<int*>(take(rows * (w2cat + 1L) * 4));
  wk->cursor = reinterpret_cast<int*>(take(rows * (long)w2cat * 4));
  wk->flags = reinterpret_cast<int*>(take(rows * kFlags * 4));
  return at;
}

// Rows per batch: as many as the workspace's kWorkBytes hold, at least
// one (layout(b rows) <= b * layout(1 row): each part is rounded up to
// 256 bytes once).
long batch_rows(long rows, int w1, int w2cat, int lk) {
  Work wk;
  const long one = layout(&wk, nullptr, 1, w1, w2cat, lk);
  return max(1L, min(rows, kWorkBytes / one));
}

template <typename T>
int run(const T* f1, const T* f2, const float* taps, const float* g, T* df1,
        T* df2, void* work, long rows, int w1, int w2cat, int c, int kk,
        float scale, int nlev, const int* offsets, const int* widths,
        void* stream) {
  constexpr int kSlice = 32 * Lane<T>::kVec;
  constexpr bool kMerge = Lane<T>::kVec == 8;
  if (nlev < 1 || nlev > kMaxLevels || c % kSlice != 0 || c < kSlice ||
      kk < 1)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  Args<T> a{f1, f2, taps, g, df1, df2, w1, w2cat, c, kk, c / kSlice,
            0, 0, scale, {}, {}};
  if (!plan(w1, w2cat, nlev * kk, &a.tile, &a.chunk))
    return (int)cudaErrorInvalidValue;
  a.lv.n = nlev;
  for (int l = 0; l < kMaxLevels; ++l) {
    a.lv.off[l] = l < nlev ? offsets[l] : 0;
    a.lv.width[l] = l < nlev ? widths[l] : 0;
  }
  const long lk = nlev * kk, batch = batch_rows(rows, w1, w2cat, lk);
  layout(&a.wk, static_cast<char*>(work), batch, w1, w2cat, lk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long smem = list_smem(a.tile, a.chunk, lk);
  auto lists = alt_corr_taps_bwd_lists_kernel<kMerge, T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lists, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  for (long r0 = 0; r0 < rows; r0 += batch) {
    const long nb = min(batch, rows - r0);
    Args<T> b = a;
    b.f1 += r0 * w1 * c;
    b.f2 += r0 * w2cat * c;
    b.taps += r0 * w1 * lk;
    b.g += r0 * w1 * lk;
    b.df1 += r0 * w1 * c;
    b.df2 += r0 * w2cat * c;
    lists<<<(unsigned)nb, kListThreads, (size_t)smem, s>>>(b);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    alt_corr_taps_bwd_grads_kernel<T>
        <<<(unsigned)(nb * a.nslice), kThreads, 0, s>>>(b);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// Rows per batch of a call (each batch two kernel launches).
extern "C" long alt_corr_taps_backward_batch(long rows, int w1, int w2cat,
                                             int nlev, int kk) {
  return batch_rows(rows, w1, w2cat, nlev * kk);
}

// Pixels per tile of a row's lists (the whole row W1 where its tables
// fit in shared memory), or 0 where a call at these sizes cannot run.
extern "C" int alt_corr_taps_backward_tile(int w1, int w2cat, int nlev,
                                           int kk) {
  int tile = 0, chunk = 0;
  return plan(w1, w2cat, nlev * kk, &tile, &chunk) ? tile : 0;
}

// Bytes of the workspace alt_corr_taps_backward needs.
extern "C" long alt_corr_taps_backward_workspace(long rows, int w1,
                                                 int w2cat, int nlev,
                                                 int kk) {
  Work wk;
  return layout(&wk, nullptr, batch_rows(rows, w1, w2cat, nlev * kk), w1,
                w2cat, nlev * kk);
}

// fmap1 (rows, W1, C), f2cat (rows, W2cat, C), taps and g (rows, W1,
// nlev*kk), all fp32 and contiguous, the fmaps 16-byte aligned; work
// (alt_corr_taps_backward_workspace bytes, 256-byte aligned, reused by
// each batch of alt_corr_taps_backward_batch rows); writes df1
// (rows, W1, C) and df2 (rows, W2cat, C) in full.  C must be a multiple of
// 128; nlev <= 8; W2cat = sum(widths); alt_corr_taps_backward_tile must
// be at least 1.  Returns the CUDA error code of the launches (0 on
// success).
extern "C" int alt_corr_taps_backward(const float* f1, const float* f2,
                                      const float* taps, const float* g,
                                      float* df1, float* df2, void* work,
                                      long rows, int w1, int w2cat, int c,
                                      int kk, float scale, int nlev,
                                      const int* offsets, const int* widths,
                                      void* stream) {
  return run<float>(f1, f2, taps, g, df1, df2, work, rows, w1, w2cat, c, kk,
                    scale, nlev, offsets, widths, stream);
}

// The bf16 form: fmap1, f2cat, df1 and df2 bf16 (C a multiple of 256),
// taps and g fp32; otherwise as alt_corr_taps_backward.
extern "C" int alt_corr_taps_backward_bf16(
    const __nv_bfloat16* f1, const __nv_bfloat16* f2, const float* taps,
    const float* g, __nv_bfloat16* df1, __nv_bfloat16* df2, void* work,
    long rows, int w1, int w2cat, int c, int kk, float scale, int nlev,
    const int* offsets, const int* widths, void* stream) {
  return run<__nv_bfloat16>(f1, f2, taps, g, df1, df2, work, rows, w1, w2cat,
                            c, kk, scale, nlev, offsets, widths, stream);
}
