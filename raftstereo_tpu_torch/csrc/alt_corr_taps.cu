// On-demand all-level correlation lookup at caller-given taps, for Hopper
// (sm_90a): fp32 or bf16 feature maps in, fp32 or bf16 features out.
//
// Replaces the TPU kernel raftstereo_tpu/ops/pallas_alt.py
// `_alt_pyr_fwd_kernel`, launched from `_alt_pyr_fwd_impl` (the forward of
// the custom VJP `_make_alt_pyr`, behind `pallas_alt_lookup`,
// `pallas_alt_lookup_flat` and `pallas_alt_pyramid_flat`).  Function: for
// every pixel (n, x1) of a flattened row n and every tap q = l*K + k of
// level l (local coordinate t = taps[n, x1, q], level width w_l),
//   out[n, x1, q] = sum_{j in [0, w_l)} M_l[j] * max(0, 1 - |j - t|),
//   M_l[j] = <fmap1[n, x1, :], fmap2_l[n, j, :]> / sqrt(C).
// The hat is nonzero at two columns at most: j0 = floor(t) with weight
// 1 - f and j0 + 1 with weight f, f = t - j0.  So a tap in (-1, w_l) reads
// the columns of {j0, j0 + 1} that lie inside the level, a tap outside
// (including +-inf) gives 0, and a NaN tap gives NaN (as the TPU's dense
// hat does: max(0, NaN) is NaN on every column).  The hat weight 1-|j-t|
// and the lerp weight agree up to fp32 rounding.  Accumulation is fp32
// FMAs (no TF32); bf16 feature maps are widened exactly; a bf16 output is
// the fp32 result rounded once.
//
// Design.  The TPU kernel computes whole (block x W2cat) correlation rows
// on its matrix unit and sweeps a dense hat per tap.  Here a block of
// kThreads threads owns one image row, a tile of kTilePix pixels (kTeam
// threads a pixel) and a group of levels: consecutive levels whose
// widths sum to at most the widest, so a halving pyramid's level 0 and
// levels 1..L-1 go to two blocks of even work (a finer grain for the
// card's 132 SMs).  The block first marks in shared memory each pixel's
// distinct columns per level, the union of {j0, j0 + 1} over its taps (a
// bitmask per pixel and level; a column's slot is its rank there), and
// the span of columns the tile needs per level.  Then the spans' fmap2
// columns stream through shared memory in 128-byte channel chunks (32
// fp32 or 64 bf16 channels, a window of at most kMaxSpan columns at a
// time) through a 2-stage `cp.async` ring that runs on from one level to
// the next, so the block reads each fmap2 row of a span from L2 once,
// where one warp per pixel read a whole 1 KB row per dot.  Each thread
// sums whole dots, up to kSlots at once in registers across the chunks,
// for its pixel's slots q, q + kTeam, ... of the window (more slots take
// more rounds: as many as the window's most columns a pixel need, so a
// wide level's windows each take their own count, and a window that no
// pixel's columns meet is skipped);
// its pixel's fmap1 chunk is loaded into registers as the chunk's copy
// lands.  Lane i reads 16-byte slot (s + i) mod 8 of a staged row at step
// s (the fmap1 registers are loaded in the same order), so 8 lanes
// reading 8 columns never meet in a bank, and a dot's channels are summed
// in that lane's rotated order.  The dots, scaled, go to shared memory;
// when a level's dots are done, one thread per (pixel, tap) reads its two
// columns' dots by their ranks and writes the tap.  Every dot is summed
// by a fixed thread in a fixed order, so two calls on the same inputs give
// equal bits.  The call takes the general form, the first form of this
// kernel (one warp per pixel, each lane holding C/32 channels of fmap1,
// each new column's fmap2 row read whole and reduced by shuffles), where
// a tile's dots would outgrow shared memory (about 2 K columns a pixel on
// a level wider than a few hundred columns with hundreds of taps) or a
// level is wider than kMaxWindows windows: there every window of the
// tile's span is staged for a few columns a pixel, and one chunk in
// flight leaves the copies' latency exposed (timed: the tiled form ahead
// up to 3 windows a level, behind from 4; PERF.md section 6).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): at 144 rows of 240 pixels, C=256, level widths 240/120/60/30 and
// 36 taps, the call must read fmap1 (35.4 MB), the fmap2 pyramid (66.4 MB)
// and the taps (5.0 MB) and write the output (5.0 MB): about 112 MB, 33 us.
// The dots are at most 2*36*256*2 FLOPs per pixel (1.3 GFLOP, 19 us), so
// it is bound by bytes.  What holds this design back from that: every
// FMA reads its fmap2 operand from shared memory (4 bytes an FMA, a
// quarter of the FP32 units' rate: about 0.07 ms of shared-memory traffic
// at that shape); the span is read once per tile (64 pixels) from L2, not
// once per row; the tile's fmap1 chunk is re-read from L2 for every
// level; and one chunk in flight per block leaves the copies' latency
// partly exposed (3 blocks an SM, shared memory being the limit).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kTilePix = 64;     // pixels of one image row per block
constexpr int kTeam = 4;         // threads per pixel
constexpr int kThreads = kTilePix * kTeam;
constexpr int kSlots = 5;        // dots a thread sums at once
constexpr int kRowBytes = 128;   // a staged row's chunk: 8 slots of 16 B
constexpr int kMaxSpan = 256;    // fmap2 columns a stage holds
constexpr int kMaxWindows = 3;   // a level's windows the tiled form takes
constexpr int kMaxSmem = 232448; // bytes a block may opt in to
constexpr int kGeneralWarps = 8; // warps per block of the general form

struct Levels {
  int n;
  int off[kMaxLevels];    // first column of level l in the concatenated W2
  int width[kMaxLevels];  // width w_l of level l
  int words[kMaxLevels];  // first mask word of level l in a pixel's masks
  int wins[kMaxLevels];   // first window of level l in the block's windows
};

struct Args {
  const void* f1;     // (rows, W1, C)
  const void* f2;     // (rows, W2cat, C)
  const float* taps;  // (rows, W1, L*K)
  void* out;          // (rows, W1, L*K)
  int w1, w2cat, c, kk;
  int span;   // fmap2 columns a stage holds: min(widest level, kMaxSpan)
  int words;  // mask words a pixel: sum of ceil(w_l / 32)
  int dmax;   // dot slots a pixel: the largest min(2 K, w_l)
  int nwin;   // windows of span columns: sum of ceil(w_l / span)
  float scale;
  Levels lv;
  int ngroup;                  // groups of levels, one block each
  int group[kMaxLevels + 1];  // group g: levels [group[g], group[g + 1])
};

// 16 bytes of a feature map, widened to fp32: 4 fp32 or 8 bf16 values.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int V = 4;
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// A pixel's slot of column j of a level (the count of its distinct
// columns there below j), from the level's mask words and their prefix
// counts (lw + 1 of them); j = w gives the level's count.
__device__ __forceinline__ int slot_of(const unsigned* bits, const int* pre,
                                       int j, int lw) {
  const int e = j >> 5;
  if (e >= lw) return pre[lw];
  return pre[e] + __popc(bits[e] & ((1u << (j & 31)) - 1u));
}

// The column of a pixel's slot s of a level (s below its count there).
__device__ __forceinline__ int column_of(const unsigned* bits,
                                         const int* pre, int s) {
  int e = 0;
  while (pre[e + 1] <= s) ++e;
  unsigned m = bits[e];
  for (int k = s - pre[e]; k > 0; --k) m &= m - 1u;
  return e * 32 + __ffs(m) - 1;
}

// One pass of the dot pipeline: level l's columns [a0, a0 + wn) (a window
// of its span), round r of its slots.  The passes run levels ascending,
// windows ascending, rounds ascending.
struct Pass {
  int l, a0, wn, r;
};

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads, 3)
alt_corr_taps_kernel(const Args a) {
  constexpr int V = Vec<TIn>::V;
  extern __shared__ __align__(16) char smem[];
  __shared__ int span_lo[kMaxLevels], span_hi[kMaxLevels];
  const Levels& lv = a.lv;
  const int L = lv.n, kk = a.kk, lk = L * kk, w1 = a.w1;
  const int nw = a.words, pw = a.words + L, dmax = a.dmax;
  const int ntile = (w1 + kTilePix - 1) / kTilePix;
  const int grp = blockIdx.x % a.ngroup;
  const long row = blockIdx.x / a.ngroup / ntile;
  const int p0 = (blockIdx.x / a.ngroup % ntile) * kTilePix;
  const int np = min(kTilePix, w1 - p0);
  const int l0 = a.group[grp], l1 = a.group[grp + 1];  // this block's levels
  const int glk = (l1 - l0) * kk, q0 = l0 * kk;
  const int pl = threadIdx.x / kTeam, q = threadIdx.x % kTeam;
  const int rot = threadIdx.x & 7;
  const long rowb = (long)a.c * sizeof(TIn);
  const int nchunk = (int)(rowb / kRowBytes);
  const int stage_rows = a.span;
  char* stage = smem;  // [2][span][kRowBytes]: a window's fmap2 columns
  unsigned* bits =
      reinterpret_cast<unsigned*>(smem + 2L * stage_rows * kRowBytes);
  int* pre = reinterpret_cast<int*>(bits + kTilePix * nw);    // [.][pw]
  float* dots = reinterpret_cast<float*>(pre + kTilePix * pw);  // [.][dmax]
  // the dots of the level being summed
  int* wmost = reinterpret_cast<int*>(dots + kTilePix * dmax);  // [nwin]
  // a pixel's largest count in each window of each level
  const char* f1tile = static_cast<const char*>(a.f1) + (row * w1 + p0) * rowb;
  const char* f2row = static_cast<const char*>(a.f2) + row * a.w2cat * rowb;
  const float* tp = a.taps + (row * w1 + p0) * (long)lk;
  TOut* op = static_cast<TOut*>(a.out) + (row * w1 + p0) * (long)lk;

  for (int t = threadIdx.x; t < kTilePix * nw; t += kThreads) bits[t] = 0u;
  for (int t = threadIdx.x; t < a.nwin; t += kThreads) wmost[t] = 0;
  if (threadIdx.x < kMaxLevels) {
    span_lo[threadIdx.x] = INT_MAX;
    span_hi[threadIdx.x] = -1;
  }
  __syncthreads();

  // Each pixel's distinct columns per level, and the tile's spans.
  for (int t = threadIdx.x; t < np * glk; t += kThreads) {
    const int i = t / glk, q = q0 + t - i * glk, l = q / kk, w = lv.width[l];
    const float tv = __ldg(tp + i * lk + q);
    if (!(tv > -1.f && tv < (float)w)) continue;  // NaN too
    const int j0 = (int)floorf(tv);
    const int ja = max(j0, 0), jb = min(j0 + 1, w - 1);
    for (int j = ja; j <= jb; ++j)
      atomicOr(&bits[i * nw + lv.words[l] + (j >> 5)], 1u << (j & 31));
    atomicMin(&span_lo[l], ja);
    atomicMax(&span_hi[l], jb);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < np * (l1 - l0); t += kThreads) {
    const int i = t / (l1 - l0), l = l0 + t - i * (l1 - l0);
    const int lw = (lv.width[l] + 31) >> 5;
    const unsigned* b = bits + i * nw + lv.words[l];
    int* p = pre + i * pw + lv.words[l] + l;
    int s = 0;
    for (int e = 0; e < lw; ++e) {
      p[e] = s;
      s += __popc(b[e]);
    }
    p[lw] = s;
    if (span_lo[l] <= span_hi[l] && span_hi[l] - span_lo[l] < a.span)
      atomicMax(&wmost[lv.wins[l]], s);  // the level is one window
  }
  __syncthreads();
  // Each window's most slots a pixel (its rounds), on levels of more than
  // one window.
  bool multi = false;
  for (int l = l0; l < l1; ++l) {
    if (span_lo[l] > span_hi[l] || span_hi[l] - span_lo[l] < a.span)
      continue;
    multi = true;
    const int nwl = (span_hi[l] - span_lo[l]) / a.span + 1;
    const int lw = (lv.width[l] + 31) >> 5;
    for (int t = threadIdx.x; t < np * nwl; t += kThreads) {
      const int i = t / nwl, v = t - i * nwl;
      const int c0 = span_lo[l] + v * a.span;
      const int c1 = min(c0 + a.span, span_hi[l] + 1);
      const unsigned* b = bits + i * nw + lv.words[l];
      const int* p = pre + i * pw + lv.words[l] + l;
      atomicMax(&wmost[lv.wins[l] + v],
                slot_of(b, p, c1, lw) - slot_of(b, p, c0, lw));
    }
  }
  if (multi) __syncthreads();

  // The passes, in order: the windows of the levels that some pixel's
  // columns meet, ascending, each in rounds of kTeam * kSlots slots.
  auto most = [&](const Pass& p) {
    return wmost[lv.wins[p.l] + (p.a0 - span_lo[p.l]) / a.span];
  };
  // The first pass at or after window a0 of level l; false past the last.
  auto seek = [&](Pass& p) {
    for (; p.l < l1; ++p.l, p.a0 = INT_MIN) {
      if (span_lo[p.l] > span_hi[p.l]) continue;
      p.a0 = max(p.a0, span_lo[p.l]);
      for (; p.a0 <= span_hi[p.l]; p.a0 += a.span) {
        if (most(p) > 0) {
          p.wn = min(a.span, span_hi[p.l] + 1 - p.a0);
          p.r = 0;
          return true;
        }
      }
    }
    return false;
  };
  auto advance = [&](Pass& p) {
    const int rounds = (most(p) + kTeam * kSlots - 1) / (kTeam * kSlots);
    if (++p.r < rounds) return true;
    p.a0 += a.span;
    return seek(p);
  };
  // Stage chunk ch of pass p's window.
  auto issue = [&](const Pass& p, int ch, int buf) {
    char* dst = stage + (long)buf * stage_rows * kRowBytes;
    const char* src =
        f2row + ((long)lv.off[p.l] + p.a0) * rowb + ch * kRowBytes;
    for (int u = threadIdx.x; u < p.wn * 8; u += kThreads)
      cp_async16(dst + u * 16, src + (long)(u >> 3) * rowb + (u & 7) * 16);
    cp_async_commit();
  };
  // The taps of level l: one thread per (pixel, tap), the level's dots
  // read by their slots.
  auto emit = [&](int l) {
    const int w = lv.width[l], lw = (w + 31) >> 5;
    for (int t = threadIdx.x; t < np * kk; t += kThreads) {
      const int i = t / kk, q = l * kk + t - i * kk;
      const float tv = __ldg(tp + i * lk + q);
      float r = 0.f;
      if (isnan(tv)) {
        if (w > 0) r = NAN;
      } else if (tv > -1.f && tv < (float)w) {
        const float b0 = floorf(tv);
        const float f = tv - b0;
        const int j0 = (int)b0;  // in [-1, w - 1]
        const unsigned* ib = bits + i * nw + lv.words[l];
        const int* ip = pre + i * pw + lv.words[l] + l;
        const float* id = dots + i * dmax;
        const float v0 = j0 >= 0 ? id[slot_of(ib, ip, j0, lw)] : 0.f;
        const float v1 = j0 + 1 < w ? id[slot_of(ib, ip, j0 + 1, lw)] : 0.f;
        // Two products and a sum, each rounded: the plain version's order.
        r = __fadd_rn(__fmul_rn(v0, __fsub_rn(1.f, f)), __fmul_rn(v1, f));
      }
      put(op + i * lk + q, r);
    }
  };
  // The levels no tap meets (their taps are 0, or NaN at NaN taps).
  for (int l = l0; l < l1; ++l)
    if (span_lo[l] > span_hi[l]) emit(l);

  Pass cur{-1, 0, 0, -1};
  {  // the first pass
    Pass p{l0, INT_MIN, 0, 0};
    if (seek(p)) cur = p;
  }
  if (cur.l >= 0) issue(cur, 0, 0);
  int ns = 0;         // this thread's slots in the pass: s0 + kTeam * g
  int s0 = 0;
  int at[kSlots];     // byte offset of each slot's staged row
  float acc[kSlots];
  for (int item = 0; cur.l >= 0; ++item) {
    const int ch = item % nchunk;
    const int lw = (lv.width[cur.l] + 31) >> 5;
    const unsigned* mybits = bits + pl * nw + lv.words[cur.l];
    const int* mypre = pre + pl * pw + lv.words[cur.l] + cur.l;
    if (ch == 0) {  // the pass's slots for this thread
      ns = 0;
      s0 = 0;
      if (pl < np) {
        const int r0 = slot_of(mybits, mypre, cur.a0, lw);
        const int r1 = slot_of(mybits, mypre, min(cur.a0 + cur.wn,
                                                  lv.width[cur.l]), lw);
        s0 = r0 + cur.r * kTeam * kSlots + q;
#pragma unroll
        for (int g = 0; g < kSlots; ++g) {
          at[g] = 0;
          if (s0 + kTeam * g < r1) {
            const int col = column_of(mybits, mypre, s0 + kTeam * g);
            at[g] = (col - cur.a0) * kRowBytes;
            ns = g + 1;
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kSlots; ++g) acc[g] = 0.f;
    }
    Pass next = cur;
    const bool more = ch + 1 < nchunk || advance(next);
    uint4 f1r[8];  // this pixel's fmap1 chunk, slot (s + rot) & 7 at s
    if (ns) {
#pragma unroll
      for (int s = 0; s < 8; ++s)
        f1r[s] = __ldg(reinterpret_cast<const uint4*>(
            f1tile + pl * rowb + ch * kRowBytes + ((s + rot) & 7) * 16));
    }
    cp_async_wait_all();
    __syncthreads();
    if (more) issue(next, (ch + 1) % nchunk, (item + 1) & 1);
    if (ns) {
      const char* buf = stage + (long)(item & 1) * stage_rows * kRowBytes;
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int qo = ((s + rot) & 7) * 16;
        float av[V], bv[V];
        Vec<TIn>::widen(f1r[s], av);
#pragma unroll
        for (int g = 0; g < kSlots; ++g) {
          if (g < ns) {
            Vec<TIn>::widen(
                *reinterpret_cast<const uint4*>(buf + at[g] + qo), bv);
#pragma unroll
            for (int v = 0; v < V; ++v) acc[g] = fmaf(av[v], bv[v], acc[g]);
          }
        }
      }
    }
    if (ch + 1 == nchunk) {  // the pass's dots, scaled
      float* d = dots + pl * dmax;
#pragma unroll
      for (int g = 0; g < kSlots; ++g)
        if (g < ns) d[s0 + kTeam * g] = __fmul_rn(acc[g], a.scale);
      if (!more || next.l != cur.l) {  // the level is summed: its taps
        __syncthreads();  // (the next level's dots wait for the next sync)
        emit(cur.l);
      }
      cur = more ? next : Pass{-1, 0, 0, -1};
    }
  }

}

// The general form, for calls the tiled form does not take: one warp per
// pixel, each lane holding its C/32 channels of fmap1 (the first 512 in
// registers, any beyond through the caches), each column's fmap2 row
// read with 16-byte loads and reduced across the warp by shuffles; a
// tap's columns are checked against the previous tap's two (a
// warp-uniform test) and only new ones are computed.  Its parameters are
// the first form's (restrict-qualified pointers: the taps and rows take
// the read-only path, and no output store makes the compiler reload
// them).
template <typename TIn, bool kWide>
struct Row {
  static constexpr int V = Vec<TIn>::V;
  static constexpr int kChunk = 32 * V;
  static constexpr int kMaxChunks = 512 / kChunk;
  float a[kMaxChunks][V];  // this lane's first 512 channels of fmap1
  const TIn* p1;           // fmap1 pixel, offset to this lane's channels
  const TIn* f2row;        // fmap2 row n, offset to this lane's channels
  int c, nchunk;
  float scale;

  // <fmap1[pix], fmap2[n, col]> * scale, identical on every lane.
  __device__ __forceinline__ float dot(int col) const {
    const TIn* p2 = f2row + (long)col * c;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxChunks; ++i) {
      if (i < nchunk) {
        float b[V];
        Vec<TIn>::widen(*reinterpret_cast<const uint4*>(p2 + i * kChunk), b);
#pragma unroll
        for (int v = 0; v < V; ++v) s = fmaf(a[i][v], b[v], s);
      }
    }
    for (int i = kMaxChunks; kWide && i < nchunk; ++i) {  // C > 512: caches
      float x[V], b[V];
      Vec<TIn>::widen(*reinterpret_cast<const uint4*>(p1 + i * kChunk), x);
      Vec<TIn>::widen(*reinterpret_cast<const uint4*>(p2 + i * kChunk), b);
#pragma unroll
      for (int v = 0; v < V; ++v) s = fmaf(x[v], b[v], s);
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
    return __fmul_rn(s, scale);
  }
};

template <typename TIn, typename TOut, bool kWide>
__global__ void __launch_bounds__(32 * kGeneralWarps)
alt_corr_taps_general_kernel(const TIn* __restrict__ f1,
                             const TIn* __restrict__ f2,
                             const float* __restrict__ taps,
                             TOut* __restrict__ out, long npix, int w1,
                             int w2cat, int c, int kk, float scale,
                             Levels lv) {
  using R = Row<TIn, kWide>;
  const int lane = threadIdx.x & 31;
  const long pix = (long)blockIdx.x * kGeneralWarps + (threadIdx.x >> 5);
  if (pix >= npix) return;  // whole warps exit together
  R row;
  row.c = c;
  row.nchunk = c / R::kChunk;
  row.scale = scale;
  row.p1 = f1 + pix * c + lane * R::V;
#pragma unroll
  for (int i = 0; i < R::kMaxChunks; ++i)
    if (i < row.nchunk)
      Vec<TIn>::widen(*reinterpret_cast<const uint4*>(row.p1 + i * R::kChunk),
                      row.a[i]);
  row.f2row = f2 + (pix / w1) * (long)w2cat * c + lane * R::V;

  const int lk = lv.n * kk;
  const float* tp = taps + pix * lk;
  TOut* o = out + pix * lk;
  for (int l = 0; l < lv.n; ++l) {
    const int off = lv.off[l], w = lv.width[l];
    // The previous tap's columns and their dots (-2: none).
    int ca = -2, cb = -2;
    float va = 0.f, vb = 0.f;
    for (int k = 0; k < kk; ++k) {
      const float t = tp[l * kk + k];  // the same address on every lane
      float r = 0.f;
      if (isnan(t)) {
        if (w > 0) r = NAN;
      } else if (t > -1.f && t < (float)w) {
        const float b0 = floorf(t);
        const float f = t - b0;
        const int j0 = (int)b0;  // in [-1, w - 1]
        float v[2];
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          const int j = j0 + d;
          if (j < 0 || j >= w) {
            v[d] = 0.f;
          } else if (j == ca) {
            v[d] = va;
          } else if (j == cb) {
            v[d] = vb;
          } else {
            v[d] = row.dot(off + j);
          }
        }
        ca = j0;
        va = v[0];
        cb = j0 + 1;
        vb = v[1];
        r = __fadd_rn(__fmul_rn(v[0], __fsub_rn(1.f, f)), __fmul_rn(v[1], f));
      }
      if (lane == 0) put(o + l * kk + k, r);
    }
  }
}

// Shared memory of the tiled form.
long smem_bytes(const Args& a) {
  return 2L * a.span * kRowBytes +
         4L * kTilePix * (2L * a.words + a.lv.n + a.dmax) + 4L * a.nwin;
}

// The form a call takes: 0 the tiled form, 1 the general form where a
// tile's dots outgrow shared memory or a level is wider than kMaxWindows
// windows (chosen by timing both, PERF.md section 6).
int auto_form(const Args& a) {
  const long smem = smem_bytes(a);
  if (smem > kMaxSmem - 128) return 1;
  for (int l = 0; l < a.lv.n; ++l)
    if (a.lv.width[l] > kMaxWindows * kMaxSpan) return 1;
  return 0;
}

// `form` 0 or 1 (-1: auto_form).  128 bytes of shared memory stay free
// for the tiled form's static part.
template <typename TIn, typename TOut>
int launch(Args a, long rows, int form, cudaStream_t stream) {
  const long npix = rows * a.w1;
  const long smem = smem_bytes(a);
  if (form < 0) form = auto_form(a);
  if (form == 1) {
    const unsigned blocks =
        (unsigned)((npix + kGeneralWarps - 1) / kGeneralWarps);
    auto kernel = a.c > 512 ? alt_corr_taps_general_kernel<TIn, TOut, true>
                            : alt_corr_taps_general_kernel<TIn, TOut, false>;
    kernel<<<blocks, 32 * kGeneralWarps, 0, stream>>>(
        static_cast<const TIn*>(a.f1), static_cast<const TIn*>(a.f2), a.taps,
        static_cast<TOut*>(a.out), npix, a.w1, a.w2cat, a.c, a.kk, a.scale,
        a.lv);
    return (int)cudaGetLastError();
  }
  if (form != 0 || smem > kMaxSmem - 128) return (int)cudaErrorInvalidValue;
  auto kernel = alt_corr_taps_kernel<TIn, TOut>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long ntile = (a.w1 + kTilePix - 1) / kTilePix;
  kernel<<<(unsigned)(rows * ntile * a.ngroup), kThreads, (size_t)smem,
           stream>>>(a);
  return (int)cudaGetLastError();
}

// A call's level tables, spans and groups (pointers and scale unset).
Args plan(int w1, int w2cat, int c, int kk, int nlev, const int* offsets,
          const int* widths) {
  Args a{nullptr, nullptr, nullptr, nullptr, w1, w2cat, c, kk, 0, 0, 0, 0,
         0.f, {}, 0, {}};
  int widest = 0;
  a.lv.n = nlev;
  for (int l = 0; l < kMaxLevels; ++l) {
    const int w = l < nlev ? widths[l] : 0;
    a.lv.off[l] = l < nlev ? offsets[l] : 0;
    a.lv.width[l] = w;
    a.lv.words[l] = a.words;
    a.words += (w + 31) / 32;
    a.dmax = max(a.dmax, (int)min(2L * kk, (long)w));
    widest = max(widest, w);
  }
  a.span = max(1, min(widest, kMaxSpan));
  for (int l = 0; l < nlev; ++l) {
    a.lv.wins[l] = a.nwin;
    a.nwin += (widths[l] + a.span - 1) / a.span;
  }
  // Groups of consecutive levels whose widths sum to at most the widest
  // (levels 0 and 1..L-1 of a halving pyramid): the blocks' work evens out.
  a.ngroup = 0;
  for (int l = 0, sum = 0; l < nlev; ++l) {
    if (l == 0 || sum + widths[l] > widest) {
      a.group[a.ngroup++] = l;
      sum = 0;
    }
    sum += widths[l];
  }
  a.group[a.ngroup] = nlev;
  return a;
}

}  // namespace

// The form alt_corr_taps_forward takes at these sizes: 0 tiled, 1 general.
extern "C" int alt_corr_taps_forward_form(int w1, int kk, int nlev,
                                          const int* widths) {
  if (nlev < 1 || nlev > kMaxLevels) return -1;
  int offsets[kMaxLevels] = {};
  return auto_form(plan(w1, 0, 0, kk, nlev, offsets, widths));
}

// alt_corr_taps_forward in the given form (0 tiled, 1 general; -1 the
// one alt_corr_taps_forward_form names), for timing one against the
// other.  The tiled form refuses sizes whose dots outgrow shared memory.
extern "C" int alt_corr_taps_forward_as(int form, const void* f1,
                                        const void* f2, const float* taps,
                                        void* out, long npix, int w1,
                                        int w2cat, int c, int kk, float scale,
                                        int nlev, const int* offsets,
                                        const int* widths, int in_bf16,
                                        int out_bf16, void* stream) {
  const int chunk = in_bf16 ? 256 : 128;
  if (nlev < 1 || nlev > kMaxLevels || c % chunk != 0 || c < chunk ||
      kk < 1 || form < -1 || form > 1)
    return (int)cudaErrorInvalidValue;
  if (npix == 0) return 0;
  Args a = plan(w1, w2cat, c, kk, nlev, offsets, widths);
  a.f1 = f1;
  a.f2 = f2;
  a.taps = taps;
  a.out = out;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long rows = npix / w1;
  using bf16 = __nv_bfloat16;
  if (in_bf16 && out_bf16) return launch<bf16, bf16>(a, rows, form, s);
  if (in_bf16) return launch<bf16, float>(a, rows, form, s);
  if (out_bf16) return launch<float, bf16>(a, rows, form, s);
  return launch<float, float>(a, rows, form, s);
}

// fmap1 (rows, W1, C), f2cat (rows, W2cat, C), fp32 (in_bf16 = 0) or bf16
// (in_bf16 = 1); taps (rows, W1, nlev*kk) fp32, level-major, each level's
// local coordinates; out (rows, W1, nlev*kk), fp32 (out_bf16 = 0) or bf16;
// all contiguous, the fmaps 16-byte aligned.  C must be a multiple of 128
// (fp32) or 256 (bf16); nlev <= 8; W2cat = sum(widths).  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int alt_corr_taps_forward(const void* f1, const void* f2,
                                     const float* taps, void* out, long npix,
                                     int w1, int w2cat, int c, int kk,
                                     float scale, int nlev, const int* offsets,
                                     const int* widths, int in_bf16,
                                     int out_bf16, void* stream) {
  return alt_corr_taps_forward_as(-1, f1, f2, taps, out, npix, w1, w2cat, c,
                                  kk, scale, nlev, offsets, widths, in_bf16,
                                  out_bf16, stream);
}
