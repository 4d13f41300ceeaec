// Precomputed-volume correlation lookup for Hopper (sm_90a), over an fp32
// or a bf16 volume pyramid, fp32 out.
//
// Replaces the TPU kernel raftstereo_tpu/ops/pallas_corr.py
// `_lookup_kernel`, launched from `_lookup_fwd_impl` (the `pallas`
// backend's per-iteration lookup over the W2-concatenated volume
// pyramid).  Function: for every pixel p = (b, y, x1), level l and tap
// k = 0..2r, with the level-0 coordinate x and t = x * 2^-l + (k - r),
//   out[p, l*K + k] = sum_j vol_l[p, j] * max(0, 1 - |j - t|)
// over the level's real columns j = 0..w_l-1, K = 2r+1.  The hat weight
// is nonzero at j = floor(t) and floor(t)+1 only, so
//   out = [f in level] vol_l[p, f] * (1 - |f - t|)
//       + [f+1 in level] vol_l[p, f+1] * (1 - |f+1 - t|),  f = floor(t);
// columns outside [0, w_l - 1] give 0.  A NaN coordinate makes every hat
// weight NaN, so it gives NaN (a level of width 0 gives 0, an empty sum).
// Each product and the sum are rounded once (__fmul_rn, __fadd_rn, no
// FMA contraction): the kernel computes the plain version's arithmetic
// bit for bit.  A bf16 volume (the `pallas` backend at corr_dtype bf16,
// and the int8 tier's volume) is read as bf16 and widened to fp32, which
// is exact; the sum is fp32 and so is the output, as the TPU kernel's
// (`vol_ref[...].astype(jnp.float32)`, an fp32 `out_shape`).
//
// Design.  The TPU kernel reduces each tap over the whole (lane-padded)
// W2 row with the dense hat weight, because its vector unit has no
// gather.  Here the work is per (pixel, level) item, not per output: a
// thread owns one (pixel, level) item, loads the pixel's x and reads the
// level's window, the columns [floor(t_0), floor(t_{K-1}) + 1], into
// registers: 16-byte loads from the 16-byte-aligned address at or below
// the window (the rows are not aligned: W2cat is 450 at serving), scalar
// loads for a chunk that reaches past the level, and only the chunks the
// window touches, all issued before the first is used.  A chunk holds 4
// fp32 columns or 8 bf16 ones, so a window of K+2 = 11 columns (44 bytes
// in fp32, 22 in bf16) touches 3 or 4 chunks in fp32 and 2 or 3 in bf16;
// the window's shift within its first chunk (0..3 or 0..7) is undone in
// registers, by a select chain in fp32 and in bf16 by a barrel shifter of
// 3 stages (shift by 4, 2, 1), both at compile-time indices.  Each tap then
// takes its two columns from the window by its own floor: floor(t_k) -
// floor(t_0) is k, or k +- 1 where the rounded taps cross an integer (x =
// 127.99999 at level 0 rounds t_5 to 129.0; rounding never lowers a floor
// below 2^24, where every integer is a float), so the window takes up to
// K+2 columns, as row 6's `KW`, and each tap selects its pair among three
// at compile-time register indices.  A window that reaches 2^24 (where
// f + 1 rounds back to f in the plain version's float arithmetic; on a
// level that wide) or misses the level reads each tap's two columns from
// global memory, the per-tap form, in the same kernel; so does every tap
// at a radius above kMaxWindowRadius (the window is sized at compile time,
// one instance per radius up to it).  The block's outputs, a contiguous
// run of its pixels' L*K values each, are staged in shared memory and
// written as 16-byte coalesced stores.  The level table goes to shared
// memory by compile-time indices, so it never lands in local memory.
//
// Bound on an H100 SXM (3.35 TB/s): at the serving shape (144x240
// pixels, 4 levels of radius 4, level widths 240/120/60/30) the function
// needs the taps' columns of the volume (at most K+1 = 10 per pixel and
// level, about 5.5 MB in fp32, 2.8 MB in bf16), x and the output (5 MB):
// about 11 MB, 3 us, or 8 MB, 2.3 us, over a bf16 volume; at the training
// shape (6x80x180) about 27 MB, 8 us.  Its arithmetic is a
// few operations per output, so it is bound by bytes.  The volume (62 MB
// at serving, 116 MB at training) does not stay in the 50 MB L2, and a
// window's 40 bytes come in 32-byte sectors: the design reads no sector
// the window does not touch and each column once, with its loads in
// flight together, where the first form issued two dependent 4-byte loads
// per output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;        // one (pixel, level) item a thread
constexpr int kMaxWindowRadius = 4;  // radii with a register window
constexpr int kStageBudget = 48 * 1024;

struct Levels {
  int n;
  int off[kMaxLevels];    // first column of level l in the concatenated W2
  int width[kMaxLevels];  // real width w_l of level l
};

// Volume columns per 16-byte chunk.
template <typename T>
constexpr int kPerChunk = 16 / (int)sizeof(T);

// One volume value, widened to fp32 (exact for bf16: its bits, shifted).
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __uint_as_float(
      (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// The 16-byte chunk at p into win[at .. at + kPerChunk - 1], widened.
template <int N>
__device__ __forceinline__ void load_chunk(float (&win)[N], int at,
                                           const float* p) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  win[at] = v.x;
  win[at + 1] = v.y;
  win[at + 2] = v.z;
  win[at + 3] = v.w;
}
template <int N>
__device__ __forceinline__ void load_chunk(float (&win)[N], int at,
                                           const __nv_bfloat16* p) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    win[at + 2 * j] = __uint_as_float(u[j] << 16);
    win[at + 2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
  }
}

// win[j] = win[j + B] for every j where `on`: one stage of the barrel
// shifter, at compile-time indices so the window stays in registers.
template <int B, int N>
__device__ __forceinline__ void shift_down(float (&win)[N], bool on) {
#pragma unroll
  for (int j = 0; j + B < N; ++j) win[j] = on ? win[j + B] : win[j];
}

// One tap's value from its two columns va (at fa = floor(t)) and vb (at
// fa + 1), each weighted only where it lies in [0, last].
__device__ __forceinline__ float tap_value(float t, float fa, float va,
                                           float vb, float last) {
  const float fb = fa + 1.f;
  float p0 = 0.f, p1 = 0.f;
  if (fa >= 0.f && fa <= last) p0 = __fmul_rn(va, 1.f - fabsf(fa - t));
  if (fb >= 0.f && fb <= last) p1 = __fmul_rn(vb, 1.f - fabsf(fb - t));
  return __fadd_rn(p0, p1);
}

// The per-tap form: the tap's two columns read from global memory (false
// tests, NaN and +-inf included, read nothing).
template <typename T>
__device__ __forceinline__ float tap_global(const T* vol, long rowe, float t,
                                           float last) {
  const float fa = floorf(t), fb = fa + 1.f;
  float va = 0.f, vb = 0.f;
  if (fa >= 0.f && fa <= last) va = load1(vol + rowe + (long)fa);
  if (fb >= 0.f && fb <= last) vb = load1(vol + rowe + (long)fb);
  return tap_value(t, fa, va, vb, last);
}

// T: the volume's element (float or __nv_bfloat16).  KC = K = 2r+1 for the
// windowed instances, 0 for the per-tap form at any radius.
template <typename T, int KC>
__global__ void __launch_bounds__(kThreads)
corr_vol_kernel(const T* __restrict__ vol, const float* __restrict__ x,
                float* __restrict__ out, long npix, int w2cat, int radius,
                int pix_per_block, Levels lv) {
  extern __shared__ __align__(16) float stage[];  // [np][L*K]
  __shared__ int s_off[kMaxLevels], s_width[kMaxLevels];
  constexpr int KW = KC + 2;                // window columns
  constexpr int P = kPerChunk<T>;
  // chunks covering the window at any shift
  constexpr int NQ = (KW + P - 1 + P - 1) / P;
  const int L = lv.n;
  const int K = KC > 0 ? KC : 2 * radius + 1;
  const int LK = L * K;
  const long p0 = (long)blockIdx.x * pix_per_block;
  const int np = (int)min((long)pix_per_block, npix - p0);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      s_off[l] = lv.off[l];
      s_width[l] = lv.width[l];
    }
  }
  __syncthreads();

  // This thread's item: pixel p0 + i / L, level i % L.
  const int i = threadIdx.x;
  if (i < np * L) {
    const int l = i % L;
    const int width = s_width[l];
    const float last = (float)(width - 1);
    const long rowe = (p0 + i / L) * (long)w2cat + s_off[l];
    const float xl = __fmul_rn(x[p0 + i / L], 1.0f / (float)(1 << l));
    float* o = stage + i * K;               // x * 2^-l above is exact
    if (width == 0) {
      for (int k = 0; k < K; ++k) o[k] = 0.f;
    } else if (isnan(xl)) {
      for (int k = 0; k < K; ++k) o[k] = NAN;
    } else if constexpr (KC > 0) {
      const float f0 = floorf(__fadd_rn(xl, (float)(-radius)));
      const float fe = floorf(__fadd_rn(xl, (float)radius)) + 1.f;
      // The window [f0, fe] meets the level and lies below 2^24, where
      // each column f + 1 is the float the plain version forms (false for
      // +-inf).
      const bool have =
          f0 >= (float)(1 - KW) && f0 <= last && fe < 16777216.f;
      // win[j] = column f0 + j - shift where it lies in the level, read
      // in the 16-byte chunks the window touches.
      float win[P * NQ];
#pragma unroll
      for (int j = 0; j < P * NQ; ++j) win[j] = 0.f;
      int shift = 0;
      if (have) {
        const int c0 = (int)f0, span = (int)(fe - f0), cw = width - 1;
        const long e0 = rowe + c0;
        shift = (int)(((uintptr_t)vol / sizeof(T) + e0) & (P - 1));
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          if (P * q > shift + span) break;   // past the window
          const int ca = c0 - shift + P * q;   // the chunk's first column
          if (ca >= 0 && ca + P - 1 <= cw) {
            load_chunk(win, P * q, vol + e0 - shift + P * q);
          } else {
#pragma unroll
            for (int j = 0; j < P; ++j)
              if (ca + j >= 0 && ca + j <= cw)
                win[P * q + j] = load1(vol + e0 - shift + P * q + j);
          }
        }
      }
      // w[j] = column f0 + j
      float w[KW];
      if constexpr (P == 4) {
#pragma unroll
        for (int j = 0; j < KW; ++j)
          w[j] = shift == 0 ? win[j]
               : shift == 1 ? win[j + 1]
               : shift == 2 ? win[j + 2] : win[j + 3];
      } else {
        // shift 0..7 undone in three stages: by 4, by 2, by 1
        shift_down<4>(win, (shift & 4) != 0);
        shift_down<2>(win, (shift & 2) != 0);
        shift_down<1>(win, (shift & 1) != 0);
#pragma unroll
        for (int j = 0; j < KW; ++j) w[j] = win[j];
      }
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const float t = __fadd_rn(xl, (float)(k - radius));
        const float fa = floorf(t);
        const float d = fa - f0;   // k - 1, k or k + 1 in a window
        float v;
        if (have && d == (float)k) {
          v = tap_value(t, fa, w[k], w[k + 1], last);
        } else if (have && d == (float)(k + 1)) {
          v = tap_value(t, fa, w[k + 1], w[k + 2], last);
        } else if (k > 0 && have && d == (float)(k - 1)) {
          v = tap_value(t, fa, w[k > 0 ? k - 1 : 0], w[k], last);
        } else {
          v = tap_global(vol, rowe, t, last);
        }
        o[k] = v;
      }
    } else {
      // The per-tap form at any radius.
      for (int k = 0; k < K; ++k)
        o[k] = tap_global(vol, rowe, __fadd_rn(xl, (float)(k - radius)),
                          last);
    }
  }
  __syncthreads();

  // The block's run of np * L*K outputs: 16-byte stores where the run and
  // the stage line up (the run starts 16-byte aligned when `out` does:
  // pix_per_block is a multiple of 4), scalar ones otherwise.
  float* run = out + p0 * LK;
  const int n = np * LK;
  if ((((uintptr_t)run) & 15) == 0) {
    const int nvec = n >> 2;
    for (int q = threadIdx.x; q < nvec; q += kThreads)
      reinterpret_cast<float4*>(run)[q] =
          reinterpret_cast<const float4*>(stage)[q];
    for (int e = 4 * nvec + threadIdx.x; e < n; e += kThreads)
      run[e] = stage[e];
  } else {
    for (int e = threadIdx.x; e < n; e += kThreads) run[e] = stage[e];
  }
}

template <typename T, int KC>
int launch(const T* vol, const float* x, float* out, long npix, int w2cat,
           int radius, const Levels& lv, cudaStream_t stream) {
  const int lk = lv.n * (2 * radius + 1);
  // Pixels per block: a multiple of 4, one item a thread, their outputs
  // within the stage budget.
  int pix = (kThreads / lv.n) & ~3;
  while (pix > 4 && (long)pix * lk * (long)sizeof(float) > kStageBudget)
    pix -= 4;
  const long blocks = (npix + pix - 1) / pix;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  corr_vol_kernel<T, KC><<<(unsigned)blocks, kThreads,
                           (size_t)pix * lk * sizeof(float), stream>>>(
      vol, x, out, npix, w2cat, radius, pix, lv);
  return (int)cudaGetLastError();
}

template <typename T>
int forward(const T* vol, const float* x, float* out, long npix, int w2cat,
            int radius, int nlev, const int* offsets, const int* widths,
            void* stream) {
  if (nlev < 1 || nlev > kMaxLevels || radius < 0 || radius > 64)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  lv.n = nlev;
  for (int l = 0; l < kMaxLevels; ++l) {
    lv.off[l] = l < nlev ? offsets[l] : 0;
    lv.width[l] = l < nlev ? widths[l] : 0;
  }
  if (npix == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  static_assert(kMaxWindowRadius == 4, "one instance per windowed radius");
  switch (radius) {
    case 0: return launch<T, 1>(vol, x, out, npix, w2cat, radius, lv, s);
    case 1: return launch<T, 3>(vol, x, out, npix, w2cat, radius, lv, s);
    case 2: return launch<T, 5>(vol, x, out, npix, w2cat, radius, lv, s);
    case 3: return launch<T, 7>(vol, x, out, npix, w2cat, radius, lv, s);
    case 4: return launch<T, 9>(vol, x, out, npix, w2cat, radius, lv, s);
    default: return launch<T, 0>(vol, x, out, npix, w2cat, radius, lv, s);
  }
}

}  // namespace

// vol (npix, w2cat): the volume pyramid concatenated along W2 at its real
// level widths; x (npix,): level-0 coordinates; out (npix,
// nlev*(2*radius+1)).  All fp32 and contiguous, vol 4-byte aligned.
// radius 0..64, nlev 1..8, widths summing to w2cat.  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int corr_vol_forward(const float* vol, const float* x, float* out,
                                long npix, int w2cat, int radius, int nlev,
                                const int* offsets, const int* widths,
                                void* stream) {
  return forward(vol, x, out, npix, w2cat, radius, nlev, offsets, widths,
                 stream);
}

// The same over a bf16 volume pyramid (2-byte aligned); x and out fp32.
extern "C" int corr_vol_forward_bf16(const void* vol, const float* x,
                                     float* out, long npix, int w2cat,
                                     int radius, int nlev, const int* offsets,
                                     const int* widths, void* stream) {
  return forward(static_cast<const __nv_bfloat16*>(vol), x, out, npix, w2cat,
                 radius, nlev, offsets, widths, stream);
}
