// Fused finest-level GRU update for Hopper (sm_90a), fp32, NHWC.
//
// Replaces the TPU kernel raftstereo_tpu/ops/pallas_gru.py
// `_gru_update_kernel`, launched from `_fused_forward`.  Function (the
// same as `_xla_reference_update` there), per pixel of the finest level:
//   c1  = relu(conv1x1(corr) + bc1)                       64 channels
//   cor = relu(conv3x3(c1) + bc2)                         64
//   f1  = relu(conv7x7(disp) + bf1)                       64 (x-flow only)
//   flo = relu(conv3x3(f1) + bf2)                         64
//   me  = relu(conv3x3(cor) + conv3x3(flo) + bme)         126
//   motion features mf = [me, disp, 0]                    128
//   zr  = conv3x3([h | mf | ext]) + bzr                   2*hd
//   z = sigmoid(zr[:hd] + cz), r = sigmoid(zr[hd:] + cr)
//   q   = tanh(conv3x3([r*h | mf | ext]) + bq + cq)
//   h'  = (1 - z) * h + z * q
//   delta = conv3x3(relu(conv3x3(h') + bfh1)) + bfh2      2
// All convs are zero-padded ("SAME"), so every intermediate is exactly 0
// outside the image.  The [h | mf | ext] concatenations never exist: each
// conv sums one product per (operand, weight slice), the in-kernel form of
// models/update.py `_sliced_conv`.  mf enters as two operands, me (126
// channels) and disp (1 channel); its zero y-flow channel multiplies
// nothing and is dropped.
//
// Design.  One tiled direct-convolution kernel, an implicit GEMM of
// pixels x output channels with the reduction K flattened over (operand,
// tap, input channel), so a 1-channel or 126-channel operand wastes no
// reduction steps: 128-pixel x 128- (or 64-) channel output tiles, 8-deep
// K stages double-buffered in shared memory (the next stage's global
// loads are in flight while the current one is multiplied), 8x8 (or 8x4)
// fp32 FMA outputs per thread, and the bias + relu or the GRU blend as
// its epilogue.  The 2-channel flow-head output, which would waste most
// of a tile, has its own kernel: one warp per pixel, weights in shared
// memory, a shuffle reduction.  r*h is one elementwise kernel.  Ten
// launches per update (eight convs, the reset gate, the flow-head
// output); intermediates live in a workspace in device memory.  Keeping them on chip, as the TPU kernel does in VMEM, is
// later work.
//
// Bound on an H100 SXM (67 TFLOP/s fp32 outside the tensor cores,
// 3.35 TB/s): at 144x240 with hd=128 the update is about 128 GFLOP
// (zr 61, q 31, flow-head conv1 20, motion convs 16) against about 130 MB
// of inputs and outputs, so it is bound by operations, about 2 ms.
// TF32 would lift that bound but is not used: the fp32 path is the one
// held to the JAX package.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 128;  // pixels per tile
constexpr int BK = 8;    // reduction depth per shared-memory stage
constexpr int kThreads = 256;
constexpr int kMaxOps = 4;
constexpr int kApad = 4;  // As row padding: conflict-free staging stores

enum Epilogue { kBias = 0, kRelu = 1, kGruBlend = 2 };

struct Operand {
  const float* x;  // (B, H, W, cin) NHWC
  const float* w;  // (ks*ks*cin, cout): [tap][cin][cout], tap = ky*ks + kx
  int cin;
  int ks;
  int nchunk;      // ceil(ks*ks*cin / BK)
};

struct ConvParams {
  Operand op[kMaxOps];
  int nops;
  const float* bias;  // (cout)
  float* y;           // (B, H, W, cout)
  int cout;
  int B, H, W;
  int epi;
  // kGruBlend: y = (1-z)*h + z*tanh(acc + bias + cq),
  // z = sigmoid(zr[:, :cout] + cz); zr has 2*cout channels.
  const float* zr;
  const float* cz;
  const float* cq;
  const float* h;
};

__device__ __forceinline__ float sigmoidf_(float v) {
  return 1.f / (1.f + expf(-v));
}

// Bias + relu or the GRU blend, then the store of output (m, n).
__device__ __forceinline__ void finish(const ConvParams& p, long m, int n,
                                       float acc) {
  float v = acc + p.bias[n];
  if (p.epi == kRelu) {
    v = fmaxf(v, 0.f);
  } else if (p.epi == kGruBlend) {
    const long e = m * p.cout + n;
    const float z = sigmoidf_(p.zr[m * 2 * p.cout + n] + p.cz[e]);
    const float q = tanhf(v + p.cq[e]);
    v = (1.f - z) * p.h[e] + z * q;
  }
  p.y[m * p.cout + n] = v;
}

__device__ __forceinline__ Operand pick(const ConvParams& p, int o) {
  return o == 0 ? p.op[0] : o == 1 ? p.op[1] : o == 2 ? p.op[2] : p.op[3];
}

template <int BN>
__global__ void __launch_bounds__(kThreads, BN == 64 ? 3 : 2)
conv_nhwc_kernel(ConvParams p) {
  constexpr int TN = BN / 16;               // outputs per thread along n
  constexpr int NG = TN / 4;                // float4 groups along n
  constexpr int B_PER = BK * BN / kThreads; // weight loads per thread
  constexpr int B_KSTEP = kThreads / BN;
  __shared__ __align__(16) float As[2][BK][BM + kApad];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int tid = threadIdx.x;
  const long P = (long)p.B * p.H * p.W;
  const long m0 = (long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // Input staging: thread loads reduction index a_k of pixels a_m + 32*i.
  const int a_k = tid & (BK - 1);
  const int a_m = tid / BK;
  int pb[4], py[4], px[4];
  bool pv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long m = m0 + a_m + 32 * i;
    pv[i] = m < P;
    const long mm = pv[i] ? m : 0;
    px[i] = (int)(mm % p.W);
    py[i] = (int)((mm / p.W) % p.H);
    pb[i] = (int)(mm / ((long)p.W * p.H));
  }
  // Weight staging: thread loads column b_n of rows b_k + B_KSTEP*i.
  const int b_n = tid % BN;
  const int b_k = tid / BN;
  // Compute: pixels {ty*4, 64 + ty*4} + 0..3, channels g*64 + tx*4 + 0..3.
  const int tx = tid & 15;
  const int ty = tid >> 4;

  int total = 0;
  for (int o = 0; o < p.nops; ++o) total += pick(p, o).nchunk;

  float ra[4], rb[B_PER];
  auto load = [&](int c) {
    int o = 0;
    Operand op = pick(p, 0);
    while (c >= op.nchunk) {
      c -= op.nchunk;
      op = pick(p, ++o);
    }
    const int K = op.ks * op.ks * op.cin;
    const int k = c * BK + a_k;
    const bool kv = k < K;
    const int tap = kv ? k / op.cin : 0;
    const int ci = k - tap * op.cin;
    const int dy = tap / op.ks - op.ks / 2;
    const int dx = tap % op.ks - op.ks / 2;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int yy = py[i] + dy, xx = px[i] + dx;
      const bool ok = kv && pv[i] && yy >= 0 && yy < p.H && xx >= 0 &&
                      xx < p.W;
      ra[i] = ok ? op.x[(((long)pb[i] * p.H + yy) * p.W + xx) * op.cin + ci]
                 : 0.f;
    }
    const int n = n0 + b_n;
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int kb = c * BK + b_k + B_KSTEP * i;
      rb[i] = (kb < K && n < p.cout) ? op.w[(long)kb * p.cout + n] : 0.f;
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[buf][a_k][a_m + 32 * i] = ra[i];
#pragma unroll
    for (int i = 0; i < B_PER; ++i) Bs[buf][b_k + B_KSTEP * i][b_n] = rb[i];
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  load(0);
  stage(0);
  __syncthreads();
  for (int c = 0; c < total; ++c) {
    const int cur = c & 1;
    if (c + 1 < total) load(c + 1);  // in flight during the multiply
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[cur][k][64 + ty * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[TN];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 bv =
            *reinterpret_cast<const float4*>(&Bs[cur][k][g * 64 + tx * 4]);
        b[g * 4 + 0] = bv.x;
        b[g * 4 + 1] = bv.y;
        b[g * 4 + 2] = bv.z;
        b[g * 4 + 3] = bv.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (c + 1 < total) stage(cur ^ 1);  // last read of that buffer was c-1
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (m >= P) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + (j / 4) * 64 + tx * 4 + (j % 4);
      if (n >= p.cout) continue;
      finish(p, m, n, acc[i][j]);
    }
  }
}

// 3x3 SAME conv to CO (few) output channels: one warp per pixel, lanes
// split the input channels, weights in shared memory, shuffle reduction.
constexpr int kSmallWarps = 8;
constexpr int kSmallPixPerWarp = 8;

template <int CO>
__global__ void __launch_bounds__(32 * kSmallWarps)
conv3x3_few_out_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ bias, float* __restrict__ y,
                       int B, int H, int W, int cin) {
  extern __shared__ float ws[];  // (9*cin, CO)
  for (int i = threadIdx.x; i < 9 * cin * CO; i += blockDim.x) ws[i] = w[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long P = (long)B * H * W;
  const long base =
      ((long)blockIdx.x * kSmallWarps + (threadIdx.x >> 5)) * kSmallPixPerWarp;
  for (int r = 0; r < kSmallPixPerWarp; ++r) {
    const long m = base + r;
    if (m >= P) break;  // warp-uniform
    const int xx0 = (int)(m % W);
    const int yy0 = (int)((m / W) % H);
    const int bb = (int)(m / ((long)W * H));
    float s[CO];
#pragma unroll
    for (int o = 0; o < CO; ++o) s[o] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      const int yy = yy0 + tap / 3 - 1, xx = xx0 + tap % 3 - 1;
      if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
      const float* src = x + (((long)bb * H + yy) * W + xx) * cin;
      const float* wt = ws + tap * cin * CO;
      for (int c = lane; c < cin; c += 32) {
        const float v = src[c];
#pragma unroll
        for (int o = 0; o < CO; ++o) s[o] = fmaf(v, wt[c * CO + o], s[o]);
      }
    }
#pragma unroll
    for (int o = 0; o < CO; ++o) {
#pragma unroll
      for (int d = 16; d > 0; d >>= 1)
        s[o] += __shfl_xor_sync(0xffffffffu, s[o], d);
    }
    if (lane == 0) {
#pragma unroll
      for (int o = 0; o < CO; ++o) y[m * CO + o] = s[o] + bias[o];
    }
  }
}

// rh = sigmoid(zr[:, hd:] + cr) * h, elementwise over (P, hd).
__global__ void reset_gate_kernel(const float* __restrict__ zr,
                                  const float* __restrict__ cr,
                                  const float* __restrict__ h,
                                  float* __restrict__ rh, long n, int hd) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long m = i / hd;
  const int c = (int)(i % hd);
  rh[i] = sigmoidf_(zr[m * 2 * hd + hd + c] + cr[i]) * h[i];
}

int conv(ConvParams& p, cudaStream_t s) {
  const long P = (long)p.B * p.H * p.W;
  const unsigned gx = (unsigned)((P + BM - 1) / BM);
  if (p.cout > 64)
    conv_nhwc_kernel<128><<<dim3(gx, (p.cout + 127) / 128), kThreads, 0, s>>>(p);
  else
    conv_nhwc_kernel<64><<<dim3(gx, (p.cout + 63) / 64), kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

ConvParams make(int B, int H, int W, float* y, int cout, const float* bias,
                int epi) {
  ConvParams p = {};
  p.B = B;
  p.H = H;
  p.W = W;
  p.y = y;
  p.cout = cout;
  p.bias = bias;
  p.epi = epi;
  return p;
}

void add(ConvParams& p, const float* x, const float* w, int cin, int ks) {
  p.op[p.nops++] = Operand{x, w, cin, ks, (ks * ks * cin + BK - 1) / BK};
}

constexpr int kMotion = 64;   // convc1/convc2/convf1/convf2 widths
constexpr int kMe = 126;      // merge-conv outputs (128 minus the flow)
constexpr int kHead = 256;    // flow-head hidden width
constexpr int kDelta = 2;     // flow-head outputs

}  // namespace

// Weight-pointer order of `w`, shared with ops/cuda_gru.py WEIGHT_ORDER:
//  0 wc1   1 bc1   2 wc2   3 bc2   4 wf1   5 bf1   6 wf2   7 bf2
//  8 wme_c 9 wme_f 10 bme
// 11 wzr_h 12 wzr_m 13 wzr_d 14 wzr_e 15 bzr
// 16 wq_h  17 wq_m  18 wq_d  19 wq_e  20 bq
// 21 wfh1  22 bfh1  23 wfh2  24 bfh2
// (wzr_e / wq_e are null when ext_dim == 0.)
// Floats of the workspace `ws` that gru_update_forward needs for its
// intermediates.
extern "C" long gru_update_workspace_floats(int B, int H, int W, int hd) {
  return (long)B * H * W * (3 * kMotion + kMe + 3 * hd + kHead);
}

// Returns the first nonzero CUDA error code of the launches, else 0.
extern "C" int gru_update_forward(const float* h, const float* ext,
                                  const float* corr, const float* disp,
                                  const float* cz, const float* cr,
                                  const float* cq, const float* const* w,
                                  float* hn, float* delta, float* ws, int B,
                                  int H, int W, int hd, int ext_dim,
                                  int corr_ch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long P = (long)B * H * W;
  if (P == 0) return 0;
  float* t0 = ws;
  float* t1 = t0 + P * kMotion;
  float* t2 = t1 + P * kMotion;
  float* me = t2 + P * kMotion;
  float* zr = me + P * kMe;
  float* rh = zr + P * 2 * hd;
  float* fh = rh + P * hd;
  int rc;

  ConvParams c1 = make(B, H, W, t0, kMotion, w[1], kRelu);
  add(c1, corr, w[0], corr_ch, 1);
  if ((rc = conv(c1, s))) return rc;
  ConvParams c2 = make(B, H, W, t1, kMotion, w[3], kRelu);
  add(c2, t0, w[2], kMotion, 3);
  if ((rc = conv(c2, s))) return rc;  // t1 = cor
  ConvParams f1 = make(B, H, W, t0, kMotion, w[5], kRelu);
  add(f1, disp, w[4], 1, 7);
  if ((rc = conv(f1, s))) return rc;  // t0 = f1
  ConvParams f2 = make(B, H, W, t2, kMotion, w[7], kRelu);
  add(f2, t0, w[6], kMotion, 3);
  if ((rc = conv(f2, s))) return rc;  // t2 = flo
  ConvParams m = make(B, H, W, me, kMe, w[10], kRelu);
  add(m, t1, w[8], kMotion, 3);
  add(m, t2, w[9], kMotion, 3);
  if ((rc = conv(m, s))) return rc;

  ConvParams g = make(B, H, W, zr, 2 * hd, w[15], kBias);
  add(g, h, w[11], hd, 3);
  add(g, me, w[12], kMe, 3);
  add(g, disp, w[13], 1, 3);
  if (ext_dim) add(g, ext, w[14], ext_dim, 3);
  if ((rc = conv(g, s))) return rc;

  const long n = P * hd;
  reset_gate_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(zr, cr, h,
                                                               rh, n, hd);
  if ((rc = (int)cudaGetLastError())) return rc;

  ConvParams q = make(B, H, W, hn, hd, w[20], kGruBlend);
  add(q, rh, w[16], hd, 3);
  add(q, me, w[17], kMe, 3);
  add(q, disp, w[18], 1, 3);
  if (ext_dim) add(q, ext, w[19], ext_dim, 3);
  q.zr = zr;
  q.cz = cz;
  q.cq = cq;
  q.h = h;
  if ((rc = conv(q, s))) return rc;

  ConvParams h1 = make(B, H, W, fh, kHead, w[22], kRelu);
  add(h1, hn, w[21], hd, 3);
  if ((rc = conv(h1, s))) return rc;

  const long pix_per_block = (long)kSmallWarps * kSmallPixPerWarp;
  const size_t smem = sizeof(float) * 9 * kHead * kDelta;
  conv3x3_few_out_kernel<kDelta>
      <<<(unsigned)((P + pix_per_block - 1) / pix_per_block),
         32 * kSmallWarps, smem, s>>>(fh, w[23], w[24], delta, B, H, W,
                                      kHead);
  return (int)cudaGetLastError();
}
