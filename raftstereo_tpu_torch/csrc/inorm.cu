// Stand-alone instance norm (no affine, eps 1e-5), with an optional fused
// relu, for Hopper (sm_90a): NCHW, fp32 or bf16.  Replaces
// raftstereo_tpu/ops/pallas_norm.py `_in_stats_kernel` (launched at
// pallas_norm.py:90, with the few (B, C) operations that follow it in XLA)
// and `_in_apply_kernel` (launched at :115).  Function, per (image,
// channel) plane of n = H*W values:
//   fp32 sums s1 of x and s2 of x^2; mean = s1 / n,
//   var = max(s2 / n - mean^2, 0) (NaN kept), rstd = 1 / sqrt(var + 1e-5);
//   y = (x - mean) * rstd with mean and rstd cast to x's dtype first, then
//   relu if asked, in x's dtype (in bf16 every operation rounds to bf16,
//   as XLA's bf16 arithmetic does).
// Every fp32 operation of the epilogue and of the apply rounds once
// (__fmul_rn and friends keep nvcc from contracting them into FMAs), so the
// results follow the plain version's arithmetic; only the order of the
// plane sums differs.  A NaN input gives NaN, as jnp.maximum and relu
// propagate it.
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  The function reads x once and
// writes y once: at 2x64x288x480 fp32 (fnet's first norm at a 576x960
// bucket) 70.8 MB each way, 0.042 ms; at the recipe's 12x64x160x360 fp32
// 177 MB each way, 0.106 ms; about 5 FLOPs per element.
//
// Design: two forms, chosen by the plane's size (the wrapper's
// `cluster_plan`), both with a fixed order of summation, so two calls give
// equal bits.
// * The cluster form (`inorm_cluster_kernel`, one launch): one thread-block
//   cluster per plane, the plane split into equal contiguous slices, one
//   per block; the cluster takes the fewest blocks (1, 2, 4, 8 or 16) whose
//   slice is at most 72 KB (three blocks an SM), else 16 blocks of up to
//   224 KB.  A block loads its slice into shared memory by one bulk copy
//   (`cp.async.bulk` onto an mbarrier; scalar loads where the plane is not
//   16-byte aligned), sums it there (per thread over its 16-byte vectors
//   in order, a butterfly per warp, the warps in order), and publishes its
//   (s1, s2); after a cluster barrier every block reads all ranks' sums
//   through distributed shared memory in rank order, so all derive the
//   same mean and rstd, then normalises its slice from shared memory and
//   stores y with 16-byte stores.  x is read from device memory once and
//   y written once: the bound's traffic.  A second cluster barrier, split
//   around the apply, keeps each block's sums alive until its peers have
//   read them.  The launch is refused (an error, never the other form)
//   where no cluster of that shape can be placed on the card.
// * The two-kernel form, for planes above 16 x 224 KB (about 3.6 MB):
//   `inorm_stats_kernel` sums one plane per 256-thread block with 16-byte
//   loads and writes (B, 2, C) mean and rstd; `inorm_apply_kernel` is a
//   streaming pass, one thread per 16 bytes.  Three passes over the tensor
//   instead of two.
// The E[x^2] - mean^2 formula is the TPU kernels' (a centred second pass
// over the slice in shared memory would cost no bytes, but it is another
// function).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;              // the two-kernel form's blocks
constexpr int kClusterThreads = 256;       // the cluster form's blocks
// The cluster form's plan (the wrapper's `cluster_plan` takes the same
// numbers): the fewest blocks a plane, up to kMaxCluster, whose slice
// fits kTargetSliceBytes, else kMaxCluster blocks up to kMaxSliceBytes.
constexpr int kMaxCluster = 16;            // 8 is portable; 16 is allowed
constexpr long kTargetSliceBytes = 73728;  // 72 KB a block: 3 an SM
constexpr long kMaxSliceBytes = 229376;    // 224 KB a block: 1 an SM
constexpr uint32_t kBulkChunk = 65536;     // bytes a bulk copy

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int V = 4;
  using Raw = float4;
  __device__ __forceinline__ static void unpack(const Raw& r, float* v) {
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
  __device__ __forceinline__ static Raw pack(const float* v) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ __forceinline__ static float one(float x) { return x; }
  __device__ __forceinline__ static float put(float v) { return v; }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int V = 8;
  using Raw = uint4;
  __device__ __forceinline__ static void unpack(const Raw& r, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static Raw pack(const float* v) {
    Raw r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i],
                                                            v[2 * i + 1]);
    return r;
  }
  __device__ __forceinline__ static float one(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ __forceinline__ static __nv_bfloat16 put(float v) {
    return __float2bfloat16_rn(v);
  }
};

// Round to the storage dtype and back: bf16 arithmetic rounds each result.
__device__ __forceinline__ float rnd(float v, float) { return v; }
__device__ __forceinline__ float rnd(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A thread's sums of v and v^2 (fmaf) over values in order.
__device__ __forceinline__ void accumulate(float v, float& s, float& q) {
  s += v;
  q = fmaf(v, v, q);
}

// A block's (s, q): a butterfly per warp, then the warps added in order by
// thread 0 (the result is thread 0's).
template <int kWarps>
__device__ __forceinline__ void block_sums(float& s, float& q,
                                           float (&red)[kWarps][2]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, m);
    q += __shfl_xor_sync(0xffffffffu, q, m);
  }
  if (lane == 0) {
    red[warp][0] = s;
    red[warp][1] = q;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    s = 0.f;
    q = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      s += red[w][0];
      q += red[w][1];
    }
  }
}

// mean and rstd of a plane of n values from its fp32 sums.
__device__ __forceinline__ void moments(float s1, float s2, float n,
                                        float& mean, float& rstd) {
  mean = __fdiv_rn(s1, n);
  float var = __fsub_rn(__fdiv_rn(s2, n), __fmul_rn(mean, mean));
  if (!(var >= 0.f) && !isnan(var)) var = 0.f;  // max(var, 0), NaN kept
  rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, 1e-5f)));
}

// (v - m) * s in T's arithmetic (m and s already in T), then relu if asked
// (NaN kept).
template <typename T>
__device__ __forceinline__ float normed(float v, float m, float s, int relu) {
  float r = rnd(__fmul_rn(rnd(__fsub_rn(v, m), T()), s), T());
  if (relu && !(r > 0.f) && !isnan(r)) r = 0.f;
  return r;
}

// ---------------------------------------------------------- PTX helpers

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// Waits for the phase of parity `parity` of barrier `bar` to complete.  A
// copy that never lands traps (an error the caller sees) instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1L << 24)) __trap();
  }
}
// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, completing on barrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ------------------------------------------------------ the cluster form

// Grid: one cluster of cs blocks per plane (blockIdx.x = plane * cs +
// rank).  Rank r holds the plane's values [r * slice, min((r + 1) *
// slice, hw)) in dynamic shared memory; slice is a multiple of the 16-byte
// vector.  vec: hw is a multiple of the vector and x, y are 16-byte
// aligned (bulk copy, 16-byte accesses), else every access is scalar.
template <typename T>
__global__ void __launch_bounds__(kClusterThreads, 3)
inorm_cluster_kernel(const T* __restrict__ x, T* __restrict__ y, long hw,
                     long slice, int relu, int vec) {
  using P = Pack<T>;
  using Raw = typename P::Raw;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[kClusterThreads / 32][2];
  __shared__ float part[2];  // this block's (s1, s2), read by the cluster
  __shared__ float stat[2];  // the plane's mean and rstd
  __shared__ __align__(8) unsigned long long bar;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const long plane = blockIdx.x / cs;
  const long start = rank * slice;
  const long len = start >= hw ? 0 : hw - start < slice ? hw - start : slice;
  const long nv = len / P::V;  // the slice's vectors (vec)
  const T* px = x + plane * hw + start;
  T* py = y + plane * hw + start;
  T* sx = reinterpret_cast<T*>(smem);
  const Raw* sv = reinterpret_cast<const Raw*>(smem);

  // ---- the slice into shared memory
  if (vec) {
    const uint32_t b = (uint32_t)__cvta_generic_to_shared(&bar);
    if (tid == 0) {
      mbar_init(b, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      const uint32_t bytes = (uint32_t)(len * sizeof(T));
      const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
      mbar_expect_tx(b, bytes);
      for (uint32_t o = 0; o < bytes; o += kBulkChunk)
        bulk_load(dst + o, reinterpret_cast<const unsigned char*>(px) + o,
                  bytes - o < kBulkChunk ? bytes - o : kBulkChunk, b);
    }
    mbar_wait(b, 0);
  } else {
    for (long i = tid; i < len; i += kClusterThreads) sx[i] = px[i];
    __syncthreads();
  }

  // ---- this block's sums, then the plane's from every rank in order
  float s = 0.f, q = 0.f;
  if (vec) {
    for (long j = tid; j < nv; j += kClusterThreads) {
      float v[P::V];
      P::unpack(sv[j], v);
#pragma unroll
      for (int k = 0; k < P::V; ++k) accumulate(v[k], s, q);
    }
  } else {
    for (long i = tid; i < len; i += kClusterThreads)
      accumulate(P::one(sx[i]), s, q);
  }
  block_sums(s, q, red);
  if (tid == 0) {
    part[0] = s;
    part[1] = q;
  }
  cluster.sync();  // every rank's sums are in place
  if (tid == 0) {
    float s1 = 0.f, s2 = 0.f;
    for (int r = 0; r < cs; ++r) {
      const float* pr = cluster.map_shared_rank(part, r);
      s1 += pr[0];
      s2 += pr[1];
    }
    moments(s1, s2, (float)hw, stat[0], stat[1]);
  }
  __syncthreads();
  cluster_arrive();  // this block has read its peers' sums

  // ---- normalise the slice from shared memory
  const float m = rnd(stat[0], T()), sd = rnd(stat[1], T());
  if (vec) {
    Raw* yv = reinterpret_cast<Raw*>(py);
    for (long j = tid; j < nv; j += kClusterThreads) {
      float v[P::V];
      P::unpack(sv[j], v);
#pragma unroll
      for (int k = 0; k < P::V; ++k) v[k] = normed<T>(v[k], m, sd, relu);
      yv[j] = P::pack(v);
    }
  } else {
    for (long i = tid; i < len; i += kClusterThreads)
      py[i] = P::put(normed<T>(P::one(sx[i]), m, sd, relu));
  }
  cluster_wait();  // the peers have read this block's sums
}

template <typename T>
int launch_cluster(const void* x, void* y, long planes, long hw, int cs,
                   long slice, int relu, int vec, cudaStream_t st) {
  static int ready_cs = 0;  // the (cluster, bytes) last set and placed
  static size_t ready_smem = 0;
  const size_t smem = (size_t)slice * sizeof(T);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(planes * cs));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (ready_cs != cs || ready_smem != smem) {
    cudaError_t e = cudaFuncSetAttribute(
        inorm_cluster_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e == cudaSuccess && cs > 8)
      e = cudaFuncSetAttribute(inorm_cluster_kernel<T>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    int clusters = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(&clusters, inorm_cluster_kernel<T>,
                                         &cfg);
    if (e != cudaSuccess) return (int)e;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    ready_cs = cs;
    ready_smem = smem;
  }
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, inorm_cluster_kernel<T>, static_cast<const T*>(x),
      static_cast<T*>(y), hw, slice, relu, vec);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// --------------------------------------------------- the two-kernel form

template <typename T>
__global__ void __launch_bounds__(kThreads)
inorm_stats_kernel(const T* __restrict__ x, float* __restrict__ stats, int c,
                   long hw) {
  using P = Pack<T>;
  __shared__ float red[kThreads / 32][2];
  const int ch = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const T* p = x + ((long)b * c + ch) * hw;
  float s = 0.f, q = 0.f;
  if (hw % P::V == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const typename P::Raw* pv = reinterpret_cast<const typename P::Raw*>(p);
    for (long i = tid; i < hw / P::V; i += kThreads) {
      float v[P::V];
      P::unpack(pv[i], v);
#pragma unroll
      for (int k = 0; k < P::V; ++k) accumulate(v[k], s, q);
    }
  } else {
    for (long i = tid; i < hw; i += kThreads) accumulate(P::one(p[i]), s, q);
  }
  block_sums(s, q, red);
  if (tid == 0) {
    float mean, rstd;
    moments(s, q, (float)hw, mean, rstd);
    stats[((long)b * 2) * c + ch] = mean;
    stats[((long)b * 2 + 1) * c + ch] = rstd;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
inorm_apply_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                   T* __restrict__ y, int c, long hw, int relu) {
  using P = Pack<T>;
  const long plane = blockIdx.x;
  const long b = plane / c, ch = plane - b * c;
  const float m = rnd(stats[(b * 2) * c + ch], T());
  const float s = rnd(stats[(b * 2 + 1) * c + ch], T());
  const T* px = x + plane * hw;
  T* py = y + plane * hw;
  const long i0 = ((long)blockIdx.y * kThreads + threadIdx.x) * P::V;
  if (i0 >= hw) return;
  if (hw % P::V == 0 && (reinterpret_cast<uintptr_t>(px) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(py) & 15) == 0) {
    float v[P::V];
    P::unpack(*reinterpret_cast<const typename P::Raw*>(px + i0), v);
#pragma unroll
    for (int k = 0; k < P::V; ++k) v[k] = normed<T>(v[k], m, s, relu);
    *reinterpret_cast<typename P::Raw*>(py + i0) = P::pack(v);
  } else {
    for (long i = i0; i < i0 + P::V && i < hw; ++i)
      py[i] = P::put(normed<T>(P::one(px[i]), m, s, relu));
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// The cluster form.  x and y (B, C, H*W) contiguous, one dtype (fp32, bf16
// = 0, or bf16, bf16 = 1); cs blocks a plane (1, 2, 4, 8 or 16), each
// holding ceil(ceil(hw / cs) / V) * V values (V = 16 bytes of the dtype)
// in at most kMaxSliceBytes of shared memory.  y = instance norm of x,
// then relu when relu = 1.  Returns the CUDA error code of the launch (0
// on success; cudaErrorInvalidConfiguration where no cluster of that
// shape can be placed).
extern "C" int inorm_cluster_forward(const void* x, void* y, int batch,
                                     int c, long hw, int relu, int bf16,
                                     int cs, void* stream) {
  const int esize = bf16 ? 2 : 4, v = 16 / esize;
  if (batch < 1 || c < 1 || hw < 1 || cs < 1 || cs > kMaxCluster ||
      (cs & (cs - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const long slice = ((hw + cs - 1) / cs + v - 1) / v * v;
  if (slice * esize > kMaxSliceBytes || (long)batch * c * cs > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  const int vec = hw % v == 0 && aligned16(x) && aligned16(y);
  const long planes = (long)batch * c;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_cluster<__nv_bfloat16>(x, y, planes, hw, cs, slice, relu,
                                         vec, s);
  return launch_cluster<float>(x, y, planes, hw, cs, slice, relu, vec, s);
}

// The two-kernel form, first launch.  x (B, C, H*W) contiguous, fp32 (bf16
// = 0) or bf16 (bf16 = 1) -> stats (B, 2, C) fp32: per plane the mean,
// then the rstd.  Returns the CUDA error code of the launch (0 on
// success).
extern "C" int inorm_stats_forward(const void* x, float* stats, int batch,
                                   int c, long hw, int bf16, void* stream) {
  if (batch < 1 || c < 1 || hw < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(c, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    inorm_stats_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), stats, c, hw);
  else
    inorm_stats_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), stats, c, hw);
  return (int)cudaGetLastError();
}

// The two-kernel form, second launch.  x and y (B, C, H*W) contiguous, one
// dtype (fp32 or bf16, as above); stats from inorm_stats_forward.  y = (x
// - mean) * rstd, then relu when relu = 1.  Returns the CUDA error code of
// the launch (0 on success).
extern "C" int inorm_apply_forward(const void* x, const float* stats, void* y,
                                   int batch, int c, long hw, int relu,
                                   int bf16, void* stream) {
  const int v = bf16 ? 8 : 4;
  const long chunks = (hw + (long)kThreads * v - 1) / ((long)kThreads * v);
  if (batch < 1 || c < 1 || hw < 1 || chunks > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((long)batch * c), (unsigned)chunks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    inorm_apply_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), stats,
        static_cast<__nv_bfloat16*>(y), c, hw, relu);
  else
    inorm_apply_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), stats, static_cast<float*>(y), c, hw,
        relu);
  return (int)cudaGetLastError();
}
