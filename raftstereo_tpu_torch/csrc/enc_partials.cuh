// The fixed-order reduction of the encoder convs' per-tile output sums
// (enc_conv_tc.cu, enc_conv_wg.cu): partials (B, nb, 2*CH) -> stats (B,
// 2*CH).

#pragma once

#include <cuda_runtime.h>

namespace {

// One warp per output, lanes strided over the tiles, then a butterfly.
// Fixed order: two calls are bitwise equal.
__global__ void __launch_bounds__(256)
enc_conv_tc_stats_kernel(const float* __restrict__ partials,
                         float* __restrict__ stats, int nb, int ch2,
                         int total) {
  const int idx = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (idx >= total) return;  // whole warps exit together
  const int b = idx / ch2, k = idx - b * ch2;
  const float* p = partials + (long)b * nb * ch2 + k;
  float s = 0.f;
  for (int i = lane; i < nb; i += 32) s += p[(long)i * ch2];
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (lane == 0) stats[idx] = s;
}

}  // namespace
