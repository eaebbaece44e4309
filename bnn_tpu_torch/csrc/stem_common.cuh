// The fused stem's arithmetic for one output, shared by fused_stem.cu and
// fused_stem_chain.cu so that both kernels give the same bits whatever
// their tiling:
//
//   acc = 0; for ky, kx, c, in that order: acc = fmaf(x, w, acc)
//   v   = fmaxf(acc + bias, 0)             (relu of the biased conv)
//   out = max of v over the 3x3/s2/p1 pool window (-inf outside the map)
#pragma once

#include <cuda_runtime.h>

namespace stem {

constexpr int KS = 7;  // conv kernel extent

__device__ __forceinline__ float lane(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// One tap (ky, kx) for P conv positions x J output channels: xin[q] holds
// the C input channels of position q under this tap, w[c][j] the weights.
template <int C, int P, int J>
__device__ __forceinline__ void tap(float (&acc)[P][J], const float4 (&xin)[P],
                                    const float (&w)[C][J]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const float xv = lane(xin[q], c);
#pragma unroll
      for (int j = 0; j < J; ++j) acc[q][j] = fmaf(xv, w[c][j], acc[q][j]);
    }
  }
}

// relu(conv + bias): the value the pool takes at a position inside the map
__device__ __forceinline__ float relu_bias(float acc, float bias) {
  return fmaxf(acc + bias, 0.f);
}

}  // namespace stem
