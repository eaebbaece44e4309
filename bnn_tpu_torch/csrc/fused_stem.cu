// Fused ResNet stem, hand-written for Hopper (sm_90a):
//
//   out = maxpool3x3/s2/p1(relu(conv7x7/s2/p3(x, w) + bias))
//
// Replaces bnn_tpu/kernels/stem.py:fused_stem_v3 (and serves the v1 and v2
// entry points, which compute the same function at other geometries). The
// TPU kernels rearrange the image by space-to-depth so the conv becomes one
// MXU contraction; here the conv is a direct convolution, because C <= 4
// input channels give a 7x7xC = 196-deep dot per output that the CUDA cores
// take as it is.
//
// x: (N, H, W, C) NHWC, bf16 or f32, C <= 4, H and W even; w: (7, 7, C, O)
// HWIO f32; bias: (O,) f32; out: (N, H/4, W/4, O) in x's dtype. The sum is
// f32 and the pool's padding is -inf.
//
// Bound on an H100 at (8, 224, 224, 3) bf16 -> (8, 56, 56, 64): 2.4 MB in and
// 3.2 MB out (1.7 us at 3.35 TB/s) against 1.9 GFLOP (1.9 us at the bf16
// tensor-core rate, 28 us at the 67 TFLOP/s f32 CUDA-core rate this kernel
// uses). Design: one block computes a 7x7 tile of pooled outputs for 64
// channels. It stages the 35x35 input window and the 7x7xCx64 weights in
// shared memory, computes the 15x15 conv tile it needs with f32 FMAs (each
// thread owns 4 positions x 8 channels in registers, so a weight load feeds
// 4 FMAs and an input load 8), keeps relu(conv + bias) in shared memory and
// pools from there. The 112x112x64 conv map never reaches device memory:
// device traffic is one read of the input and one write of the output, plus
// the 15/14 overlap of neighbouring tiles' input windows. The per-output
// arithmetic is stem_common.cuh's, which fused_stem_chain.cu shares.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "stem_common.cuh"

namespace {

using stem::KS;                   // conv kernel extent
constexpr int TP = 7;             // pooled rows / cols per block
constexpr int CT = 2 * TP + 1;    // conv rows / cols per block
constexpr int NPOS = CT * CT;     // conv positions per block
constexpr int IT = 4 * TP + 7;    // input rows / cols per block
constexpr int OCB = 64;           // output channels per block
constexpr int THREADS = 512;
constexpr int SLOTS = THREADS / 8;  // position slots (8 channel groups each)
constexpr int PPT = 4;              // positions per thread
static_assert(SLOTS * PPT >= NPOS, "conv tile does not fit the block");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int C>
constexpr size_t smem_bytes() {
  return sizeof(float4) * IT * IT + sizeof(float) * KS * KS * C * OCB +
         sizeof(float) * NPOS * OCB;
}

template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
fused_stem_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, T* __restrict__ out, int H,
                  int W, int O) {
  extern __shared__ float4 smem[];
  float4* s_in = smem;                                         // IT*IT
  float* s_w = reinterpret_cast<float*>(s_in + IT * IT);       // 49*C*OCB
  float* s_conv = s_w + KS * KS * C * OCB;                     // NPOS*OCB

  const int hc = H / 2, wc = W / 2;    // conv map
  const int hp = hc / 2, wpool = wc / 2;  // pooled map
  const int p0 = blockIdx.y * TP, q0 = blockIdx.x * TP;
  const int groups = (O + OCB - 1) / OCB;
  const int n = blockIdx.z / groups;
  const int oc0 = (blockIdx.z % groups) * OCB;
  const int tid = threadIdx.x;

  // input window: conv row 2*p0 - 1 + lr reads input rows 4*p0 - 5 + 2*lr + ky
  const int r0 = 4 * p0 - 5, c0 = 4 * q0 - 5;
  for (int i = tid; i < IT * IT; i += THREADS) {
    const int rr = r0 + i / IT, cc = c0 + i % IT;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (rr >= 0 && rr < H && cc >= 0 && cc < W) {
      const T* px = x + ((static_cast<size_t>(n) * H + rr) * W + cc) * C;
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = to_float(px[c]);
    }
    s_in[i] = make_float4(v[0], v[1], v[2], v[3]);
  }
  // weights: s_w[(tap * C + c) * OCB + o], zero past O
  for (int i = tid; i < KS * KS * C * OCB; i += THREADS) {
    const int o = i % OCB, tc = i / OCB;
    const int oc = oc0 + o;
    s_w[i] = oc < O ? w[static_cast<size_t>(tc) * O + oc] : 0.f;
  }
  __syncthreads();

  const int g = tid & 7;      // channels g*8 .. g*8+7 of this block
  const int slot = tid >> 3;  // positions slot + SLOTS * q
  int lr[PPT], lc[PPT];
  float acc[PPT][8];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int pos = min(slot + SLOTS * q, NPOS - 1);
    lr[q] = pos / CT;
    lc[q] = pos % CT;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[q][j] = 0.f;
  }
  for (int ky = 0; ky < KS; ++ky) {
#pragma unroll
    for (int kx = 0; kx < KS; ++kx) {
      float4 xin[PPT];
#pragma unroll
      for (int q = 0; q < PPT; ++q)
        xin[q] = s_in[(2 * lr[q] + ky) * IT + 2 * lc[q] + kx];
      const float* wt = s_w + (ky * KS + kx) * C * OCB + g * 8;
      float wr[C][8];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 wa = *reinterpret_cast<const float4*>(wt + c * OCB);
        const float4 wb = *reinterpret_cast<const float4*>(wt + c * OCB + 4);
        wr[c][0] = wa.x; wr[c][1] = wa.y; wr[c][2] = wa.z; wr[c][3] = wa.w;
        wr[c][4] = wb.x; wr[c][5] = wb.y; wr[c][6] = wb.z; wr[c][7] = wb.w;
      }
      stem::tap<C, PPT, 8>(acc, xin, wr);
    }
  }
  // relu(conv + bias); conv positions outside the map are the pool's -inf pad
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int pos = slot + SLOTS * q;
    if (pos >= NPOS) continue;
    const int cr = 2 * p0 - 1 + lr[q], cc = 2 * q0 - 1 + lc[q];
    const bool inside = cr >= 0 && cr < hc && cc >= 0 && cc < wc;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int oc = oc0 + g * 8 + j;
      const float b = oc < O ? bias[oc] : 0.f;
      s_conv[pos * OCB + g * 8 + j] =
          inside ? stem::relu_bias(acc[q][j], b) : -CUDART_INF_F;
    }
  }
  __syncthreads();

  // pooled (p0 + pr, q0 + pc) takes local conv rows 2pr..2pr+2, cols 2pc..2pc+2
  for (int i = tid; i < TP * TP * OCB; i += THREADS) {
    const int o = i % OCB, pp = i / OCB;
    const int pr = pp / TP, pc = pp % TP;
    const int p = p0 + pr, qq = q0 + pc, oc = oc0 + o;
    if (p >= hp || qq >= wpool || oc >= O) continue;
    float m = -CUDART_INF_F;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        m = fmaxf(m, s_conv[((2 * pr + dy) * CT + 2 * pc + dx) * OCB + o]);
    store(out + ((static_cast<size_t>(n) * hp + p) * wpool + qq) * O + oc, m);
  }
}

template <typename T, int C>
int launch(const void* x, const void* w, const void* bias, void* out, int N,
           int H, int W, int O, cudaStream_t stream) {
  const size_t smem = smem_bytes<C>();
  cudaError_t err = cudaFuncSetAttribute(
      fused_stem_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hp = H / 4, wpool = W / 4;
  const dim3 grid((wpool + TP - 1) / TP, (hp + TP - 1) / TP,
                  N * ((O + OCB - 1) / OCB));
  fused_stem_kernel<T, C><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<T*>(out), H, W, O);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_c(const void* x, const void* w, const void* bias, void* out,
               int N, int H, int W, int C, int O, cudaStream_t stream) {
  switch (C) {
    case 1: return launch<T, 1>(x, w, bias, out, N, H, W, O, stream);
    case 2: return launch<T, 2>(x, w, bias, out, N, H, W, O, stream);
    case 3: return launch<T, 3>(x, w, bias, out, N, H, W, O, stream);
    case 4: return launch<T, 4>(x, w, bias, out, N, H, W, O, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream`; returns the CUDA error code (0 on success).
extern "C" int bnn_fused_stem(const void* x, int x_bf16, const void* w,
                              const void* bias, void* out, int N, int H, int W,
                              int C, int O, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) return dispatch_c<__nv_bfloat16>(x, w, bias, out, N, H, W, C, O, s);
  return dispatch_c<float>(x, w, bias, out, N, H, W, C, O, s);
}
