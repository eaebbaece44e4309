// Binary GEMM over bit-packed weights, hand-written for Hopper (sm_90a).
//
// Replaces bnn_tpu/kernels/gemm.py:binary_gemm (a Pallas TPU kernel that
// expands packed words to int8 in VMEM and runs the MXU's int8 mode).
//
//   out[m, n] = float(sum_k s(x[m, k]) * w[k, n]) * scale[n] + add[n]
//
// s(v) = v >= 0 ? +1 : -1 when sign_inputs, else the int8 value of v (the
// caller passes ternary {-1, 0, +1}). w[k, n] = bit (k % 32) of word
// w_packed[k / 32, n] mapped {0, 1} -> {-1, +1}; rows k >= K are masked to 0,
// because a 0 pad bit would otherwise unpack to -1. The sum is exact in
// int32 and the epilogue is f32 with mul and add rounded separately (no FMA
// contraction), so the result is bit-identical to the plain version.
//
// Bound on an H100 at the serving shape (M=392, K=256, N=512, bf16 x): about
// 1.0 MB moved (0.3 us at 3.35 TB/s) against 103 M int8 ops (0.05 us), so
// the layer is bound by bytes and, at this size, by the launch itself.
// Design: one block per 64x64 output tile, 256 threads with a 4x4 register
// tile each. Per 128-deep K chunk the block converts its x tile to int8 and
// expands four packed words per column to +/-1 int8 in shared memory, then
// accumulates with __dp4a (four int8 products per instruction); the next
// chunk's global loads are issued before the current chunk's products, so
// a short K pays about one memory latency. Weights cross device memory
// packed (1 bit each) and are expanded only on chip.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // output rows per block
constexpr int BN = 64;       // output columns per block
constexpr int THREADS = 256;
constexpr int KW = 4;        // packed words (32 K values each) per chunk
constexpr int KV = KW * 8;   // int32 words of four int8 per chunk

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int quantize(float v, int sign_inputs) {
  if (sign_inputs) return v >= 0.f ? 1 : -1;
  return static_cast<int>(v);  // ternary input: exact
}

__device__ __forceinline__ int pack4(int a, int b, int c, int d) {
  return static_cast<int>((static_cast<uint32_t>(a) & 0xffu) |
                          ((static_cast<uint32_t>(b) & 0xffu) << 8) |
                          ((static_cast<uint32_t>(c) & 0xffu) << 16) |
                          ((static_cast<uint32_t>(d) & 0xffu) << 24));
}

// One thread's share of a 128-deep K chunk: 32 x values of row m (as eight
// words of four int8) and the packed weight word `word` of column n.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ x,
                                           const int32_t* __restrict__ wp,
                                           int m, int n, int k0, int word,
                                           int M, int K, int N, int kwords,
                                           int sign_inputs, int (&xr)[8],
                                           uint32_t& wr) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = k0 + 4 * i + e;
      v[e] = (m < M && kk < K)
                 ? quantize(to_float(x[static_cast<size_t>(m) * K + kk]),
                            sign_inputs)
                 : 0;
    }
    xr[i] = pack4(v[0], v[1], v[2], v[3]);
  }
  wr = (n < N && word < kwords)
           ? static_cast<uint32_t>(wp[static_cast<size_t>(word) * N + n])
           : 0u;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
binary_gemm_kernel(const T* __restrict__ x, const int32_t* __restrict__ wp,
                   const float* __restrict__ scale,
                   const float* __restrict__ add, float* __restrict__ out,
                   int M, int K, int N, int sign_inputs) {
  // +1 column of padding keeps the strided reads below free of bank conflicts
  __shared__ int sx[BM][KV + 1];
  __shared__ int sw[BN][KV + 1];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tx = tid % 16;  // output columns tx + 16 * j
  const int ty = tid / 16;  // output rows ty * 4 + i
  // loader role: row m0 + lr of x and column n0 + lr of w, K values
  // lq * 32 .. lq * 32 + 31 of each chunk (one packed word)
  const int lr = tid >> 2;
  const int lq = tid & 3;
  const int m = m0 + lr, n = n0 + lr;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  const int kwords = (K + 31) / 32;
  const int chunks = (kwords + KW - 1) / KW;
  int xr[8];
  uint32_t wr;
  load_chunk(x, wp, m, n, lq * 32, lq, M, K, N, kwords, sign_inputs, xr, wr);
  for (int c = 0; c < chunks; ++c) {
    const int k0 = c * KW * 32 + lq * 32;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sx[lr][lq * 8 + i] = xr[i];
      int v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = 4 * i + e;
        v[e] = (n < N && k0 + b < K) ? (((wr >> b) & 1u) ? 1 : -1) : 0;
      }
      sw[lr][lq * 8 + i] = pack4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
    // the next chunk's loads are in flight while this one is multiplied
    if (c + 1 < chunks) {
      load_chunk(x, wp, m, n, k0 + KW * 32, (c + 1) * KW + lq, M, K, N,
                 kwords, sign_inputs, xr, wr);
    }
#pragma unroll
    for (int kv = 0; kv < KV; ++kv) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sx[ty * 4 + i][kv];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sw[tx + 16 * j][kv];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int mm = m0 + ty * 4 + i;
    if (mm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nn = n0 + tx + 16 * j;
      if (nn < N) {
        out[static_cast<size_t>(mm) * N + nn] = __fadd_rn(
            __fmul_rn(static_cast<float>(acc[i][j]), scale[nn]), add[nn]);
      }
    }
  }
}

}  // namespace

// x: (M, K) row-major, bf16 when x_bf16 else f32; w_packed: (ceil(K/32), N)
// int32; scale, add: (N,) f32; out: (M, N) f32. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int bnn_binary_gemm(const void* x, int x_bf16, const void* w_packed,
                               const void* scale, const void* add, void* out,
                               int M, int K, int N, int sign_inputs,
                               void* stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* wp = static_cast<const int32_t*>(w_packed);
  const float* sc = static_cast<const float*>(scale);
  const float* ad = static_cast<const float*>(add);
  float* o = static_cast<float*>(out);
  if (x_bf16) {
    binary_gemm_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), wp, sc, ad, o, M, K, N,
        sign_inputs);
  } else {
    binary_gemm_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), wp, sc, ad, o, M, K, N, sign_inputs);
  }
  return static_cast<int>(cudaGetLastError());
}
