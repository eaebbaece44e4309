// XNOR / popcount GEMM over packed activations and packed weights,
// hand-written for Hopper (sm_90a):
//
//   out[m, n] = (K - 2 * sum_w popcount(xp[m, w] ^ wp[w, n])) * scale[n] + add[n]
//
// Replaces bnn_tpu/kernels/gemm.py:popcount_gemm, a Pallas TPU kernel that
// XORs word-major tiles on the VPU and carries the mismatch counts across
// its sequential K grid axis in VMEM scratch.
//
// xp: (M, KW) 32-bit words of the signed activations (bit j of word w is
// x[32w + j] >= 0); wp: (KW, N) words of the weights; scale, add: (N,) f32;
// out: (M, N) f32. The pad bits past K are 0 in both operands, so they
// never mismatch and K needs no correction.
//
// A thread block owns a 64 x 64 output tile and walks the words in chunks
// of 16, both operands staged in shared memory; each of its 128 threads
// keeps 8 rows x 4 columns of int32 mismatch counts in registers. The sum is
// exact; the epilogue rounds the multiply and the add apart (__fmul_rn,
// __fadd_rn), as the plain version does.
//
// Bound on an H100 at ResNet-50's batch-8 layer1 pointwise convs (M =
// 25,088, K = 64, N = 64): 0.2 MB of words in and 6.4 MB of f32 out (1.9 us
// at 3.35 TB/s) against 0.2 G bit operations, so the f32 output bounds it;
// the kernel writes each output once, in rows of 64 bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int PM = 64;   // output rows per block (8 row groups of 8)
constexpr int PN = 64;   // output columns per block (16 column groups of 4)
constexpr int PKW = 16;  // words per chunk

struct Smem {
  uint32_t x[PM][PKW + 1];  // +1 word of padding: conflict-free stores
  uint32_t w[PKW][PN];
};

__global__ void __launch_bounds__(THREADS)
popcount_gemm_kernel(const uint32_t* __restrict__ xp,
                     const uint32_t* __restrict__ wp,
                     const float* __restrict__ scale,
                     const float* __restrict__ add, float* __restrict__ out,
                     int M, int KW, int N, int K) {
  __shared__ Smem sm;
  const int m0 = blockIdx.x * PM, n0 = blockIdx.y * PN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  int mism[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) mism[i][j] = 0;
  for (int kw0 = 0; kw0 < KW; kw0 += PKW) {
    const int nk = min(PKW, KW - kw0);
    for (int e = tid; e < PM * PKW; e += THREADS) {
      const int r = e / PKW, q = e % PKW, m = m0 + r;
      sm.x[r][q] = (m < M && q < nk) ? xp[static_cast<size_t>(m) * KW + kw0 + q] : 0u;
    }
    for (int e = tid; e < PKW * PN; e += THREADS) {
      const int q = e / PN, c = e % PN, n = n0 + c;
      sm.w[q][c] = (n < N && q < nk) ? wp[static_cast<size_t>(kw0 + q) * N + n] : 0u;
    }
    __syncthreads();
    for (int q = 0; q < nk; ++q) {
      uint32_t a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = sm.x[ty * 8 + i][q];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sm.w[q][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mism[i][j] += __popc(a[i] ^ b[j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < M && n < N) {
        const float dot = static_cast<float>(K - 2 * mism[i][j]);
        out[static_cast<size_t>(m) * N + n] =
            __fadd_rn(__fmul_rn(dot, scale[n]), add[n]);
      }
    }
  }
}

}  // namespace

// Launches on `stream`; returns the CUDA error code (0 on success).
extern "C" int bnn_popcount_gemm(const void* xp, const void* wp,
                                 const void* scale, const void* add, void* out,
                                 int M, int KW, int N, int K, void* stream) {
  if (KW != (K + 31) / 32) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + PM - 1) / PM, (N + PN - 1) / PN);
  popcount_gemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(xp), static_cast<const uint32_t*>(wp),
      static_cast<const float*>(scale), static_cast<const float*>(add),
      static_cast<float*>(out), M, KW, N, K);
  return static_cast<int>(cudaGetLastError());
}
