// Binary GEMM over bit-packed weights, hand-written for Hopper (sm_90a).
//
// Replaces bnn_tpu/kernels/gemm.py:binary_gemm (a Pallas TPU kernel that
// expands packed words to int8 in VMEM and runs the MXU's int8 mode).
//
//   out[m, n] = float(sum_k s(x[m, k]) * w[k, n]) * scale[n] + add[n]
//
// s(v) = v >= 0 ? +1 : -1 when sign_inputs, else the sign of v, which is v
// itself for the ternary {-1, 0, +1} inputs the caller passes. w[k, n] = bit
// (k % 32) of word w_packed[k / 32, n] mapped {0, 1} -> {-1, +1}; rows
// k >= K are masked to 0, because a 0 pad bit would otherwise unpack to -1.
// The sum is exact in int32 and the epilogue is f32 with mul and add rounded
// separately (no FMA contraction), so the result is bit-identical to the
// plain version.
//
// Bound on an H100 at the serving shapes: M=392 K=256 N=512 bf16 moves
// about 1.0 MB (0.31 us at 3.35 TB/s) against 103 M int8 ops (0.05 us);
// ResNet-50's M=196 K=1024 N=512 about 0.87 MB (0.26 us) against 206 M ops
// (0.10 us). So it is bound by bytes and, at these sizes, in practice by
// the launch and one or two device-memory latencies.
//
// Design:
// - Tiles that fill the card: two instances, 64x64 and 32x32 outputs per
//   block of four warps (2x2 warps). The host (kernels/gemm.py gemm_plan)
//   takes the larger tile when its grid reaches half a wave of blocks (66 on
//   132 SMs), else the smaller: M=196 N=512 runs 112 blocks of 32x32, M=392
//   N=512 208, M=784 N=512 104 of 64x64. On the H100 a 64x64 grid of 100
//   blocks or more ran faster than the 32x32 grid of the same product
//   (which signs each x value and expands each weight byte twice as often),
//   one of 98 tied with it, and one of 64 or fewer ran slower
//   (chip_smoke.py phase 4 times both tiles at every serving shape).
// - Int8 tensor cores: mma.sync m16n8k32 s8 x s8 -> s32, exact. A warp's
//   A fragments are read from the raw x tile in shared memory and signed to
//   int8 as they are packed into registers; its B fragments come straight
//   from the packed words: K is permuted inside each 32-deep step (lane
//   group t takes K values 8t..8t+7 in both operands, which leaves the sum
//   unchanged), so a lane's two B registers are the two nibbles of one byte
//   of one word, spread to +/-1 bytes and ANDed with a K-validity mask. The
//   weights stay at 1 bit per value until the register.
// - Asynchronous copies: per 128-deep K chunk, 16-byte cp.async.cg copies
//   of the raw x rows (8 bf16 or 4 f32 values) and of the packed words (4
//   neighbouring columns of one word row) into a 3-stage ring, zero-filled
//   (src-size 0) past M, N and K; one cp.async.wait_group and one
//   __syncthreads per chunk, so the next two chunks' copies are in flight
//   during the current chunk's mma. Where 16-byte copies are impossible (K
//   not a multiple of 8 bf16 or 4 f32 values, N not a multiple of 4, or a
//   pointer off 16 bytes) the scalar-loader instance of the same kernel
//   loads element by element with predicates.
// - sign_inputs is a template argument, so that no branch splits the K loop
//   around each in-register signing (a runtime flag cuts it into small
//   basic blocks the compiler cannot interleave).
// - mma.sync rather than wgmma: the products here are 0.05-2 us of the int8
//   rate even at mma.sync's share of it; the time goes to latency, idle SMs
//   and the integer work of signing and expanding, which small tiles, the
//   copy ring and cheap bit tricks address. wgmma needs 64-row warpgroup
//   tiles (too few blocks at these M) and TMA descriptors per call.
#include "mma_s8.cuh"

namespace {

constexpr int THREADS = 128;  // four warps, 2x2 over the output tile
constexpr int KC = 128;       // K values per chunk: four packed words
constexpr int KW = KC / 32;
constexpr int STAGES = 3;

// Shared-memory row of a chunk of x, in elements: padded so that the
// fragment reads (16 bytes a lane, two rows per eight lanes) hit distinct
// banks, and every row starts on 16 bytes.
template <typename T>
constexpr int X_ROW = KC + (sizeof(T) == 2 ? 32 : 4);

template <typename T, int BM, int BN>
constexpr int smem_bytes() {
  return STAGES * (BM * X_ROW<T> * static_cast<int>(sizeof(T)) + KW * BN * 4);
}

// Four weight bits (a nibble, lowest k first) as four +/-1 bytes
__device__ __forceinline__ uint32_t pm1x4(uint32_t nib) {
  const uint32_t bits = (nib * 0x00204081u) & 0x01010101u;  // bit j -> byte j
  return ~(bits * 0xFEu);                                    // 1 -> 1, 0 -> -1
}

// Bytes of a word holding k values k0..k0+3, kept where k < K
__device__ __forceinline__ uint32_t k_mask(int rem) {
  return rem >= 4 ? 0xFFFFFFFFu : (rem <= 0 ? 0u : (1u << (8 * rem)) - 1u);
}

// One chunk of x rows and packed words into a stage of the ring.
template <typename T, int BM, int BN, bool VEC>
__device__ __forceinline__ void load_chunk(
    T* __restrict__ xs, int32_t* __restrict__ ws, const T* __restrict__ x,
    const int32_t* __restrict__ wp, int m0, int n0, int chunk, int M, int K,
    int N, int kwords) {
  const int tid = threadIdx.x;
  const int k0 = chunk * KC;
  constexpr int XR = X_ROW<T>;
  if constexpr (VEC) {
    constexpr int PER = 16 / sizeof(T);  // values per copy
    constexpr int VPR = KC / PER;        // copies per row
#pragma unroll
    for (int it = 0; it < BM * VPR / THREADS; ++it) {
      const int idx = it * THREADS + tid;
      const int r = idx / VPR, kk = (idx % VPR) * PER;
      const bool ok = m0 + r < M && k0 + kk < K;
      const T* src = ok ? x + static_cast<size_t>(m0 + r) * K + k0 + kk : x;
      cp_async16(xs + r * XR + kk, src, ok ? 16 : 0);
    }
    constexpr int VPW = BN / 4;  // copies per word row
    if (tid < KW * VPW) {
      const int word = chunk * KW + tid / VPW, c = (tid % VPW) * 4;
      const bool ok = word < kwords && n0 + c < N;
      const int32_t* src =
          ok ? wp + static_cast<size_t>(word) * N + n0 + c : wp;
      cp_async16(ws + (tid / VPW) * BN + c, src, ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < BM * KC / THREADS; ++it) {
      const int idx = it * THREADS + tid;
      const int r = idx / KC, kk = idx % KC;
      const bool ok = m0 + r < M && k0 + kk < K;
      xs[r * XR + kk] =
          ok ? x[static_cast<size_t>(m0 + r) * K + k0 + kk] : zero_value<T>();
    }
    for (int idx = tid; idx < KW * BN; idx += THREADS) {
      const int word = chunk * KW + idx / BN, c = idx % BN;
      const bool ok = word < kwords && n0 + c < N;
      ws[idx] = ok ? wp[static_cast<size_t>(word) * N + n0 + c] : 0;
    }
  }
}

template <typename T, int BM, int BN, bool VEC, bool SIGN>
__global__ void __launch_bounds__(THREADS)
binary_gemm_kernel(const T* __restrict__ x, const int32_t* __restrict__ wp,
                   const float* __restrict__ scale,
                   const float* __restrict__ add, float* __restrict__ out,
                   int M, int K, int N) {
  constexpr int XR = X_ROW<T>;
  constexpr int WM = BM / 2, WN = BN / 2;  // each warp's output tile
  constexpr int MT = WM / 16, NT = WN / 8;  // its m16n8 tiles
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  int32_t* ws = reinterpret_cast<int32_t*>(smem + STAGES * BM * XR * sizeof(T));

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row / K group
  const int wm0 = (warp / 2) * WM, wn0 = (warp % 2) * WN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kwords = (K + 31) / 32;
  const int chunks = (kwords + KW - 1) / KW;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < chunks)
      load_chunk<T, BM, BN, VEC>(xs + s * BM * XR, ws + s * KW * BN, x, wp, m0,
                                 n0, s, M, K, N, kwords);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<STAGES - 2>();  // chunk c has landed
    __syncthreads();              // ... for every thread, and c - 1 is done
    const int next = c + STAGES - 1;
    if (next < chunks) {
      const int s = next % STAGES;
      load_chunk<T, BM, BN, VEC>(xs + s * BM * XR, ws + s * KW * BN, x, wp,
                                 m0, n0, next, M, K, N, kwords);
    }
    cp_async_commit();

    const T* xc = xs + (c % STAGES) * BM * XR;
    const int32_t* wc = ws + (c % STAGES) * KW * BN;
#pragma unroll
    for (int kw = 0; kw < KW; ++kw) {
      // this lane's K values: 8 t .. 8 t + 7 of packed word kw
      const int kk = kw * 32 + 8 * t;
      const int rem = K - (c * KC + kk);
      const uint32_t mask0 = k_mask(rem), mask1 = k_mask(rem - 4);
      uint32_t b[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint32_t byte =
            (static_cast<uint32_t>(wc[kw * BN + wn0 + j * 8 + g]) >> (8 * t)) &
            0xFFu;
        b[j][0] = pm1x4(byte & 0xFu) & mask0;
        b[j][1] = pm1x4(byte >> 4) & mask1;
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const T* r0 = xc + (wm0 + i * 16 + g) * XR + kk;
        const T* r1 = r0 + 8 * XR;
        // fragment registers: row g K 0-3, row g+8 K 0-3, row g K 4-7,
        // row g+8 K 4-7 (of this lane's eight)
        uint32_t a[4];
        s8x8<SIGN>(r0, a[0], a[2]);
        s8x8<SIGN>(r1, a[1], a[3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], a, b[j][0], b[j][1]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm0 + i * 16 + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn0 + j * 8 + 2 * t + e;
          if (n < N) {
            out[static_cast<size_t>(m) * N + n] = __fadd_rn(
                __fmul_rn(static_cast<float>(acc[i][j][2 * h + e]), scale[n]),
                add[n]);
          }
        }
      }
    }
  }
}

struct Args {
  const void* x;
  const int32_t* w;
  const float* scale;
  const float* add;
  float* out;
  int M, K, N;
  cudaStream_t stream;
};

template <typename T, int TILE, bool VEC, bool SIGN>
int launch(const Args& a) {
  constexpr int bytes = smem_bytes<T, TILE, TILE>();
  auto* kernel = binary_gemm_kernel<T, TILE, TILE, VEC, SIGN>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const dim3 grid((a.M + TILE - 1) / TILE, (a.N + TILE - 1) / TILE);
  kernel<<<grid, THREADS, bytes, a.stream>>>(static_cast<const T*>(a.x), a.w,
                                              a.scale, a.add, a.out, a.M, a.K,
                                              a.N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int TILE, bool VEC>
int pick_sign(const Args& a, int sign_inputs) {
  return sign_inputs ? launch<T, TILE, VEC, true>(a)
                     : launch<T, TILE, VEC, false>(a);
}

template <typename T, int TILE>
int pick_loader(const Args& a, int vector_loads, int sign_inputs) {
  return vector_loads ? pick_sign<T, TILE, true>(a, sign_inputs)
                      : pick_sign<T, TILE, false>(a, sign_inputs);
}

template <typename T>
int pick_tile(const Args& a, int tile, int vector_loads, int sign_inputs) {
  if (tile == 64) return pick_loader<T, 64>(a, vector_loads, sign_inputs);
  if (tile == 32) return pick_loader<T, 32>(a, vector_loads, sign_inputs);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: (M, K) row-major, bf16 when x_bf16 else f32; w_packed: (ceil(K/32), N)
// int32; scale, add: (N,) f32; out: (M, N) f32. `tile` (64 or 32 outputs a
// side) and `vector_loads` (16-byte copies; the caller checks that K, N and
// both pointers allow them) come from the host plan. Launches on `stream`
// and returns cudaGetLastError().
extern "C" int bnn_binary_gemm(const void* x, int x_bf16, const void* w_packed,
                               const void* scale, const void* add, void* out,
                               int M, int K, int N, int sign_inputs, int tile,
                               int vector_loads, void* stream) {
  const Args a{x,
               static_cast<const int32_t*>(w_packed),
               static_cast<const float*>(scale),
               static_cast<const float*>(add),
               static_cast<float*>(out),
               M,
               K,
               N,
               static_cast<cudaStream_t>(stream)};
  return x_bf16 ? pick_tile<__nv_bfloat16>(a, tile, vector_loads, sign_inputs)
                : pick_tile<float>(a, tile, vector_loads, sign_inputs);
}
