// Fused binary convolution, stride 1, hand-written for Hopper (sm_90a):
//
//   out = conv(x >= 0 ? +1 : -1, w) * scale + add
//
// over an odd k x k kernel with "same" zero padding, in NHWC. Replaces
// bnn_tpu/kernels/conv.py:binary_conv2d_s1, a Pallas TPU kernel that signs
// x in VMEM and sums k*k shifted int8 slab products on the MXU.
//
// x: (N, H, W, C) f32 or bf16; wt: (O, k*k*Cp) int8 +/-1, each output
// channel's weights K-contiguous in (dy, dx, c) order with every tap's
// channels zero-padded to Cp = cchunks * KC (kernels/conv.py
// conv_weight_operand); scale, add: (O,) f32; out: (N, H, W, O) f32. The
// sign is taken in the kernel with sign(0) = +1 whatever the layer's
// convention, as the TPU kernel does, and the conv's zero padding comes
// after the sign: padded taps add exactly 0. The sums are exact in int32 and
// the epilogue rounds the multiply and the add apart (__fmul_rn, __fadd_rn),
// so the result is bit-identical to the plain version.
//
// Bound on an H100 at path B's shapes (a ResNet-18's 3x3 convs at batch 8):
// (8, 56, 56, 64) f32 -> 64 moves 6.4 MB of x in and 6.4 MB of f32 out
// (3.8 us at 3.35 TB/s) against 1.85 G int8 operations (0.9 us at the int8
// tensor-core rate); every layer does the same 1.85 G operations on fewer
// bytes, down to 1.1 us of bytes at (8, 7, 7, 512). So bytes bound it, and
// in practice the latency of walking K = 9 C.
//
// Design: an implicit GEMM on the int8 tensor cores. M = N*H*W output pixels
// (the rows of out), N = O, K = k*k*C.
// - mma.sync m16n8k32 s8 x s8 -> s32 (mma_s8.cuh, shared with binary_gemm).
//   A warp group (four warps, 2x2 over a 64x64 or 32x32 output tile) walks K
//   in chunks of one kernel row dy and KC = 64 channels: the k taps (dy, 0),
//   ..., (dy, k-1). Output pixel m0 + r reads, for tap (dy, dx), the input
//   pixel m0 + (dy - k/2) W - k/2 + r + dx (NHWC, pixels in row-major
//   order), so the chunk's x is ONE band of TILE + k - 1 consecutive pixels
//   and the k taps are that band shifted by dx rows. Each input pixel then
//   comes from L2 k times per output tile rather than k*k times: a design
//   whose chunk was a single tap measured 433 us over path B's 13 calls on
//   the H100, bound by those re-reads (PERF.md, section 6).
// - 16-byte cp.async copies of the raw x band (8 bf16 or 4 f32 values) and
//   of the k weight rows of KC bytes per output channel into a 2-stage
//   ring: the next chunk is in flight while the current one is multiplied.
// - x is signed in registers as the A fragments are built (mma_s8.cuh
//   s8x8, sign(0) = +1). The band holds every pixel in range of x, but a
//   tap can fall outside the image (or into the next image row or image),
//   where the conv pads with 0 and a raw 0 would sign to +1: each fragment
//   row's bytes are ANDed with its (pixel, tap) validity, so padded taps add
//   0. Channels past C are zero in the weight operand; rows past M and
//   columns past O are never stored.
// - K is permuted inside each 32-deep step (lane group t takes K 8t..8t+7
//   of both operands, as in binary_gemm), so a lane's B fragment is one
//   8-byte read of a weight row.
// - K split: where the host plan (kernels/conv.py conv_plan) asks for it,
//   a block holds 2 or 4 warp groups over the same tile. Group s walks the
//   chunks s, s + SPLIT, ... with its own ring and its own named barrier;
//   the partial int32 tiles meet in shared memory, exact in any order,
//   before one group's epilogue. One launch per call, no workspace.
// - Where 16-byte copies cannot be made (C * itemsize not a multiple of 16,
//   or x off 16 bytes) the scalar-loader instance loads x element by element.
// - Data type, tile, loader and split are template arguments, so no runtime
//   branch cuts the K loop into blocks the compiler cannot interleave.
// - The weights come as an (O, k*k*Cp) int8 operand, one copy of the
//   (k, k, C, O) weights per call made by the wrapper, rather than (K, O)
//   transposed on the way to shared memory: the copies then feed the B
//   fragments as they are, with no byte transposes in any block.
#include "mma_s8.cuh"

namespace {

constexpr int GROUP = 128;     // threads of a warp group: 2x2 warps
constexpr int KC = 64;         // channels per chunk
constexpr int STAGES = 2;
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block can use

// Shared-memory row of x, in elements: padded so that the fragment reads
// (16 bytes a lane, two rows per eight lanes) hit distinct banks, and every
// row starts on 16 bytes.
template <typename T>
constexpr int X_ROW = KC + (sizeof(T) == 2 ? 32 : 4);

// Bytes per output channel of a weight stage: k taps of KC bytes, padded so
// that the 8-byte fragment reads of four neighbouring rows hit distinct
// banks (k * KC + 32 is 96 modulo 128 for every odd k)
__host__ __device__ constexpr int b_row(int k) { return k * KC + 32; }

// Shared memory of one warp group's ring: x bands and weight rows (the
// host plan's kernels/conv.py conv_smem_bytes mirrors it)
template <typename T, int TILE>
__host__ __device__ constexpr int group_bytes(int k) {
  return STAGES * ((TILE + k - 1) * X_ROW<T> * static_cast<int>(sizeof(T)) +
                   TILE * b_row(k));
}

struct Params {
  const void* x;
  const int8_t* w;  // (O, k * k * cchunks * KC)
  const float* scale;
  const float* add;
  float* out;
  int M, H, W, C, k, O, cchunks;
};

// (y << 16) | x of output pixel m; past M a row that no tap reaches
__device__ __forceinline__ int pixel_yx(int m, const Params& p) {
  if (m >= p.M) return static_cast<int>(0x80000000u);  // y = -32768
  const int r = m % (p.H * p.W), y = r / p.W;
  return (y << 16) | (r - y * p.W);
}

// whether pixel yx shifted by (oy, ox) lies in the image
__device__ __forceinline__ bool inside(int yx, int oy, int ox, const Params& p) {
  return static_cast<unsigned>((yx >> 16) + oy) < static_cast<unsigned>(p.H) &&
         static_cast<unsigned>((yx & 0xFFFF) + ox) < static_cast<unsigned>(p.W);
}

// One chunk, (channel run cc, kernel row dy), of the x band and the k weight
// rows into a stage of a group's ring.
template <typename T, int TILE, bool VEC>
__device__ __forceinline__ void load_chunk(T* __restrict__ xs,
                                           int8_t* __restrict__ ws,
                                           const Params& p, int tid, int m0,
                                           int n0, int cc, int dy) {
  constexpr int XR = X_ROW<T>;
  const int rows = TILE + p.k - 1, c0 = cc * KC;
  const T* x = static_cast<const T*>(p.x);
  // the band's first pixel: output pixel m0 shifted by tap (dy, 0)
  const int first = m0 + (dy - p.k / 2) * p.W - p.k / 2;
  if constexpr (VEC) {
    constexpr int PER = 16 / sizeof(T);  // values per copy
    constexpr int VPR = KC / PER;        // copies per row
    for (int idx = tid; idx < rows * VPR; idx += GROUP) {
      const int j = idx / VPR, col = (idx % VPR) * PER;
      const int px = first + j;
      // C is a multiple of PER here, so a copy lies in the pixel's channels
      const bool ok = px >= 0 && px < p.M && c0 + col < p.C;
      const T* src = ok ? x + static_cast<size_t>(px) * p.C + c0 + col : x;
      cp_async16(xs + j * XR + col, src, ok ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < rows * KC; idx += GROUP) {
      const int j = idx / KC, c = idx % KC;
      const int px = first + j;
      const bool ok = px >= 0 && px < p.M && c0 + c < p.C;
      xs[j * XR + c] =
          ok ? x[static_cast<size_t>(px) * p.C + c0 + c] : zero_value<T>();
    }
  }
  // weight rows: the k taps' KC bytes, 16-byte copies (the operand is
  // aligned and its rows are multiples of KC bytes)
  const int per_row = p.k * (KC / 16), brow = b_row(p.k);
  const size_t row = static_cast<size_t>(p.k) * p.k * p.cchunks * KC;
  for (int idx = tid; idx < TILE * per_row; idx += GROUP) {
    const int r = idx / per_row, q = idx % per_row;
    const int dx = q / (KC / 16), col = (q % (KC / 16)) * 16;
    const bool ok = n0 + r < p.O;
    const int8_t* src =
        ok ? p.w + (n0 + r) * row + ((dy * p.k + dx) * p.cchunks + cc) * KC + col
           : p.w;
    cp_async16(ws + r * brow + dx * KC + col, src, ok ? 16 : 0);
  }
}

// a barrier of one warp group (id 1 + s), or of the block when there is one
template <int SPLIT>
__device__ __forceinline__ void group_sync(int s) {
  if constexpr (SPLIT == 1) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(s + 1), "n"(GROUP) : "memory");
  }
}

template <typename T, int TILE, bool VEC, int SPLIT>
__global__ void __launch_bounds__(GROUP* SPLIT)
binary_conv2d_s1_kernel(const __grid_constant__ Params p) {
  constexpr int XR = X_ROW<T>;
  constexpr int WM = TILE / 2, WN = TILE / 2;  // each warp's output tile
  constexpr int MT = WM / 16, NT = WN / 8;     // its m16n8 tiles
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = threadIdx.x / GROUP, tid = threadIdx.x % GROUP;
  const int xstage = (TILE + p.k - 1) * XR;  // elements of an x stage
  const int brow = b_row(p.k), wstage = TILE * brow;
  unsigned char* ring = smem + s * group_bytes<T, TILE>(p.k);
  T* xs = reinterpret_cast<T*>(ring);
  int8_t* ws = reinterpret_cast<int8_t*>(ring + STAGES * xstage * sizeof(T));

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row / K group
  const int wm0 = (warp / 2) * WM, wn0 = (warp % 2) * WN;
  const int m0 = blockIdx.x * TILE, n0 = blockIdx.y * TILE;
  const int chunks = p.k * p.cchunks;                 // (cc, dy), dy inner
  const int mine = (chunks - s + SPLIT - 1) / SPLIT;  // s, s + SPLIT, ...
  const int pad = p.k / 2;

  int fyx[MT][2];  // pixels of this lane's fragment rows
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) fyx[i][h] = pixel_yx(m0 + wm0 + i * 16 + g + 8 * h, p);

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  if (mine > 0) load_chunk<T, TILE, VEC>(xs, ws, p, tid, m0, n0, s / p.k, s % p.k);
  cp_async_commit();
  for (int c = 0; c < mine; ++c) {
    cp_async_wait<0>();    // chunk c has landed
    group_sync<SPLIT>(s);  // ... for the group, and c - 1 is done
    if (c + 1 < mine) {
      const int q = s + (c + 1) * SPLIT, st = (c + 1) % STAGES;
      load_chunk<T, TILE, VEC>(xs + st * xstage, ws + st * wstage, p, tid, m0,
                               n0, q / p.k, q % p.k);
    }
    cp_async_commit();

    const int dy = (s + c * SPLIT) % p.k;
    const T* xc = xs + (c % STAGES) * xstage;
    const int8_t* wc = ws + (c % STAGES) * wstage;
    for (int dx = 0; dx < p.k; ++dx) {
      uint32_t mask[MT][2];  // 0 where the row's tap falls in the padding
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          mask[i][h] = inside(fyx[i][h], dy - pad, dx - pad, p) ? 0xFFFFFFFFu : 0u;
#pragma unroll
      for (int ks = 0; ks < KC / 32; ++ks) {
        // this lane's K values: 8 t .. 8 t + 7 of the 32-deep step
        const int kk = ks * 32 + 8 * t;
        uint2 b[NT];
#pragma unroll
        for (int j = 0; j < NT; ++j)
          b[j] = *reinterpret_cast<const uint2*>(wc + (wn0 + j * 8 + g) * brow +
                                                 dx * KC + kk);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          // output row r reads band row r + dx
          const T* r0 = xc + (wm0 + i * 16 + g + dx) * XR + kk;
          // fragment registers: row g K 0-3, row g+8 K 0-3, row g K 4-7,
          // row g+8 K 4-7 (of this lane's eight)
          uint32_t a[4];
          s8x8<true>(r0, a[0], a[2]);
          s8x8<true>(r0 + 8 * XR, a[1], a[3]);
          a[0] &= mask[i][0];
          a[2] &= mask[i][0];
          a[1] &= mask[i][1];
          a[3] &= mask[i][1];
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], a, b[j].x, b[j].y);
        }
      }
    }
  }

  if constexpr (SPLIT > 1) {
    // the groups' partial tiles meet in shared memory (the rings are idle)
    __syncthreads();
    constexpr int PER_WARP = MT * NT * 4 * 32;
    int* part = reinterpret_cast<int*>(smem) + warp * PER_WARP + lane;
    if (s > 0) {
      int* dst = part + (s - 1) * TILE * TILE;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dst[((i * NT + j) * 4 + e) * 32] = acc[i][j][e];
    }
    __syncthreads();
    if (s > 0) return;
#pragma unroll
    for (int o = 0; o < SPLIT - 1; ++o)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][j][e] += part[o * TILE * TILE + ((i * NT + j) * 4 + e) * 32];
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm0 + i * 16 + g + 8 * h;
      if (m >= p.M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn0 + j * 8 + 2 * t + e;
          if (n < p.O) {
            p.out[static_cast<size_t>(m) * p.O + n] = __fadd_rn(
                __fmul_rn(static_cast<float>(acc[i][j][2 * h + e]), p.scale[n]),
                p.add[n]);
          }
        }
      }
    }
  }
}

template <typename T, int TILE, bool VEC, int SPLIT>
int launch(const Params& p, cudaStream_t stream) {
  const int bytes = SPLIT * group_bytes<T, TILE>(p.k);
  if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = binary_conv2d_s1_kernel<T, TILE, VEC, SPLIT>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const dim3 grid((p.M + TILE - 1) / TILE, (p.O + TILE - 1) / TILE);
  kernel<<<grid, GROUP * SPLIT, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int TILE, bool VEC>
int pick_split(const Params& p, int split, cudaStream_t stream) {
  if (split == 1) return launch<T, TILE, VEC, 1>(p, stream);
  if (split == 2) return launch<T, TILE, VEC, 2>(p, stream);
  if (split == 4) return launch<T, TILE, VEC, 4>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int TILE>
int pick_loader(const Params& p, int vector_loads, int split,
                cudaStream_t stream) {
  return vector_loads ? pick_split<T, TILE, true>(p, split, stream)
                      : pick_split<T, TILE, false>(p, split, stream);
}

template <typename T>
int pick_tile(const Params& p, int tile, int vector_loads, int split,
              cudaStream_t stream) {
  if (tile == 64) return pick_loader<T, 64>(p, vector_loads, split, stream);
  if (tile == 32) return pick_loader<T, 32>(p, vector_loads, split, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: (N, H, W, C) bf16 when x_bf16 else f32; wt: (O, k*k*Cp) int8 with
// Cp = ceil(C / 64) * 64; scale, add: (O,) f32; out: (N, H, W, O) f32.
// `tile` (64 or 32 outputs a side), `vector_loads` (16-byte copies of x; the
// caller checks that C and the x pointer allow them, and that wt is 16-byte
// aligned) and `split` (1, 2 or 4 warp groups sharing K) come from the host
// plan. Launches on `stream` and returns cudaGetLastError().
extern "C" int bnn_binary_conv2d_s1(const void* x, int x_bf16, const void* wt,
                                    const void* scale, const void* add,
                                    void* out, int N, int H, int W, int C,
                                    int k, int O, int tile, int vector_loads,
                                    int split, void* stream) {
  if (k < 1 || k % 2 == 0 || C < 1 || O < 1 || H < 1 || W < 1 ||
      H >= 32768 || W >= 32768) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.x = x;
  p.w = static_cast<const int8_t*>(wt);
  p.scale = static_cast<const float*>(scale);
  p.add = static_cast<const float*>(add);
  p.out = static_cast<float*>(out);
  p.M = N * H * W;
  p.H = H;
  p.W = W;
  p.C = C;
  p.k = k;
  p.O = O;
  p.cchunks = (C + KC - 1) / KC;
  const auto s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? pick_tile<__nv_bfloat16>(p, tile, vector_loads, split, s)
                : pick_tile<float>(p, tile, vector_loads, split, s);
}
