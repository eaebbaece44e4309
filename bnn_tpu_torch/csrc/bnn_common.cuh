// Device code shared by the residual-block megakernels (fused_basic_block,
// fused_downsample_block, fused_chain, fused_stem_chain, fused_bottleneck),
// hand-written for Hopper (sm_90a).
//
// A binary BasicBlock runs as phases of one cooperative launch, separated
// by grid-wide barriers:
//
//   P0  xs = sign(x - thr1)                      int8 {-1, 0, +1}, to scratch
//       (down blocks also: ds = sign(avgpool2x2(x) - thrd))
//   P1  acc = conv1(xs); then hs = sign(act1(acc * s1 + a1) - thr2)
//   P2  acc = conv2(hs), accd = conv1x1(ds) (down blocks); then
//       y2 = acc * s2 + a2, r = x (basic) or accd * sd + ad,
//       out = pre ? act2(y2) + r : act2(y2 + r)
//
// The convolutions are implicit GEMMs: a work item is an output tile of TM
// pixels x TN channels and a slice of K, gathered in chunks of 64 int8 values
// from the signed map (zero outside the image: the conv's zero padding is
// added after the sign, so padded taps contribute exactly 0) and summed
// exactly in int32; the partial sums meet in an int32 buffer by atomic adds,
// which are exact in any order (a GEMM whose K is one slice stores them).
// Slicing K gives a batch-1 layer (49 output pixels at 7x7) enough items for
// every SM. The epilogues are elementwise passes over that buffer. Products
// of ternary values need int8: a 1-bit XNOR form cannot hold the zeros of
// the torch-parity sign.
//
// A work item runs on MmaTile, the int8 tensor-core tile (mma.sync m16n8k32
// over a cp.async ring, 16-byte copies of A rows and of a K-major (N, K)
// weight copy). fused_chain, fused_stem_chain, fused_basic_block and
// fused_downsample_block run it through run_block, fused_bottleneck through
// its own phases.
//
// Numerics are those of the plain PyTorch versions bit for bit: the sums are
// exact, every f32 multiply and add is rounded on its own (__fmul_rn,
// __fadd_rn: no FMA contraction), and the shortcut's 2x2 mean is
// 0.25 * (((p00 + p01) + p10) + p11) in that order. Epilogue rows may be f32
// or bf16; the arithmetic is f32 on their values either way.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_s8.cuh"

namespace bnn {

namespace cg = cooperative_groups;

constexpr int THREADS = 128;
constexpr int TM = 32;   // output pixels per tile (8 row groups of 4)
constexpr int TN = 64;   // output channels per tile (16 column groups of 4)
constexpr int KCW = 16;  // K words of four int8 per chunk (64 K values)
constexpr int MAX_BLOCKS = 8;

enum Act { RELU = 0, PRELU = 1, IDENTITY = 2 };
// epilogue rows of a block descriptor
enum Row { S1, A1, P1, S2, A2, P2, SD, AD, THR2, THR1, THRD, NROWS };

__device__ __forceinline__ float ldf(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void stf(void* p, size_t i, float v, int bf16) {
  if (bf16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

// sign(v - t) as int8: zero_to_one maps v == t to +1, torch parity to 0
__device__ __forceinline__ int8_t sign_i8(float v, float t, int zero_to_one) {
  if (zero_to_one) return v >= t ? 1 : -1;
  return v > t ? 1 : (v < t ? -1 : 0);
}

__device__ __forceinline__ float act(float y, int kind, float slope) {
  if (kind == RELU) return y > 0.f ? y : 0.f;
  if (kind == PRELU) return y >= 0.f ? y : __fmul_rn(y, slope);
  return y;
}

// acc * scale + add with the two roundings of the plain version
__device__ __forceinline__ float epilogue(int acc, float scale, float add) {
  return __fadd_rn(__fmul_rn(static_cast<float>(acc), scale), add);
}

__device__ __forceinline__ int pack4(int a, int b, int c, int d) {
  return static_cast<int>((static_cast<uint32_t>(a) & 0xffu) |
                          ((static_cast<uint32_t>(b) & 0xffu) << 8) |
                          ((static_cast<uint32_t>(c) & 0xffu) << 16) |
                          ((static_cast<uint32_t>(d) & 0xffu) << 24));
}

// One block of a chain. w1, w2 and wd are the int8 weights in the JAX
// kernels' layouts (basic w1/w2 (9C, C) tap-major; down w1 (16Ci, Co) in
// _transform_w1's s2d order, w2 (9Co, Co), wd (Ci, Co)); no phase reads
// them. wt holds the K-major copies (Co, K) of conv1, conv2 and the shortcut
// that MmaTile reads (a down block's conv1 as its 9*Ci taps in (dy, dx, c)
// order). A row of length 0 takes its default value, of length 1 is
// broadcast.
struct Block {
  int down, ci, co;
  const int8_t* w1;
  const int8_t* w2;
  const int8_t* wd;
  const int8_t* wt[3];
  const void* ptr[NROWS];
  int len[NROWS];
};
// a block's pointers and ints in the flat host arrays (see setup())
constexpr int BLOCK_PTRS = 6 + NROWS;
constexpr int BLOCK_INTS = 3 + NROWS;

struct ChainParams {
  int nblocks, n, h, w;
  int act1, act2, pre, zero_to_one;
  int x_bf16, out_bf16, prm_bf16;
  const void* x;
  void* out;
  float* act_buf[2];    // f32 ping-pong between the blocks of a chain
  int8_t* xs;           // signed block input
  int8_t* hs;           // signed conv1 output
  int8_t* ds;           // signed pooled shortcut input (down blocks)
  int* acc;             // int32 sums of conv1, then of conv2
  int* accd;            // int32 sums of the shortcut's 1x1 (down blocks)
  const void* wfc;      // head: (C, classes), or null
  const void* bfc;      // (classes,) or null
  int classes;
  float* pooled;        // (N, C)
  Block blk[MAX_BLOCKS];
};

__device__ __forceinline__ float row(const ChainParams& p, const Block& b,
                                     int r, int c) {
  const float dflt = (r == S1 || r == S2 || r == SD) ? 1.f
                     : (r == P1 || r == P2)          ? 0.25f
                                                     : 0.f;
  if (b.len[r] == 0) return dflt;
  return ldf(b.ptr[r], b.len[r] == 1 ? 0 : c, p.prm_bf16);
}

// --- Gathers: the K values of an output pixel ---------------------------
// pixel(m) resolves output pixel m once per tile (out of range: a pixel
// whose every tap is padding); src(pixel, k) is the address of K value k,
// from which the C - k % C values of its tap are consecutive, or null where
// the tap is padding.

// 3x3 / stride 1 / pad 1 over an (N, H, W, C) map; K order (dy, dx, c)
struct Conv3x3 {
  const int8_t* s;
  int H, W, C;
  struct Pix {
    const int8_t* img;
    int y, x;
  };
  __device__ __forceinline__ Pix pixel(int m, int M) const {
    const int hw = H * W, n = m / hw, r = m - n * hw, y = r / W;
    if (m >= M) return {s, -4, -4};
    return {s + static_cast<size_t>(n) * hw * C, y, r - y * W};
  }
  __device__ __forceinline__ const int8_t* src(const Pix& p, int k) const {
    const int tap = k / C, c = k - tap * C, dy = tap / 3;
    const int yy = p.y + dy - 1, xx = p.x + tap - 3 * dy - 1;
    if (yy < 0 || yy >= H || xx < 0 || xx >= W) return nullptr;
    return p.img + (yy * W + xx) * C + c;
  }
};

// 3x3 / stride 2 / pad 1 over an (N, H, W, C) map with even H, W, K order
// (dy, dx, c): output pixel (i, j) reads input (2i - 1 + dy, 2j - 1 + dx).
// A down block's conv1 as its 9*C taps (the JAX kernel's s2d form has 16*C,
// 7*C of them against zero weights).
struct Conv3x3S2Taps {
  const int8_t* s;
  int H, W, C;
  struct Pix {
    const int8_t* img;
    int y0, x0;  // 2i - 1, 2j - 1
  };
  __device__ __forceinline__ Pix pixel(int m, int M) const {
    const int ow = W / 2, hw = (H / 2) * ow, n = m / hw, r = m - n * hw;
    const int i = r / ow;
    if (m >= M) return {s, -1 << 20, -1 << 20};
    return {s + static_cast<size_t>(n) * H * W * C, 2 * i - 1, 2 * (r - i * ow) - 1};
  }
  __device__ __forceinline__ const int8_t* src(const Pix& p, int k) const {
    const int tap = k / C, c = k - tap * C, dy = tap / 3;
    const int yy = p.y0 + dy, xx = p.x0 + tap - 3 * dy;
    if (yy < 0 || yy >= H || xx < 0 || xx >= W) return nullptr;
    return p.img + (yy * W + xx) * C + c;
  }
};

// 1x1 over an (M, C) map
struct Pointwise {
  const int8_t* s;
  int C;
  struct Pix {
    const int8_t* row;
  };
  __device__ __forceinline__ Pix pixel(int m, int M) const {
    return {m < M ? s + static_cast<size_t>(m) * C : nullptr};
  }
  __device__ __forceinline__ const int8_t* src(const Pix& p, int k) const {
    return p.row ? p.row + k : nullptr;
  }
};

// A GEMM's work items: output tiles times slices of K (mma_split_of), so
// that a small M still fills the card.
struct Split {
  int nt, slices, per_slice, chunks, items;
};

// --- MmaTile: the int8 tensor-core tile --------------------------------
// A work item is a TM x TN output tile and a slice of K.
// A chunk of 64 K values lands in one stage of a cp.async ring: A as TM rows
// of KCW words (four int8 each, row-major) and the weights as TN rows of KCW
// words from the K-major copy, which is mma.sync's .col layout of B, so no
// word is transposed. With C % 16 == 0 (every ResNet width from 64 up) a
// 16-byte segment of a row lies inside one tap and is one 16-byte cp.async,
// its tap and channel worked out once; otherwise each word is a 4-byte
// cp.async. The weight rows go through L1 (.ca), where the blocks resident
// on one SM find the rows that another has read; A rows bypass it (.cg). A
// padded tap, a row past M or K past its end copies zeros. The four warps
// split the tile as 2 (m16) x 2 (n32): per 32-deep step, lane (g, t) reads
// a[g][t], a[g+8][t], a[g][t+4], a[g+8][t+4] of its m16 rows and w[n+g][t],
// w[n+g][t+4] of four n8 blocks n, for four mma.sync m16n8k32.
constexpr int MP = KCW + 4;  // row pitch in words: 80-byte rows, 16-byte
                             // aligned; rows g = 0..7 start on banks 20g mod
                             // 32, so the fragment reads are conflict-free
constexpr int STAGES = 3;
constexpr int SEGS = 4 * KCW / 16;  // 16-byte segments per row and chunk
static_assert(TM * SEGS == THREADS && TN * SEGS % THREADS == 0, "tile shape");

struct MmaStage {
  int a[TM][MP];
  int w[TN][MP];
};

struct MmaSmem {
  MmaStage st[STAGES];
};

// BYTES (4 or 16) from global to shared memory through L1; src_bytes 0
// writes zeros
template <int BYTES>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(BYTES), "r"(src_bytes));
}

// The A rows this thread copies, i < MMA_ROWS: segment tid % SEGS of row
// tid / SEGS (VEC), or word tid % KCW of rows tid / KCW + i * THREADS / KCW
template <bool VEC>
constexpr int MMA_ROWS = VEC ? 1 : TM * KCW / THREADS;

template <bool VEC>
__device__ __forceinline__ int mma_row(int i) {
  return VEC ? threadIdx.x / SEGS + i * (THREADS / SEGS)
             : threadIdx.x / KCW + i * (THREADS / KCW);
}

// Start the copies of chunk `chunk` into stage st (not committed)
template <bool VEC, class Gather>
__device__ __forceinline__ void mma_load(
    const Gather& gather, const typename Gather::Pix (&px)[MMA_ROWS<VEC>],
    const int8_t* __restrict__ wt, int K, int N, int n0, int chunk,
    MmaStage& st) {
  const int tid = threadIdx.x, k0 = chunk * 4 * KCW;
  if constexpr (VEC) {
    const int seg = tid % SEGS, k = k0 + 16 * seg;
    const int8_t* a = k < K ? gather.src(px[0], k) : nullptr;
    cp_async16(&st.a[mma_row<true>(0)][4 * seg], a ? a : wt, a ? 16 : 0);
#pragma unroll
    for (int i = 0; i < TN * SEGS / THREADS; ++i) {
      const int r = mma_row<true>(i), n = n0 + r;
      const bool ok = n < N && k < K;
      cp_async_ca<16>(&st.w[r][4 * seg],
                      ok ? wt + static_cast<size_t>(n) * K + k : wt, ok ? 16 : 0);
    }
  } else {
    const int kw = tid % KCW, k = k0 + 4 * kw;
#pragma unroll
    for (int i = 0; i < MMA_ROWS<false>; ++i) {
      const int8_t* a = k < K ? gather.src(px[i], k) : nullptr;
      cp_async_ca<4>(&st.a[mma_row<false>(i)][kw], a ? a : wt, a ? 4 : 0);
    }
#pragma unroll
    for (int i = 0; i < TN * KCW / THREADS; ++i) {
      const int r = mma_row<false>(i), n = n0 + r;
      const bool ok = n < N && k < K;
      cp_async_ca<4>(&st.w[r][kw], ok ? wt + static_cast<size_t>(n) * K + k : wt,
                     ok ? 4 : 0);
    }
  }
}

// The products of one chunk: two 32-deep steps of this warp's m16 x n32
__device__ __forceinline__ void mma_chunk(const MmaStage& st, int (&acc)[4][4]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int* a = &st.a[(warp & 1) * 16 + lane / 4][lane % 4];
  const int* w = &st.w[(warp >> 1) * 32 + lane / 4][lane % 4];
#pragma unroll
  for (int q = 0; q < KCW; q += 8) {
    const uint32_t fa[4] = {static_cast<uint32_t>(a[q]),
                            static_cast<uint32_t>(a[8 * MP + q]),
                            static_cast<uint32_t>(a[q + 4]),
                            static_cast<uint32_t>(a[8 * MP + q + 4])};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mma_s8(acc[j], fa, static_cast<uint32_t>(w[8 * j * MP + q]),
             static_cast<uint32_t>(w[8 * j * MP + q + 4]));
    }
  }
}

// Where mma_tile puts a lane's sums of one n8 block: v[0], v[1] at (m, n),
// (m, n + 1) and, where `lower` (m + 8 < M), v[2], v[3] at (m + 8, n),
// (m + 8, n + 1); m < M and n + 1 < N. SumSink writes them to an (M, N)
// int32 buffer, stored where K is one slice, added with atomics otherwise;
// a kernel may pass its own sink (an epilogue applied in registers) to a
// one-slice GEMM.
struct SumSink {
  int* out;
  int N;
  bool store;
  __device__ __forceinline__ void operator()(int m, int n, const int (&v)[4],
                                             bool lower) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && !lower) break;
      int* o = out + static_cast<size_t>(m + 8 * h) * N + n;
      if (store) {
        *reinterpret_cast<int2*>(o) = make_int2(v[2 * h], v[2 * h + 1]);
      } else {
        if (v[2 * h] != 0) atomicAdd(o, v[2 * h]);
        if (v[2 * h + 1] != 0) atomicAdd(o + 1, v[2 * h + 1]);
      }
    }
  }
};

// out[m, n] = sum over K chunks [c0, c1) of A[m, k] * wt[n, k] for the
// TM x TN tile at (m0, n0): exact int32 sums of the K-major (N, K) weights,
// handed to `sink`. K and N are multiples of 4.
template <bool VEC, class Gather, class Sink>
__device__ void mma_tile(const Gather& gather, const int8_t* __restrict__ wt,
                         int M, int K, int N, int m0, int n0, int c0, int c1,
                         MmaSmem& sm, const Sink& sink) {
  typename Gather::Pix px[MMA_ROWS<VEC>];
#pragma unroll
  for (int i = 0; i < MMA_ROWS<VEC>; ++i) {
    px[i] = gather.pixel(m0 + mma_row<VEC>(i), M);
  }
  int acc[4][4] = {};
  __syncthreads();  // every warp is done with the ring's previous item
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (c0 + s < c1) mma_load<VEC>(gather, px, wt, K, N, n0, c0 + s, sm.st[s]);
    cp_async_commit();
  }
  for (int c = c0, s = 0; c < c1; ++c, s = s + 1 == STAGES ? 0 : s + 1) {
    cp_async_wait<STAGES - 2>();  // chunk c has landed for this thread ...
    __syncthreads();              // ... and every thread; stage s - 1 is free
    const int next = c + STAGES - 1;
    if (next < c1) {
      mma_load<VEC>(gather, px, wt, K, N, n0, next,
                    sm.st[s == 0 ? STAGES - 1 : s - 1]);
    }
    cp_async_commit();
    mma_chunk(sm.st[s], acc);
  }
  // lane (g, t) holds rows g and g + 8, columns 2t and 2t + 1 of each n8
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int m = m0 + (warp & 1) * 16 + lane / 4;
  const int n = n0 + (warp >> 1) * 32 + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int nn = n + 8 * j;  // N % 4 == 0: nn + 1 < N too
    if (m < M && nn < N) sink(m, nn, acc[j], m + 8 < M);
  }
}

// The work items of a GEMM in a `grid`-block launch, half an item per
// resident block: K is sliced only where the tiles fill less than half the
// grid (each slice adds its sums with atomics). Also on the host, for a
// kernel's plan.
__host__ __device__ __forceinline__ Split mma_split_of(int grid, int M, int K,
                                                       int N) {
  Split s;
  s.nt = (N + TN - 1) / TN;
  const int tiles = ((M + TM - 1) / TM) * s.nt;
  s.chunks = (K / 4 + KCW - 1) / KCW;
  const int half = (grid + 2 * tiles - 1) / (2 * tiles);
  const int want = half < 1 ? 1 : half > s.chunks ? s.chunks : half;
  s.per_slice = (s.chunks + want - 1) / want;
  s.slices = (s.chunks + s.per_slice - 1) / s.per_slice;
  s.items = tiles * s.slices;
  return s;
}

__device__ __forceinline__ Split mma_split(int M, int K, int N) {
  return mma_split_of(static_cast<int>(gridDim.x), M, K, N);
}

// --- run_block's tile -----------------------------------------------------
// Names its shared memory, the gather and K of a down block's conv1 and the
// weights it reads (i = 0, 1, 2: conv1, conv2, the shortcut), splits a GEMM
// into work items and runs one of them.
struct MmaTile {
  using Smem = MmaSmem;
  using Conv1S2 = Conv3x3S2Taps;
  static __device__ __forceinline__ Split split(int M, int K, int N) {
    return mma_split(M, K, N);
  }
  static __device__ __forceinline__ int k1(bool, int ci) { return 9 * ci; }
  static __device__ __forceinline__ const int8_t* w(const Block& b, int i) {
    return b.wt[i];
  }
  template <class Gather>
  static __device__ __forceinline__ void item(const Gather& gather,
                                              const int8_t* wt, int M, int K,
                                              int N, const Split& s, int item,
                                              Smem& sm, int* out) {
    item_to(gather, wt, M, K, N, s, item, sm, SumSink{out, N, s.slices == 1});
  }
  // item() with the sums handed to `sink`, which sees whole sums only
  // where s.slices == 1
  template <class Gather, class Sink>
  static __device__ __forceinline__ void item_to(const Gather& gather,
                                                 const int8_t* wt, int M, int K,
                                                 int N, const Split& s, int item,
                                                 Smem& sm, const Sink& sink) {
    const int tile = item / s.slices, slice = item % s.slices;
    const int c0 = slice * s.per_slice, c1 = min(s.chunks, c0 + s.per_slice);
    const int m0 = (tile / s.nt) * TM, n0 = (tile % s.nt) * TN;
    if (gather.C % 16 == 0) {
      mma_tile<true>(gather, wt, M, K, N, m0, n0, c0, c1, sm, sink);
    } else {
      mma_tile<false>(gather, wt, M, K, N, m0, n0, c0, c1, sm, sink);
    }
  }
};

// One residual block, as the phases at the top of this file, over an H x W
// input; the convolutions accumulate into p.acc / p.accd (zeroed in P0), and
// each epilogue is an elementwise pass. `in` and `out` must not overlap.
// Ends after its last phase without a barrier.
template <class Tile, bool DOWN>
__device__ void run_block(const ChainParams& p, const Block& b, int H, int W,
                          const void* in, int in_bf16, void* out, int out_bf16,
                          typename Tile::Smem& sm, cg::grid_group& grid) {
  const size_t gtid = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t nthr = static_cast<size_t>(gridDim.x) * blockDim.x;
  const int ci = b.ci, co = b.co;
  const int OH = DOWN ? H / 2 : H, OW = DOWN ? W / 2 : W;
  const int M = p.n * OH * OW;
  const size_t nout = static_cast<size_t>(M) * co;

  // P0: signs of the block input (and of the pooled shortcut input); zero
  // the accumulators
  const size_t nin = static_cast<size_t>(p.n) * H * W * ci;
  for (size_t i = gtid; i < nin; i += nthr) {
    p.xs[i] = sign_i8(ldf(in, i, in_bf16), row(p, b, THR1, i % ci),
                      p.zero_to_one);
  }
  for (size_t i = gtid; i < nout; i += nthr) {
    p.acc[i] = 0;
    if (DOWN) p.accd[i] = 0;
  }
  if (DOWN) {
    const size_t nd = static_cast<size_t>(M) * ci;
    for (size_t i = gtid; i < nd; i += nthr) {
      const int c = i % ci;
      const size_t pix = i / ci;
      const int j = pix % OW, r = (pix / OW) % OH, n = pix / (static_cast<size_t>(OW) * OH);
      const size_t base = ((static_cast<size_t>(n) * H + 2 * r) * W + 2 * j) * ci + c;
      const size_t below = static_cast<size_t>(W) * ci;
      const float s = __fadd_rn(
          __fadd_rn(__fadd_rn(ldf(in, base, in_bf16), ldf(in, base + ci, in_bf16)),
                    ldf(in, base + below, in_bf16)),
          ldf(in, base + below + ci, in_bf16));
      p.ds[i] = sign_i8(__fmul_rn(0.25f, s), row(p, b, THRD, c), p.zero_to_one);
    }
  }
  grid.sync();

  // P1: conv1 into acc
  const int k1 = Tile::k1(DOWN, ci);
  const Split s1 = Tile::split(M, k1, co);
  for (int it = blockIdx.x; it < s1.items; it += gridDim.x) {
    if (DOWN) {
      Tile::item(typename Tile::Conv1S2{p.xs, H, W, ci}, Tile::w(b, 0), M, k1,
                 co, s1, it, sm, p.acc);
    } else {
      Tile::item(Conv3x3{p.xs, H, W, ci}, Tile::w(b, 0), M, k1, co, s1, it, sm,
                 p.acc);
    }
  }
  grid.sync();
  // ... epilogue -> act1 -> sign; acc is zeroed again for conv2
  for (size_t i = gtid; i < nout; i += nthr) {
    const int n = i % co;
    const float y = act(epilogue(p.acc[i], row(p, b, S1, n), row(p, b, A1, n)),
                        p.act1, row(p, b, P1, n));
    p.hs[i] = sign_i8(y, row(p, b, THR2, n), p.zero_to_one);
    p.acc[i] = 0;
  }
  grid.sync();

  // P2: conv2 into acc and the shortcut's 1x1 into accd
  const Split s2 = Tile::split(M, 9 * co, co);
  const Split sd = Tile::split(M, DOWN ? ci : 4, co);
  const int items = s2.items + (DOWN ? sd.items : 0);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    if (it < s2.items) {
      Tile::item(Conv3x3{p.hs, OH, OW, co}, Tile::w(b, 1), M, 9 * co, co, s2, it,
                 sm, p.acc);
    } else {
      Tile::item(Pointwise{p.ds, ci}, Tile::w(b, 2), M, ci, co, sd,
                 it - s2.items, sm, p.accd);
    }
  }
  grid.sync();
  // ... epilogue, the residual add and act2
  for (size_t i = gtid; i < nout; i += nthr) {
    const int n = i % co;
    const float y2 = epilogue(p.acc[i], row(p, b, S2, n), row(p, b, A2, n));
    const float r = DOWN ? epilogue(p.accd[i], row(p, b, SD, n), row(p, b, AD, n))
                         : ldf(in, i, in_bf16);
    const float p2 = row(p, b, P2, n);
    const float v = p.pre ? __fadd_rn(act(y2, p.act2, p2), r)
                          : act(__fadd_rn(y2, r), p.act2, p2);
    stf(out, i, v, out_bf16);
  }
}

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// Thread blocks of a cooperative launch that can be resident at once.
inline int grid_capacity(const void* kernel, int* cache) {
  if (*cache > 0) return *cache;
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  *cache = sm_count() * per_sm;
  return *cache;
}

// The blocks of a launch of `kernel` whose widest GEMM has M rows and N
// columns: one per output tile, in whole SMs, 2 to 4 an SM, and at most what
// can be resident. Each block makes every grid barrier dearer (about 2.7 ns
// a block on an H100), and blocks beyond the tiles only slice K more finely.
inline int grid_for(const void* kernel, int* capacity, int M, int N) {
  const int cap = grid_capacity(kernel, capacity);
  if (cap <= 0) return cap;
  const int sms = sm_count();
  const int tiles = (M + TM - 1) / TM * ((N + TN - 1) / TN);
  const int per_sm = (tiles + sms - 1) / sms;
  const int grid = (per_sm < 2 ? 2 : per_sm > 4 ? 4 : per_sm) * sms;
  return grid < cap ? grid : cap;
}

// A block kernel's launch over M output pixels of N channels on the current
// device (grid_for), for a kernel's plan entry: out = {blocks, resident
// blocks an SM, output tiles, then the K slices of each of the nk GEMMs of
// depth ks[i]}. Returns the CUDA error code.
inline int block_plan(const void* kernel, int* capacity, int M, int N,
                      const int* ks, int nk, int* out) {
  const int blocks = grid_for(kernel, capacity, M, N);
  if (blocks <= 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
  out[0] = blocks;
  out[1] = *capacity / sm_count();
  for (int i = 0; i < nk; ++i) {
    const Split s = mma_split_of(blocks, M, ks[i], N);
    out[2] = s.items / s.slices;
    out[3 + i] = s.slices;
  }
  return 0;
}

// Fill `p` from the two flat host arrays every wrapper passes. Per block,
// BLOCK_PTRS pointers (w1, w2, wd, the K-major wt[0..2], the rows) and
// BLOCK_INTS ints (down, ci, co, the row lengths); then the pointers x, out,
// act0, act1, xs, hs, ds, acc, accd, wfc, bfc, pooled and the ints n, h, w,
// act1, act2, pre, zero_to_one, x_bf16, out_bf16, prm_bf16, classes.
inline int setup(ChainParams& p, int nblocks, const void* const* ptrs,
                 const int* ints) {
  if (nblocks < 1 || nblocks > MAX_BLOCKS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.nblocks = nblocks;
  for (int i = 0; i < nblocks; ++i, ptrs += BLOCK_PTRS, ints += BLOCK_INTS) {
    Block& b = p.blk[i];
    b.down = ints[0];
    b.ci = ints[1];
    b.co = ints[2];
    if (b.ci % 4 || b.co % 4 || (i > 0 && b.down)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    b.w1 = static_cast<const int8_t*>(ptrs[0]);
    b.w2 = static_cast<const int8_t*>(ptrs[1]);
    b.wd = static_cast<const int8_t*>(ptrs[2]);
    for (int j = 0; j < 3; ++j) b.wt[j] = static_cast<const int8_t*>(ptrs[3 + j]);
    for (int r = 0; r < NROWS; ++r) {
      b.ptr[r] = ptrs[6 + r];
      b.len[r] = ints[3 + r];
    }
  }
  p.x = ptrs[0];
  p.out = const_cast<void*>(ptrs[1]);
  p.act_buf[0] = static_cast<float*>(const_cast<void*>(ptrs[2]));
  p.act_buf[1] = static_cast<float*>(const_cast<void*>(ptrs[3]));
  p.xs = static_cast<int8_t*>(const_cast<void*>(ptrs[4]));
  p.hs = static_cast<int8_t*>(const_cast<void*>(ptrs[5]));
  p.ds = static_cast<int8_t*>(const_cast<void*>(ptrs[6]));
  p.acc = static_cast<int*>(const_cast<void*>(ptrs[7]));
  p.accd = static_cast<int*>(const_cast<void*>(ptrs[8]));
  p.wfc = ptrs[9];
  p.bfc = ptrs[10];
  p.pooled = static_cast<float*>(const_cast<void*>(ptrs[11]));
  p.n = ints[0];
  p.h = ints[1];
  p.w = ints[2];
  p.act1 = ints[3];
  p.act2 = ints[4];
  p.pre = ints[5];
  p.zero_to_one = ints[6];
  p.x_bf16 = ints[7];
  p.out_bf16 = ints[8];
  p.prm_bf16 = ints[9];
  p.classes = ints[10];
  return 0;
}

// One cooperative launch of `kernel(p)` over as many thread blocks as can
// be resident, or `grid` where that is fewer; a plain launch of a kernel
// with grid barriers could deadlock, so there is none. `Params` is the
// kernel's one argument (a ChainParams, or a kernel's own struct). Returns
// the CUDA error code.
template <class Params>
inline int launch(const void* kernel, int* capacity_cache, Params& p,
                  void* stream, int grid = 0) {
  const int cap = grid_capacity(kernel, capacity_cache);
  if (cap <= 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, dim3(grid > 0 && grid < cap ? grid : cap), dim3(THREADS), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bnn
