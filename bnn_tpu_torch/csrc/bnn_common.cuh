// Device code shared by the residual-block megakernels (fused_basic_block,
// fused_downsample_block, fused_chain, fused_bottleneck), hand-written for
// Hopper (sm_90a).
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
// exactly in int32 with __dp4a; the partial sums meet in an int32 buffer by
// atomic adds, which are exact in any order. Slicing K gives a batch-1 layer
// (49 output pixels at 7x7) enough items for every SM. The epilogues are
// elementwise passes over that buffer. Products of ternary values need int8:
// a 1-bit XNOR form cannot hold the zeros of the torch-parity sign.
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

// One block of a chain. Weights are int8 in the JAX kernels' layouts: basic
// w1/w2 (9C, C) tap-major; down w1 (16Ci, Co) in _transform_w1's s2d order,
// w2 (9Co, Co), wd (Ci, Co). A row of length 0 takes its default value, of
// length 1 is broadcast.
struct Block {
  int down, ci, co;
  const int8_t* w1;
  const int8_t* w2;
  const int8_t* wd;
  const void* ptr[NROWS];
  int len[NROWS];
};

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

// --- K-word gathers: four consecutive K values of an output pixel -------
// pixel(m) resolves output pixel m once per tile (out of range: a pixel
// whose every load is 0); load(pixel, kw) reads K word kw.

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
  __device__ __forceinline__ int load(const Pix& p, int kw) const {
    const int k = 4 * kw, tap = k / C, c = k - tap * C;
    const int yy = p.y + tap / 3 - 1, xx = p.x + tap % 3 - 1;
    if (yy < 0 || yy >= H || xx < 0 || xx >= W) return 0;
    return *reinterpret_cast<const int*>(p.img + (yy * W + xx) * C + c);
  }
};

// 3x3 / stride 2 / pad 1 over an (N, H, W, C) map, with the weights in the
// 2x2 space-to-depth form: K order (ki, kj, di, dj, c); tap (ki, kj) of s2d
// phase (di, dj) reads input row 2 * (i - 1 + ki) + di. Only the top and left
// edges pad; the taps that land there carry zero weights.
struct Conv3x3S2 {
  const int8_t* s;
  int H, W, C;
  struct Pix {
    const int8_t* img;
    int y0, x0;  // 2 * (i - 1), 2 * (j - 1)
  };
  __device__ __forceinline__ Pix pixel(int m, int M) const {
    const int ow = W / 2, hw = (H / 2) * ow, n = m / hw, r = m - n * hw;
    const int i = r / ow;
    if (m >= M) return {s, -1 << 20, -1 << 20};
    return {s + static_cast<size_t>(n) * H * W * C, 2 * (i - 1),
            2 * (r - i * ow - 1)};
  }
  __device__ __forceinline__ int load(const Pix& p, int kw) const {
    const int k = 4 * kw, g = k / C, c = k - g * C;
    const int yy = p.y0 + 2 * (g >> 3) + ((g >> 1) & 1);
    const int xx = p.x0 + 2 * ((g >> 2) & 1) + (g & 1);
    if (yy < 0 || xx < 0) return 0;
    return *reinterpret_cast<const int*>(p.img + (yy * W + xx) * C + c);
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
  __device__ __forceinline__ int load(const Pix& p, int kw) const {
    return p.row ? *reinterpret_cast<const int*>(p.row + 4 * kw) : 0;
  }
};

struct Smem {
  int a[TM][KCW + 1];  // +1 word of padding: conflict-free column reads
  int w[TN][KCW + 1];
};

// Work items per thread and chunk: A words, and (K word, 4 columns) groups
// of w, each four 32-bit rows read at once and transposed with byte_perm.
constexpr int A_PER = TM * KCW / THREADS;
constexpr int W_PER = KCW * (TN / 4) / THREADS;
static_assert(A_PER * THREADS == TM * KCW && W_PER * THREADS == KCW * TN / 4,
              "tile shape");

// This thread's A words of a chunk are K word kw0 + tid % KCW of the
// pixels px (rows tid / KCW + i * THREADS / KCW of the tile).
template <class Gather>
__device__ __forceinline__ void load_chunk(
    const Gather& gather, const typename Gather::Pix (&px)[A_PER],
    const int8_t* __restrict__ w, int N, int kwords, int n0, int kw0,
    int (&ra)[A_PER], int (&rw)[W_PER][4]) {
  const int tid = threadIdx.x, kw = kw0 + tid % KCW;
#pragma unroll
  for (int i = 0; i < A_PER; ++i) ra[i] = kw < kwords ? gather.load(px[i], kw) : 0;
#pragma unroll
  for (int i = 0; i < W_PER; ++i) {
    const int e = tid + i * THREADS, n = n0 + 4 * (e % (TN / 4));
    const int kwi = kw0 + e / (TN / 4);
    const bool ok = n < N && kwi < kwords;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      rw[i][t] = ok ? *reinterpret_cast<const int*>(
                          w + static_cast<size_t>(4 * kwi + t) * N + n)
                    : 0;
    }
  }
}

__device__ __forceinline__ void store_chunk(Smem& sm, const int (&ra)[A_PER],
                                            const int (&rw)[W_PER][4]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < A_PER; ++i) {
    const int e = tid + i * THREADS;
    sm.a[e / KCW][e % KCW] = ra[i];
  }
#pragma unroll
  for (int i = 0; i < W_PER; ++i) {
    const int e = tid + i * THREADS, c = 4 * (e % (TN / 4)), q = e / (TN / 4);
    // rows k..k+3 of columns c..c+3 -> one word of four k per column
    const int lo01 = __byte_perm(rw[i][0], rw[i][1], 0x5140);
    const int lo23 = __byte_perm(rw[i][2], rw[i][3], 0x5140);
    const int hi01 = __byte_perm(rw[i][0], rw[i][1], 0x7362);
    const int hi23 = __byte_perm(rw[i][2], rw[i][3], 0x7362);
    sm.w[c + 0][q] = __byte_perm(lo01, lo23, 0x5410);
    sm.w[c + 1][q] = __byte_perm(lo01, lo23, 0x7632);
    sm.w[c + 2][q] = __byte_perm(hi01, hi23, 0x5410);
    sm.w[c + 3][q] = __byte_perm(hi01, hi23, 0x7632);
  }
}

// out[m, n] += sum over K chunks [c0, c1) of A[m, k] * w[k, n] for the
// TM x TN tile at (m0, n0): exact int32 partial sums, added with atomics, so
// any split of K gives the same integers. w is (K, N) int8 row-major; K and
// N are multiples of 4. The next chunk's loads are issued before the
// current chunk's products.
template <class Gather>
__device__ void gemm_tile(const Gather& gather, const int8_t* __restrict__ w,
                          int M, int K, int N, int m0, int n0, int c0, int c1,
                          Smem& sm, int* __restrict__ out) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int kwords = K / 4;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  typename Gather::Pix px[A_PER];
#pragma unroll
  for (int i = 0; i < A_PER; ++i) {
    px[i] = gather.pixel(m0 + tid / KCW + i * (THREADS / KCW), M);
  }
  int ra[A_PER], rw[W_PER][4];
  load_chunk(gather, px, w, N, kwords, n0, c0 * KCW, ra, rw);
  for (int c = c0; c < c1; ++c) {
    store_chunk(sm, ra, rw);
    __syncthreads();
    if (c + 1 < c1) {
      load_chunk(gather, px, w, N, kwords, n0, (c + 1) * KCW, ra, rw);
    }
#pragma unroll
    for (int q = 0; q < KCW; ++q) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.a[ty * 4 + i][q];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sm.w[tx + 16 * j][q];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < M && n < N && acc[i][j] != 0) {
        atomicAdd(out + static_cast<size_t>(m) * N + n, acc[i][j]);
      }
    }
  }
}

// A GEMM's work items: output tiles times slices of K, about one item per
// resident thread block, so that a small M still fills the card.
struct Split {
  int nt, slices, per_slice, chunks, items;
};

__device__ __forceinline__ Split split(int M, int K, int N) {
  Split s;
  s.nt = (N + TN - 1) / TN;
  const int tiles = ((M + TM - 1) / TM) * s.nt;
  s.chunks = (K / 4 + KCW - 1) / KCW;
  const int want = max(1, min(s.chunks, (static_cast<int>(gridDim.x) + tiles - 1) / tiles));
  s.per_slice = (s.chunks + want - 1) / want;
  s.slices = (s.chunks + s.per_slice - 1) / s.per_slice;
  s.items = tiles * s.slices;
  return s;
}

template <class Gather>
__device__ __forceinline__ void gemm_item(const Gather& gather, const int8_t* w,
                                          int M, int K, int N, const Split& s,
                                          int item, Smem& sm, int* out) {
  const int tile = item / s.slices, slice = item % s.slices;
  const int c0 = slice * s.per_slice;
  gemm_tile(gather, w, M, K, N, (tile / s.nt) * TM, (tile % s.nt) * TN, c0,
            min(s.chunks, c0 + s.per_slice), sm, out);
}

// One residual block, as the phases at the top of this file, over an H x W
// input; the convolutions accumulate into p.acc / p.accd (zeroed in P0), and
// each epilogue is an elementwise pass. `in` and `out` must not overlap.
// Ends after its last phase without a barrier.
template <bool DOWN>
__device__ void run_block(const ChainParams& p, const Block& b, int H, int W,
                          const void* in, int in_bf16, void* out, int out_bf16,
                          Smem& sm, cg::grid_group& grid) {
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
  const int k1 = (DOWN ? 16 : 9) * ci;
  const Split s1 = split(M, k1, co);
  for (int it = blockIdx.x; it < s1.items; it += gridDim.x) {
    if (DOWN) {
      gemm_item(Conv3x3S2{p.xs, H, W, ci}, b.w1, M, k1, co, s1, it, sm, p.acc);
    } else {
      gemm_item(Conv3x3{p.xs, H, W, ci}, b.w1, M, k1, co, s1, it, sm, p.acc);
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
  const Split s2 = split(M, 9 * co, co);
  const Split sd = split(M, DOWN ? ci : 4, co);
  const int items = s2.items + (DOWN ? sd.items : 0);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    if (it < s2.items) {
      gemm_item(Conv3x3{p.hs, OH, OW, co}, b.w2, M, 9 * co, co, s2, it, sm, p.acc);
    } else {
      gemm_item(Pointwise{p.ds, ci}, b.wd, M, ci, co, sd, it - s2.items, sm, p.accd);
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

// Thread blocks of a cooperative launch that can be resident at once.
inline int grid_capacity(const void* kernel, int* cache) {
  if (*cache > 0) return *cache;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  *cache = sms * per_sm;
  return *cache;
}

// Fill `p` from the two flat host arrays every wrapper passes. Per block,
// 3 + NROWS pointers (w1, w2, wd, the rows) and 3 + NROWS ints (down, ci, co,
// the row lengths); then the pointers x, out, act0, act1, xs, hs, ds, acc,
// accd, wfc, bfc, pooled and the ints n, h, w, act1, act2, pre,
// zero_to_one, x_bf16, out_bf16, prm_bf16, classes.
inline int setup(ChainParams& p, int nblocks, const void* const* ptrs,
                 const int* ints) {
  if (nblocks < 1 || nblocks > MAX_BLOCKS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.nblocks = nblocks;
  for (int i = 0; i < nblocks; ++i, ptrs += 3 + NROWS, ints += 3 + NROWS) {
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
    for (int r = 0; r < NROWS; ++r) {
      b.ptr[r] = ptrs[3 + r];
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
// be resident; a plain launch of a kernel with grid barriers could
// deadlock, so there is none. `Params` is the kernel's one argument (a
// ChainParams, or a kernel's own struct). Returns the CUDA error code.
template <class Params>
inline int launch(const void* kernel, int* capacity_cache, Params& p,
                  void* stream) {
  const int cap = grid_capacity(kernel, capacity_cache);
  if (cap <= 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, dim3(cap), dim3(THREADS), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bnn
