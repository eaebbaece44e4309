// A deployed binary convolution as one implicit GEMM, hand-written for
// Hopper (sm_90a):
//
//   out = conv(s(x), w) * scale + add
//
// for groups 1, dilation 1, any stride and static zero padding, over a
// kh x kw kernel, in NHWC. s(x) is the deployed layer's sign of x against an
// optional per-in-channel threshold: ternary (x > t) - (x < t), or with
// zero_to_one x >= t ? +1 : -1. The conv's padding comes after the sign, so
// padded taps add exactly 0.
//
// It replaces no TPU kernel: the JAX package leaves this conv to XLA's int8
// lax.conv (bnn_tpu/inference/deploy.py DeployedConv, mode "conv"). In the
// port it replaces the plain path's sign, F.unfold patch matrix, int8 cast,
// torch._int_mm and three-step epilogue (kernels/conv.py
// binary_conv2d_reference), which at batch 64 built, reordered and cast a
// patch matrix of up to 231 MB a layer in several launches an image.
//
// x: (N, H, W, C) f32 or bf16; wt: (O, kh*kw*Cp) int8 +/-1, each output
// channel's weights K-contiguous in (dy, dx, c) order with every tap's
// channels zero-padded to Cp = cchunks * KC (kernels/conv.py
// conv2d_weight_operand); thr: (C,) f32 or bf16, or null for 0; scale,
// add: (O,) in the output's dtype, f32 or bf16; out: (N, OH, OW, O) in that
// dtype. The sums are exact in int32. The epilogue rounds as torch's
// acc.to(dtype) * scale + add rounds, each step apart: in bf16
// bf16(float(acc)), then bf16(v * scale), then bf16(v + add), each product
// and sum taken in f32; in f32 __fmul_rn then __fadd_rn. So the result is
// bit-identical to the plain version.
//
// Bound on an H100 at a ResNet-50's batch-64 convs: a stage-1 3x3 conv
// (64, 56, 56, 64) -> 64 moves 25.7 MB of bf16 x in and 25.7 MB out (15 us
// at 3.35 TB/s) against 14.8 G int8 operations (7.5 us at 1,979 TOP/s);
// summed over the 25 mode-conv layers of a forward, bytes bound it at
// 0.40 ms. At these shapes the kernel is bound by its instructions a
// product (gathering, signing, masking) and by L2 re-reads of x across
// taps and output-channel tiles, 6-10x over that bound.
//
// Design: M = N*OH*OW output pixels (the rows of out), N = O, K = kh*kw*C.
// - mma.sync m16n8k32 s8 x s8 -> s32 (mma_s8.cuh) on BM x BN block tiles
//   (128x128, 128x64, 64x128, 64x64; the host plan picks by M, O and K),
//   each warp 16 rows by all BN columns: a raw x value is signed by one
//   warp, once.
// - K walks in chunks of one tap (dy, dx) and KC = 64 channels. A chunk's A
//   tile is BM rows of KC raw channels of x: for output pixel (n, oy, ox)
//   the input pixel (n, oy*sh - ph + dy, ox*sw - pw + dx), at any stride,
//   gathered row by row with 16-byte cp.async copies (element by element
//   where C or the pointer forbid them). Rows whose tap lies outside the
//   image are zero-filled and, since a raw 0 would sign to +1 (or to
//   sign(-t)), masked to 0 as the fragments are built: padding adds 0 whatever
//   the convention. Channels past C are zero in the weight operand and add
//   nothing.
// - The weight rows of a chunk are the KC bytes at q*KC of each output
//   channel's operand row (chunk q in (dy, dx, cc) order), 16-byte cp.async
//   copies.
// - A 3-stage ring: two chunks are in flight while one is multiplied, one
//   barrier a chunk. The x a block re-reads for the next taps of a 3x3
//   kernel comes from L2.
// - x is signed in registers as the A fragments are built: without a
//   threshold four bf16 at a time by packed comparisons with 0
//   (mma_s8.cuh s8x8), else value by value against the channels'
//   thresholds in f32 (exactly torch's comparison of either dtype).
// - K is permuted inside each 32-deep step (lane group t takes K 8t..8t+7
//   of both operands, as in binary_gemm), so each fragment is one 16-byte
//   read of raw x (8-byte of weights); x rows are padded so that those reads
//   hit distinct banks (binary_conv2d_s1's pitch).
// - Data types, tile and loader are template arguments; the sign convention
//   and the threshold's presence and type are uniform runtime flags.
#include "mma_s8.cuh"

namespace {

constexpr int KC = 64;          // channels per chunk of K
constexpr int B_PITCH = KC + 32;  // bytes per shared-memory row of weights
constexpr int STAGES = 3;
constexpr int MAX_SMEM = 232448;

// Shared-memory row of raw x, in elements: padded so that the fragment
// reads (16 bytes a lane, two rows per eight lanes) hit distinct banks and
// every row starts on 16 bytes (binary_conv2d_s1.cu's X_ROW)
template <typename T>
constexpr int X_ROW = KC + (sizeof(T) == 2 ? 32 : 4);

struct Params {
  const void* x;
  const int8_t* w;    // (O, kh * kw * cchunks * KC)
  const void* thr;    // (C,) or null
  const void* scale;  // (O,)
  const void* add;    // (O,)
  void* out;          // (M, O)
  int M, H, W, C, OH, OW, O, kh, kw, sh, sw, ph, pw, cchunks;
  int thr_bf16, zero_to_one;
};

template <int BM_, int BN_, int WMW_, int WNW_, int MINB_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WMW = WMW_, WNW = WNW_;
  static constexpr int THREADS = 32 * WMW * WNW;
  static constexpr int WM = BM / WMW, WN = BN / WNW;  // a warp's tile
  static constexpr int MT = WM / 16, NT = WN / 8;     // its m16n8 fragments
  static constexpr int MINB = MINB_;                  // resident blocks aimed at
};

// one warp a 16-row slice of the tile and all of its columns, so that each
// raw x value is signed once a block
using Tile128x128 = Tile<128, 128, 8, 1, 2>;
using Tile128x64 = Tile<128, 64, 8, 1, 2>;
using Tile64x128 = Tile<64, 128, 4, 1, 3>;
using Tile64x64 = Tile<64, 64, 4, 1, 4>;

template <typename TL, typename T>
struct Smem {
  static constexpr int A_STAGE = TL::BM * X_ROW<T> * static_cast<int>(sizeof(T));
  static constexpr int B_STAGE = TL::BN * B_PITCH;
  // the rows' input origins, then the ring
  static constexpr int BYTES =
      TL::BM * static_cast<int>(sizeof(int4)) + STAGES * (A_STAGE + B_STAGE);
};

__device__ __forceinline__ float threshold(const Params& p, int c) {
  if (c >= p.C) return 0.f;
  if (p.thr_bf16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p.thr)[c]);
  }
  return static_cast<const float*>(p.thr)[c];
}

// s(v - t) of one value as an int8 byte, the layer's convention
__device__ __forceinline__ uint32_t sign_byte(float v, float t, bool zto) {
  if (zto) return v >= t ? 0x01u : 0xFFu;
  return v > t ? 0x01u : (v < t ? 0xFFu : 0u);
}

__device__ __forceinline__ float raw_value(const float* v, int j) { return v[j]; }
__device__ __forceinline__ float raw_value(const __nv_bfloat16* v, int j) {
  return __bfloat162float(v[j]);
}

// the signed bytes of the eight raw values at v (channels c .. c + 7) as
// two words of four int8, values 0-3 and 4-7
template <typename T>
__device__ __forceinline__ void sign8(const T* v, const Params& p, int c,
                                      uint32_t& lo, uint32_t& hi) {
  if (p.thr == nullptr) {
    if (p.zero_to_one) {
      s8x8<true>(v, lo, hi);
    } else {
      s8x8<false>(v, lo, hi);
    }
    return;
  }
  const bool zto = p.zero_to_one != 0;
  lo = hi = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lo |= sign_byte(raw_value(v, j), threshold(p, c + j), zto) << (8 * j);
    hi |= sign_byte(raw_value(v, 4 + j), threshold(p, c + 4 + j), zto) << (8 * j);
  }
}

// Chunk q of the x rows and the weight rows into a stage of the ring.
template <typename TL, typename T, bool VEC>
__device__ __forceinline__ void load_chunk(const Params& p, const int4* rows,
                                           T* __restrict__ xs,
                                           int8_t* __restrict__ ws, int tid,
                                           int n0, int q) {
  constexpr int XR = X_ROW<T>;
  const int tap = q / p.cchunks, cc = q - tap * p.cchunks;
  const int dy = tap / p.kw, dx = tap - dy * p.kw, c0 = cc * KC;
  const int shift = dy * p.W + dx;
  const T* x = static_cast<const T*>(p.x);
  if constexpr (VEC) {
    constexpr int PER = 16 / sizeof(T);   // values per copy
    constexpr int VPR = KC / PER;         // copies per row
    constexpr int RPP = TL::THREADS / VPR;  // rows per pass
    static_assert(TL::THREADS % VPR == 0 && TL::BM % RPP == 0, "loader shape");
    const int col = (tid % VPR) * PER;
#pragma unroll
    for (int i = 0; i < TL::BM / RPP; ++i) {
      const int r = tid / VPR + i * RPP;
      const int4 o = rows[r];  // (pixel, iy, ix, -)
      // C is a multiple of PER here, so a copy lies in one pixel
      const bool ok = static_cast<unsigned>(o.y + dy) < static_cast<unsigned>(p.H) &&
                      static_cast<unsigned>(o.z + dx) < static_cast<unsigned>(p.W) &&
                      c0 + col < p.C;
      const T* src = ok ? x + static_cast<size_t>(o.x + shift) * p.C + c0 + col : x;
      cp_async16(xs + r * XR + col, src, ok ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < TL::BM * KC; idx += TL::THREADS) {
      const int r = idx / KC, c = idx % KC;
      const int4 o = rows[r];
      const bool ok = static_cast<unsigned>(o.y + dy) < static_cast<unsigned>(p.H) &&
                      static_cast<unsigned>(o.z + dx) < static_cast<unsigned>(p.W) &&
                      c0 + c < p.C;
      xs[r * XR + c] =
          ok ? x[static_cast<size_t>(o.x + shift) * p.C + c0 + c] : zero_value<T>();
    }
  }
  constexpr int PER_ROW = KC / 16;
  const size_t row = static_cast<size_t>(p.kh) * p.kw * p.cchunks * KC;
  for (int idx = tid; idx < TL::BN * PER_ROW; idx += TL::THREADS) {
    const int r = idx / PER_ROW, col = (idx % PER_ROW) * 16;
    const bool ok = n0 + r < p.O;
    const int8_t* src =
        ok ? p.w + (n0 + r) * row + static_cast<size_t>(q) * KC + col : p.w;
    cp_async16(ws + r * B_PITCH + col, src, ok ? 16 : 0);
  }
}

template <typename OUT>
struct Epilogue;

template <>
struct Epilogue<float> {
  __device__ __forceinline__ static float apply(int acc, const Params& p, int n) {
    const float s = static_cast<const float*>(p.scale)[n];
    const float a = static_cast<const float*>(p.add)[n];
    return __fadd_rn(__fmul_rn(static_cast<float>(acc), s), a);
  }
  __device__ __forceinline__ static void store2(float* dst, float v0, float v1) {
    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
  }
};

template <>
struct Epilogue<__nv_bfloat16> {
  __device__ __forceinline__ static __nv_bfloat16 apply(int acc, const Params& p, int n) {
    const float s = __bfloat162float(static_cast<const __nv_bfloat16*>(p.scale)[n]);
    const float a = __bfloat162float(static_cast<const __nv_bfloat16*>(p.add)[n]);
    const float v = __bfloat162float(__float2bfloat16_rn(static_cast<float>(acc)));
    const float m = __bfloat162float(__float2bfloat16_rn(__fmul_rn(v, s)));
    return __float2bfloat16_rn(__fadd_rn(m, a));
  }
  __device__ __forceinline__ static void store2(__nv_bfloat16* dst, __nv_bfloat16 v0,
                                                __nv_bfloat16 v1) {
    __nv_bfloat162 pair;
    pair.x = v0;
    pair.y = v1;
    *reinterpret_cast<__nv_bfloat162*>(dst) = pair;
  }
};

template <typename TL, typename T, typename OUT, bool VEC>
__global__ void __launch_bounds__(TL::THREADS, TL::MINB)
binary_conv2d_kernel(const __grid_constant__ Params p) {
  constexpr int MT = TL::MT, NT = TL::NT, XR = X_ROW<T>;
  using S = Smem<TL, T>;
  extern __shared__ __align__(16) unsigned char smem[];
  int4* rows = reinterpret_cast<int4*>(smem);
  unsigned char* ring = smem + TL::BM * sizeof(int4);
  T* xs = reinterpret_cast<T*>(ring);                               // STAGES A
  int8_t* ws = reinterpret_cast<int8_t*>(ring + STAGES * S::A_STAGE);  // STAGES B

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row / K group
  const int wm0 = (warp / TL::WNW) * TL::WM, wn0 = (warp % TL::WNW) * TL::WN;
  const int m0 = blockIdx.x * TL::BM, n0 = blockIdx.y * TL::BN;
  const int chunks = p.kh * p.kw * p.cchunks;

  // each row's input origin: pixel (n, oy*sh - ph, ox*sw - pw) and its (y, x)
  for (int r = tid; r < TL::BM; r += TL::THREADS) {
    const int m = m0 + r;
    int4 o = make_int4(0, -(1 << 20), -(1 << 20), 0);  // past M: never inside
    if (m < p.M) {
      const int img = m / (p.OH * p.OW), rem = m - img * p.OH * p.OW;
      const int oy = rem / p.OW, ox = rem - oy * p.OW;
      const int iy = oy * p.sh - p.ph, ix = ox * p.sw - p.pw;
      o = make_int4((img * p.H + iy) * p.W + ix, iy, ix, 0);
    }
    rows[r] = o;
  }
  __syncthreads();

  // this lane's fragment rows' input origins
  int fy[MT][2], fx[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int4 o = rows[wm0 + i * 16 + g + 8 * h];
      fy[i][h] = o.y;
      fx[i][h] = o.z;
    }

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
      load_chunk<TL, T, VEC>(p, rows, xs + s * (S::A_STAGE / sizeof(T)),
                             ws + s * S::B_STAGE, tid, n0, s);
    cp_async_commit();
  }
  for (int q = 0; q < chunks; ++q) {
    cp_async_wait<STAGES - 2>();  // chunk q has landed
    __syncthreads();              // ... for every thread, and q - 1 is done
    const int nq = q + STAGES - 1;
    if (nq < chunks) {
      const int st = nq % STAGES;
      load_chunk<TL, T, VEC>(p, rows, xs + st * (S::A_STAGE / sizeof(T)),
                             ws + st * S::B_STAGE, tid, n0, nq);
    }
    cp_async_commit();

    const int tap = q / p.cchunks, dy = tap / p.kw, dx = tap - dy * p.kw;
    const int c0 = (q - tap * p.cchunks) * KC;
    uint32_t mask[MT][2];  // 0 where the row's tap falls in the padding
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        mask[i][h] =
            static_cast<unsigned>(fy[i][h] + dy) < static_cast<unsigned>(p.H) &&
                    static_cast<unsigned>(fx[i][h] + dx) < static_cast<unsigned>(p.W)
                ? 0xFFFFFFFFu
                : 0u;
    const T* xc = xs + (q % STAGES) * (S::A_STAGE / sizeof(T));
    const int8_t* wc = ws + (q % STAGES) * S::B_STAGE;
#pragma unroll
    for (int ks = 0; ks < KC / 32; ++ks) {
      // this lane's K values: 8 t .. 8 t + 7 of the 32-deep step
      const int kk = ks * 32 + 8 * t;
      // fragment registers: row g K 0-3, row g+8 K 0-3, row g K 4-7,
      // row g+8 K 4-7 (of this lane's eight)
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const T* r0 = xc + (wm0 + i * 16 + g) * XR + kk;
        sign8(r0, p, c0 + kk, a[i][0], a[i][2]);
        sign8(r0 + 8 * XR, p, c0 + kk, a[i][1], a[i][3]);
        a[i][0] &= mask[i][0];
        a[i][2] &= mask[i][0];
        a[i][1] &= mask[i][1];
        a[i][3] &= mask[i][1];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint2 b =
            *reinterpret_cast<const uint2*>(wc + (wn0 + j * 8 + g) * B_PITCH + kk);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_s8(acc[i][j], a[i], b.x, b.y);
      }
    }
  }

  OUT* out = static_cast<OUT*>(p.out);
  const bool pairs = (p.O & 1) == 0;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm0 + i * 16 + g + 8 * h;
      if (m >= p.M) continue;
      OUT* row = out + static_cast<size_t>(m) * p.O;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + wn0 + j * 8 + 2 * t;
        if (n >= p.O) continue;
        const OUT v0 = Epilogue<OUT>::apply(acc[i][j][2 * h], p, n);
        if (pairs) {
          // O even: n + 1 < O and the pair starts on its own size
          Epilogue<OUT>::store2(row + n, v0,
                                Epilogue<OUT>::apply(acc[i][j][2 * h + 1], p, n + 1));
        } else {
          row[n] = v0;
          if (n + 1 < p.O) row[n + 1] = Epilogue<OUT>::apply(acc[i][j][2 * h + 1], p, n + 1);
        }
      }
    }
  }
}

template <typename TL, typename T, typename OUT, bool VEC>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int bytes = Smem<TL, T>::BYTES;
  static_assert(bytes <= MAX_SMEM, "tile does not fit shared memory");
  auto* kernel = binary_conv2d_kernel<TL, T, OUT, VEC>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const dim3 grid((p.M + TL::BM - 1) / TL::BM, (p.O + TL::BN - 1) / TL::BN);
  kernel<<<grid, TL::THREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename OUT, bool VEC>
int pick_tile(const Params& p, int bm, int bn, cudaStream_t stream) {
  if (bm == 128 && bn == 128) return launch<Tile128x128, T, OUT, VEC>(p, stream);
  if (bm == 128 && bn == 64) return launch<Tile128x64, T, OUT, VEC>(p, stream);
  if (bm == 64 && bn == 128) return launch<Tile64x128, T, OUT, VEC>(p, stream);
  if (bm == 64 && bn == 64) return launch<Tile64x64, T, OUT, VEC>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, typename OUT>
int pick_loader(const Params& p, int bm, int bn, int vector_loads,
                cudaStream_t stream) {
  return vector_loads ? pick_tile<T, OUT, true>(p, bm, bn, stream)
                      : pick_tile<T, OUT, false>(p, bm, bn, stream);
}

template <typename T>
int pick_out(const Params& p, int out_bf16, int bm, int bn, int vector_loads,
             cudaStream_t stream) {
  return out_bf16 ? pick_loader<T, __nv_bfloat16>(p, bm, bn, vector_loads, stream)
                  : pick_loader<T, float>(p, bm, bn, vector_loads, stream);
}

}  // namespace

// x: (N, H, W, C) bf16 when x_bf16 else f32; wt: (O, kh*kw*Cp) int8 with
// Cp = ceil(C / 64) * 64, 16-byte aligned; thr: (C,) bf16 when thr_bf16
// else f32, or null; scale, add, out: bf16 when out_bf16 else f32, out
// (N, OH, OW, O). The tile (bm x bn) and `vector_loads` (16-byte loads of x:
// the caller checks that C and the x pointer allow them) come from the host
// plan. Launches on `stream` and returns cudaGetLastError().
extern "C" int bnn_binary_conv2d(const void* x, int x_bf16, const void* wt,
                                 const void* thr, int thr_bf16,
                                 const void* scale, const void* add, void* out,
                                 int out_bf16, int N, int H, int W, int C,
                                 int O, int kh, int kw, int sh, int sw, int ph,
                                 int pw, int zero_to_one, int bm, int bn,
                                 int vector_loads, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || O < 1 || kh < 1 || kw < 1 ||
      sh < 1 || sw < 1 || ph < 0 || pw < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.OH = (H + 2 * ph - kh) / sh + 1;
  p.OW = (W + 2 * pw - kw) / sw + 1;
  if (p.OH < 1 || p.OW < 1) return static_cast<int>(cudaErrorInvalidValue);
  p.x = x;
  p.w = static_cast<const int8_t*>(wt);
  p.thr = thr;
  p.thr_bf16 = thr_bf16;
  p.scale = scale;
  p.add = add;
  p.out = out;
  p.M = N * p.OH * p.OW;
  p.H = H;
  p.W = W;
  p.C = C;
  p.O = O;
  p.kh = kh;
  p.kw = kw;
  p.sh = sh;
  p.sw = sw;
  p.ph = ph;
  p.pw = pw;
  p.cchunks = (C + KC - 1) / KC;
  p.zero_to_one = zero_to_one;
  const auto s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? pick_out<__nv_bfloat16>(p, out_bf16, bm, bn, vector_loads, s)
                : pick_out<float>(p, out_bf16, bm, bn, vector_loads, s);
}
