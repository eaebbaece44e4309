// Stride-1 binary Bottleneck (ResNet-50's block) in one kernel, hand-written
// for Hopper (sm_90a).
//
// Replaces bnn_tpu/kernels/bottleneck.py:fused_bottleneck (a Pallas TPU
// kernel that runs the block over row slabs held in VMEM, the two 1x1 convs
// as single MXU dots):
//
//   y1  = act1(conv1x1(sign(x - thr1), w1) * s1 + a1)
//   y2  = act2(conv3x3(sign(y1 - thr2), w2) * s2 + a2)
//   y3  = conv1x1(sign(y2 - thr3), w3) * s3 + a3
//   r   = x, or conv1x1(sign(x - thrd), wd) * sd + ad (projection)
//   out = act3(y3 + r)
//
// x is (N, H, W, C) NHWC, f32 or bf16; out (N, H, W, C_out). The GEMMs read
// K-major int8 copies of the weights that kernels/bottleneck.py's
// BottleneckDesc keeps per device: w1t (width, C), w2t (width, 9 * width)
// in (dy, dx, c) order, w3t (C_out, width), wdt (C_out, C). C, width and
// C_out are multiples of 4, and M * max(C, width, C_out) < 2^31 (the
// elementwise passes index in 32 bits).
//
// Bound on an H100 at batch 1: the int8 weights are 69.6 KB per layer1 block
// and 4.46 MB per layer4 block; with the bf16 input and output the bytes
// bound a call to 0.6-1.5 us (the 0.44 G int8 operations take 0.22 us at
// the tensor-core peak); at batch 4, 1.3-3.9 us, bytes still. The design is
// fused_chain's (bnn_common.cuh): one cooperative launch whose phases are
// split by grid barriers, every conv an implicit GEMM on MmaTile (mma.sync
// m16n8k32 s8 on 32x64 tiles over a cp.async ring) whose tiles and K slices
// spread over the card, the signed maps as int8 scratch that stays in the
// 50 MB L2:
//
//   P0  xs = sign(x - thr1); ds = sign(x - thrd) (projection); zero the sums
//       of the GEMMs that are split over K
//   P1  conv1 over xs, and the projection over ds, which reads the same
//       input; then hs1 = sign(act1(...) - thr2)
//   P2  conv2 (3x3) over hs1; then hs2 = sign(act2(...) - thr3)
//   P3  conv3 over hs2, then the epilogues, the residual add and act3
//
// What the time goes to is the phases, not the products: a grid barrier
// costs about 2.7 ns per resident block, and a GEMM phase some microseconds
// of latency whatever its size. So a launch takes one block per output tile
// of the widest GEMM, 2 to 4 an SM (grid_for), and the four splits
// (mma_split: half an item per block) are worked out once. A GEMM that is
// one K slice stores its sums, so only a sliced one needs its buffer zeroed
// and adds with atomics; at batch 4 every GEMM of layer1 is one slice.
// Where conv3 is one slice (every call of ResNet-50 at batch 4, layers 1
// and 2 at batch 1), its tile applies P3's epilogue in registers and
// writes `out`: no int32 sums, no pass and no barrier after it. Epilogue
// rows are read two or four channels at a time. The projection runs in P1,
// beside conv1's quarter-width output, so that P1 and P3 carry about the
// same number of work items. Five or six grid barriers per call.
#include "bnn_common.cuh"

namespace {

// epilogue rows, in bnn_tpu_torch/kernels/bottleneck.py's ROWS order
enum Row { S1, A1, P1, THR2, S2, A2, P2, THR3, S3, A3, P3, SD, AD, THR1, THRD, NROWS };

// The flat arguments. ptrs: x, out, w1, w2, w3, wd (the JAX layouts; the
// kernel reads only wd's nullness), their K-major copies at PTR_WT (w1t,
// w2t, w3t, wdt), the NROWS rows at PTR_ROWS, then the scratch xs, ds, hs1,
// hs2, acc, acc3, accd at PTR_SCRATCH. ints: n, h, w, c, width, cout,
// projection, act1, act2, act3, zero_to_one, x_bf16, out_bf16, prm_bf16,
// then the NROWS row lengths at INT_ROWS.
constexpr int PTR_WT = 6;
constexpr int PTR_ROWS = PTR_WT + 4;
constexpr int PTR_SCRATCH = PTR_ROWS + NROWS;
constexpr int INT_ROWS = 14;

struct Params {
  int n, h, w, c, width, cout, projection;
  int act1, act2, act3, zero_to_one, x_bf16, out_bf16, prm_bf16;
  const void* x;
  void* out;
  const int8_t* w1t;  // (width, C)
  const int8_t* w2t;  // (width, 9 * width)
  const int8_t* w3t;  // (C_out, width)
  const int8_t* wdt;  // (C_out, C), or null
  const void* ptr[NROWS];  // a row of length 0 takes its default, of 1 is broadcast
  int len[NROWS];
  int8_t* xs;   // (M, C) signed input
  int8_t* ds;   // (M, C) signed projection input
  int8_t* hs1;  // (M, width) signed conv1 output
  int8_t* hs2;  // (M, width) signed conv2 output
  int* acc;     // (M, width) int32 sums of conv1, then of conv2
  int* acc3;    // (M, C_out) int32 sums of conv3 (a sliced conv3 only)
  int* accd;    // (M, C_out) int32 sums of the projection
};

// The GEMMs' work items on a grid of `grid` blocks
struct Plan {
  bnn::Split s1, sd, s2, s3;  // conv1, the projection, conv2, conv3
};

__host__ __device__ inline Plan make_plan(int grid, int M, int C, int Wd, int Co) {
  return {bnn::mma_split_of(grid, M, C, Wd), bnn::mma_split_of(grid, M, C, Co),
          bnn::mma_split_of(grid, M, 9 * Wd, Wd), bnn::mma_split_of(grid, M, Wd, Co)};
}

// Values c .. c + K - 1 (c % K == 0) of an epilogue row: its default where
// the row has length 0, its one value where it has length 1, else one
// K-wide load where the row is aligned to it and K loads where not
template <int K>
__device__ __forceinline__ void row_at(const void* ptr, int len, int c, float dflt,
                                       int bf16, float (&v)[K]) {
  static_assert(K == 2 || K == 4, "two or four values");
  const uintptr_t a = reinterpret_cast<uintptr_t>(ptr);
  if (len <= 1) {
    const float u = len == 0 ? dflt : bnn::ldf(ptr, 0, bf16);
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = u;
  } else if (bf16 && a % (2 * K) == 0) {
    const __nv_bfloat162* b = static_cast<const __nv_bfloat162*>(ptr) + c / 2;
    __nv_bfloat162 w[K / 2];
    if constexpr (K == 2) {
      w[0] = b[0];
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(b);
      w[0] = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
      w[1] = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
    }
#pragma unroll
    for (int k = 0; k < K / 2; ++k) {
      const float2 f = __bfloat1622float2(w[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  } else if (!bf16 && a % (4 * K) == 0) {
    if constexpr (K == 2) {
      const float2 f = static_cast<const float2*>(ptr)[c / 2];
      v[0] = f.x;
      v[1] = f.y;
    } else {
      const float4 f = static_cast<const float4*>(ptr)[c / 4];
      v[0] = f.x;
      v[1] = f.y;
      v[2] = f.z;
      v[3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = bnn::ldf(ptr, c + k, bf16);
  }
}

// row_at of row r of the kernel's parameters, with the row's default
template <int K>
__device__ __forceinline__ void row(const Params& p, int r, int c, float (&v)[K]) {
  const float dflt = (r == S1 || r == S2 || r == S3 || r == SD) ? 1.f
                     : (r == P1 || r == P2 || r == P3)          ? 0.25f
                                                                : 0.f;
  row_at(p.ptr[r], p.len[r], c, dflt, p.prm_bf16, v);
}

// P3's epilogue: out = act3(conv3 * s3 + a3 + r), r the block input or the
// projection's epilogue. Holds its parameters by value: as the sink of
// conv3's tile it keeps them in registers, where a pointer to the kernel's
// parameters loads them anew for each column pair (measured slower).
struct Conv3Out {
  const void* x;
  const int* accd;
  void* out;
  const void* ptr[5];  // rows S3, A3, P3, SD, AD
  int len[5];
  int cout, projection, act3, x_bf16, out_bf16, prm_bf16;

  static __device__ __forceinline__ Conv3Out of(const Params& p) {
    return {p.x, p.accd, p.out,
            {p.ptr[S3], p.ptr[A3], p.ptr[P3], p.ptr[SD], p.ptr[AD]},
            {p.len[S3], p.len[A3], p.len[P3], p.len[SD], p.len[AD]},
            p.cout, p.projection, p.act3, p.x_bf16, p.out_bf16, p.prm_bf16};
  }

  // The rows' values at channels n .. n + K - 1: [row][k], rows S3, A3,
  // P3, SD, AD
  template <int K>
  __device__ __forceinline__ void rows(int n, float (&r)[5][K]) const {
    const float dflt[5] = {1.f, 0.f, 0.25f, 1.f, 0.f};
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      if (j < 3 || projection) row_at(ptr[j], len[j], n, dflt[j], prm_bf16, r[j]);
    }
  }

  // act3(y3 + r) for conv3's sum v and the shortcut's value (the
  // projection sum d, or the block input xv), column k of rows r
  template <int K>
  __device__ __forceinline__ float value(int v, int d, float xv, const float (&r)[5][K],
                                         int k) const {
    const float y3 = bnn::epilogue(v, r[0][k], r[1][k]);
    const float res = projection ? bnn::epilogue(d, r[3][k], r[4][k]) : xv;
    return bnn::act(__fadd_rn(y3, res), act3, r[2][k]);
  }

  // the sink of a one-slice conv3 tile: a lane's sums of columns n, n + 1
  // in rows m and (where `lower`) m + 8, in registers
  __device__ __forceinline__ void operator()(int m, int n, const int (&v)[4],
                                             bool lower) const {
    float r[5][2];
    rows(n, r);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && !lower) break;
      const int i = (m + 8 * h) * cout + n;  // even: one 4- or 8-byte store
      int2 d = make_int2(0, 0);
      float2 xv = make_float2(0.f, 0.f);
      if (projection) {
        d = *reinterpret_cast<const int2*>(accd + i);
      } else {
        xv = make_float2(bnn::ldf(x, i, x_bf16), bnn::ldf(x, i + 1, x_bf16));
      }
      const float o0 = value(v[2 * h], d.x, xv.x, r, 0);
      const float o1 = value(v[2 * h + 1], d.y, xv.y, r, 1);
      if (out_bf16) {
        static_cast<__nv_bfloat162*>(out)[i / 2] = __floats2bfloat162_rn(o0, o1);
      } else {
        static_cast<float2*>(out)[i / 2] = make_float2(o0, o1);
      }
    }
  }
};

// sign(act(acc * s + a) - thr) of conv1 (mid = 0) or conv2 (mid = 1), for
// four int32 sums of channels n..n+3, as one int8 word
__device__ __forceinline__ int sign4(const Params& p, int mid, int4 a, int n) {
  float s[4], ad[4], pr[4], t[4];
  row(p, mid ? S2 : S1, n, s);
  row(p, mid ? A2 : A1, n, ad);
  row(p, mid ? P2 : P1, n, pr);
  row(p, mid ? THR3 : THR2, n, t);
  const int v[4] = {a.x, a.y, a.z, a.w};
  int g[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float y = bnn::act(bnn::epilogue(v[e], s[e], ad[e]), mid ? p.act2 : p.act1, pr[e]);
    g[e] = bnn::sign_i8(y, t[e], p.zero_to_one);
  }
  return bnn::pack4(g[0], g[1], g[2], g[3]);
}

__global__ void __launch_bounds__(bnn::THREADS)
fused_bottleneck_kernel(const __grid_constant__ Params p) {
  __shared__ bnn::MmaTile::Smem sm;
  bnn::cg::grid_group grid = bnn::cg::this_grid();
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthr = gridDim.x * blockDim.x;
  const int M = p.n * p.h * p.w, C = p.c, Wd = p.width, Co = p.cout;
  const Plan pl = make_plan(gridDim.x, M, C, Wd, Co);
  const bool tile3 = pl.s3.slices == 1;  // conv3's epilogue in its tile
  // the elementwise passes take four channels (one int8 word) a thread
  const int nin = M * C / 4, nmid = M * Wd / 4, nout = M * Co / 4;
  const int4 zero = make_int4(0, 0, 0, 0);
  int4* const acc = reinterpret_cast<int4*>(p.acc);
  const auto zeros = [&](int* buf, int n) {
    for (int g = gtid; g < n; g += nthr) reinterpret_cast<int4*>(buf)[g] = zero;
  };

  // P0: signs of the block input; zero the sums of the sliced GEMMs
  for (int g = gtid; g < nin; g += nthr) {
    const int i = 4 * g, c = i % C;
    float t1[4], td[4];
    row(p, THR1, c, t1);
    row(p, THRD, c, td);
    int s[4], d[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = bnn::ldf(p.x, i + e, p.x_bf16);
      s[e] = bnn::sign_i8(v, t1[e], p.zero_to_one);
      d[e] = bnn::sign_i8(v, td[e], p.zero_to_one);
    }
    reinterpret_cast<int*>(p.xs)[g] = bnn::pack4(s[0], s[1], s[2], s[3]);
    if (p.projection) reinterpret_cast<int*>(p.ds)[g] = bnn::pack4(d[0], d[1], d[2], d[3]);
  }
  if (pl.s1.slices > 1) zeros(p.acc, nmid);
  if (pl.s3.slices > 1) zeros(p.acc3, nout);
  if (p.projection && pl.sd.slices > 1) zeros(p.accd, nout);
  grid.sync();

  // P1: conv1 into acc, the projection into accd
  const int items1 = pl.s1.items + (p.projection ? pl.sd.items : 0);
  for (int it = blockIdx.x; it < items1; it += gridDim.x) {
    if (it < pl.s1.items) {
      bnn::MmaTile::item(bnn::Pointwise{p.xs, C}, p.w1t, M, C, Wd, pl.s1, it, sm, p.acc);
    } else {
      bnn::MmaTile::item(bnn::Pointwise{p.ds, C}, p.wdt, M, C, Co, pl.sd,
                         it - pl.s1.items, sm, p.accd);
    }
  }
  grid.sync();
  // ... epilogue -> act1 -> sign; acc is zeroed again for a sliced conv2
  for (int g = gtid; g < nmid; g += nthr) {
    reinterpret_cast<int*>(p.hs1)[g] = sign4(p, 0, acc[g], 4 * g % Wd);
    if (pl.s2.slices > 1) acc[g] = zero;
  }
  grid.sync();

  // P2: conv2 (3x3, pad 1: the padded taps read 0 after the sign) into acc
  for (int it = blockIdx.x; it < pl.s2.items; it += gridDim.x) {
    bnn::MmaTile::item(bnn::Conv3x3{p.hs1, p.h, p.w, Wd}, p.w2t, M, 9 * Wd, Wd, pl.s2,
                       it, sm, p.acc);
  }
  grid.sync();
  // ... epilogue -> act2 -> sign
  for (int g = gtid; g < nmid; g += nthr) {
    reinterpret_cast<int*>(p.hs2)[g] = sign4(p, 1, acc[g], 4 * g % Wd);
  }
  grid.sync();

  // P3: conv3, finished in its tiles where it is one slice ...
  if (tile3) {
    for (int it = blockIdx.x; it < pl.s3.items; it += gridDim.x) {
      bnn::MmaTile::item_to(bnn::Pointwise{p.hs2, Wd}, p.w3t, M, Wd, Co, pl.s3, it, sm,
                            Conv3Out::of(p));
    }
    return;
  }
  // ... else summed into acc3, then the epilogues, the residual add and act3
  for (int it = blockIdx.x; it < pl.s3.items; it += gridDim.x) {
    bnn::MmaTile::item(bnn::Pointwise{p.hs2, Wd}, p.w3t, M, Wd, Co, pl.s3, it, sm, p.acc3);
  }
  grid.sync();
  const Conv3Out out3 = Conv3Out::of(p);
  for (int g = gtid; g < nout; g += nthr) {
    const int i = 4 * g, n = i % Co;
    const int4 a = reinterpret_cast<const int4*>(p.acc3)[g];
    const int4 d = p.projection ? reinterpret_cast<const int4*>(p.accd)[g] : zero;
    const int v[4] = {a.x, a.y, a.z, a.w}, dv[4] = {d.x, d.y, d.z, d.w};
    float r[5][4];
    out3.rows(n, r);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float xv = p.projection ? 0.f : bnn::ldf(p.x, i + e, p.x_bf16);
      bnn::stf(p.out, i + e, out3.value(v[e], dv[e], xv, r, e), p.out_bf16);
    }
  }
}

int capacity = 0;  // resident blocks

// The blocks of a launch over M pixels, by the tiles of the widest GEMM
// (bnn::grid_for)
int grid_for(int M, int width, int cout) {
  return bnn::grid_for(reinterpret_cast<const void*>(&fused_bottleneck_kernel),
                       &capacity, M, width > cout ? width : cout);
}

// Params from the flat arrays (see PTR_WT); returns the CUDA error code
int fill(Params& p, const void* const* ptrs, const int* ints) {
  p.n = ints[0];
  p.h = ints[1];
  p.w = ints[2];
  p.c = ints[3];
  p.width = ints[4];
  p.cout = ints[5];
  p.projection = ints[6];
  p.act1 = ints[7];
  p.act2 = ints[8];
  p.act3 = ints[9];
  p.zero_to_one = ints[10];
  p.x_bf16 = ints[11];
  p.out_bf16 = ints[12];
  p.prm_bf16 = ints[13];
  for (int r = 0; r < NROWS; ++r) {
    p.ptr[r] = ptrs[PTR_ROWS + r];
    p.len[r] = ints[INT_ROWS + r];
  }
  const long long m = static_cast<long long>(p.n) * p.h * p.w;
  const int widest = p.c > p.width ? (p.c > p.cout ? p.c : p.cout)
                                   : (p.width > p.cout ? p.width : p.cout);
  if (p.n < 1 || p.h < 1 || p.w < 1 || p.c % 4 || p.width % 4 || p.cout % 4 ||
      p.c < 4 || p.width < 4 || p.cout < 4 || m * widest >= (1LL << 31) ||
      !ptrs[PTR_WT] || !ptrs[PTR_WT + 1] || !ptrs[PTR_WT + 2] ||
      (p.projection ? ptrs[5] == nullptr || ptrs[PTR_WT + 3] == nullptr
                    : p.c != p.cout)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.x = ptrs[0];
  p.out = const_cast<void*>(ptrs[1]);
  p.w1t = static_cast<const int8_t*>(ptrs[PTR_WT]);
  p.w2t = static_cast<const int8_t*>(ptrs[PTR_WT + 1]);
  p.w3t = static_cast<const int8_t*>(ptrs[PTR_WT + 2]);
  p.wdt = static_cast<const int8_t*>(ptrs[PTR_WT + 3]);
  const void* const* s = ptrs + PTR_SCRATCH;
  p.xs = static_cast<int8_t*>(const_cast<void*>(s[0]));
  p.ds = static_cast<int8_t*>(const_cast<void*>(s[1]));
  p.hs1 = static_cast<int8_t*>(const_cast<void*>(s[2]));
  p.hs2 = static_cast<int8_t*>(const_cast<void*>(s[3]));
  p.acc = static_cast<int*>(const_cast<void*>(s[4]));
  p.acc3 = static_cast<int*>(const_cast<void*>(s[5]));
  p.accd = static_cast<int*>(const_cast<void*>(s[6]));
  return 0;
}

}  // namespace

// One Bottleneck: the flat arrays (see PTR_WT). Returns the CUDA error code.
extern "C" int bnn_fused_bottleneck(const void* const* ptrs, const int* ints,
                                    void* stream) {
  Params p{};
  const int err = fill(p, ptrs, ints);
  if (err) return err;
  return bnn::launch(reinterpret_cast<const void*>(&fused_bottleneck_kernel),
                     &capacity, p, stream, grid_for(p.n * p.h * p.w, p.width, p.cout));
}

// The launch plan on the current device for the ints of a call: out[0] the
// blocks of the launch, then (tiles, K slices) of conv1, the projection,
// conv2 and conv3. Returns the CUDA error code.
extern "C" int bnn_fused_bottleneck_plan(const int* ints, int* out) {
  const int m = ints[0] * ints[1] * ints[2];
  const int grid = grid_for(m, ints[4], ints[5]);
  if (grid <= 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const Plan pl = make_plan(grid, m, ints[3], ints[4], ints[5]);
  const bnn::Split* s[4] = {&pl.s1, &pl.sd, &pl.s2, &pl.s3};
  out[0] = grid;
  for (int j = 0; j < 4; ++j) {
    out[1 + 2 * j] = s[j]->items / s[j]->slices;
    out[2 + 2 * j] = s[j]->slices;
  }
  return 0;
}
