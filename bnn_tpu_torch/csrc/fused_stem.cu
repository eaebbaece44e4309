// Fused ResNet stem, hand-written for Hopper (sm_90a):
//
//   out = maxpool3x3/s2/p1(relu(conv7x7/s2/p3(x, w) + bias))
//
// Replaces bnn_tpu/kernels/stem.py:fused_stem_v3 (and serves the v1 and v2
// entry points, which compute the same function at other geometries). The
// TPU kernels cast the weights to x's dtype and contract on the MXU with f32
// sums; here the conv is an implicit GEMM on the bf16 tensor cores
// (stem_common.cuh: mma.sync m16n8k16 over K = (ky, kx, c), channels padded
// to 4), one pass for bf16 x and bf16 w, the serving dtype, and three or six
// passes over exact bf16 pieces of f32 operands.
//
// x: (N, H, W, C) NHWC, bf16 or f32, C <= 4, H and W even; wk: the weights
// as K-major bf16 pieces (pieces, o_pad, 208), kernels/stem.py's StemDesc;
// bias: (o_pad,) f32; out: (N, H/4, W/4, O) in bf16 or f32 (the entry
// points' out_dtype), either for either x: the pooled f32 sums are rounded
// once, by the store, so an f32 output of bf16 x never passes through bf16.
//
// Bound on an H100 at (8, 224, 224, 3) bf16 -> (8, 56, 56, 64): 2.4 MB in and
// 3.2 MB out (1.7 us at 3.35 TB/s) against 1.9 GFLOP (1.9 us at the bf16
// tensor-core rate). The padded K (208 for 147) and the tiles' overlap make
// this design's own work about 3.1 GFLOP. Design: a block is two warps, one
// work item at a time: `rows` pooled rows x 7 pooled columns x 64 channels
// (the conv's 2 * rows + 1 rows x 16 columns). It stages the item's input
// window in shared memory as bf16 pieces (4 channels a pixel, a pitch of 45
// pixels: conflict-free 64-bit reads); each warp keeps the A fragments of
// its 32 channels' weights in registers for the kernel's life (104 words a
// lane, loaded once per block), streams the conv rows through the tensor
// cores (2 window loads per 4 mma a k-step), and pools the sums as they
// come: a running max down each pooled row's three conv rows in registers,
// the 3-wide max across columns with one shuffle a value, then bias and
// relu, stores from registers. The conv map never touches shared or device
// memory. The grid is one block per item while they fit on the card at
// once (each loops over items past that); `rows` is chosen per call
// (stem::pick_rows): as many items in flight as the card holds, each as tall
// as that allows. The arithmetic is stem_common.cuh's, which
// fused_stem_chain.cu shares.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "stem_common.cuh"

namespace {

constexpr int WARPS = 2;
constexpr int THREADS = 32 * WARPS;
constexpr int MT = 2;                  // m-tiles a warp: 32 channels
constexpr int OCB = 16 * MT * WARPS;   // channels an item: 64
constexpr int MAX_ROWS = 8;            // pooled rows an item, at most

template <typename T>
__host__ __device__ constexpr int pieces() {
  return sizeof(T) == 2 ? 1 : 3;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

size_t smem_bytes(int nx, int rows) {
  return sizeof(uint2) * nx * (4 * rows + 7) * stem::WIN_W;
}

template <typename T, typename OT, int NW>
__global__ void __launch_bounds__(THREADS)
fused_stem_kernel(const T* __restrict__ x, const uint32_t* __restrict__ wk,
                  const float* __restrict__ bias, OT* __restrict__ out, int N,
                  int H, int W, int C, int O, int o_pad, int rows) {
  constexpr int NX = pieces<T>();
  extern __shared__ uint2 win[];  // NX pieces of (4 * rows + 7) x WIN_W
  const int hc = H / 2, wc = W / 2, hp = hc / 2, wp = wc / 2;
  const int tiles_y = (hp + rows - 1) / rows;
  const int tiles_x = (wp + stem::PC - 1) / stem::PC;
  const int groups = o_pad / OCB;
  const int items = N * tiles_y * tiles_x * groups;
  const int piece_px = (4 * rows + 7) * stem::WIN_W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  stem::Tile<NX, NW, MT> tile;
  float brow[MT][2];
  int loaded = -1;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    int r = it;
    const int grp = r % groups;
    r /= groups;
    const int q0 = (r % tiles_x) * stem::PC;
    r /= tiles_x;
    const int p0 = (r % tiles_y) * rows, n = r / tiles_y;
    const int o0 = grp * OCB + warp * 16 * MT;
    if (grp != loaded) {  // once per block where O <= 64
      tile.load(wk, o_pad, o0);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) brow[m][h] = bias[o0 + 16 * m + 8 * h + (lane >> 2)];
      }
      loaded = grp;
    }
    const int prows = min(rows, hp - p0);
    __syncthreads();  // the previous item is done with the window
    // conv row 2*p0 - 1 + i reads input rows 4*p0 - 5 + 2*i + ky
    stem::load_window<T, NX>(win, piece_px, x, n, H, W, C, 4 * p0 - 5,
                             4 * q0 - 5, 4 * prows + 7);
    __syncthreads();
    auto store = [&](int k, int j, int ch, float v) {
      const int p = p0 + k, q = q0 + j, o = o0 + ch;
      if (p < hp && q < wp && o < O) {
        store1(out + ((static_cast<size_t>(n) * hp + p) * wp + q) * O + o, v);
      }
    };
    stem::pooled_rows(tile, win, piece_px, brow, p0, q0, prows, hc, wc, store);
  }
}

struct Plan {
  int rows, items, grid, per_sm;
};

template <typename T, typename OT, int NW>
int plan_launch(int N, int H, int W, int o_pad, Plan& pl) {
  static int sms = 0;
  static int per_sm[MAX_ROWS + 1] = {};
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    for (int r = 1; r <= MAX_ROWS; ++r) {
      cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm[r], fused_stem_kernel<T, OT, NW>, THREADS,
          smem_bytes(pieces<T>(), r));
      if (err != cudaSuccess) {
        sms = 0;
        return static_cast<int>(err);
      }
    }
  }
  const int hp = H / 4, wp = W / 4, groups = o_pad / OCB;
  pl.rows = stem::pick_rows(N, hp, wp, groups, MAX_ROWS,
                            [&](int r) { return per_sm[r] * sms; });
  pl.per_sm = per_sm[pl.rows];
  if (pl.per_sm <= 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
  pl.items = N * ((hp + pl.rows - 1) / pl.rows) *
             ((wp + stem::PC - 1) / stem::PC) * groups;
  pl.grid = std::min(pl.items, pl.per_sm * sms);
  return 0;
}

template <typename T, typename OT, int NW>
int launch(const void* x, const void* wk, const void* bias, void* out, int N,
           int H, int W, int C, int O, int o_pad, cudaStream_t stream,
           Plan* plan_only) {
  Plan pl{};
  const int err = plan_launch<T, OT, NW>(N, H, W, o_pad, pl);
  if (err || plan_only) {
    if (plan_only) *plan_only = pl;
    return err;
  }
  if (pl.items == 0) return 0;
  fused_stem_kernel<T, OT, NW>
      <<<pl.grid, THREADS, smem_bytes(pieces<T>(), pl.rows), stream>>>(
          static_cast<const T*>(x), static_cast<const uint32_t*>(wk),
          static_cast<const float*>(bias), static_cast<OT*>(out), N, H, W, C,
          O, o_pad, pl.rows);
  return static_cast<int>(cudaGetLastError());
}

// the instance for the weights' pieces, then for the output's type
template <typename T, typename OT>
int launch_pieces(int w_pieces, const void* x, const void* wk, const void* bias,
                  void* out, int N, int H, int W, int C, int O, int o_pad,
                  cudaStream_t s, Plan* plan_only) {
  return w_pieces == 1
             ? launch<T, OT, 1>(x, wk, bias, out, N, H, W, C, O, o_pad, s, plan_only)
             : launch<T, OT, 3>(x, wk, bias, out, N, H, W, C, O, o_pad, s, plan_only);
}

template <typename T>
int launch_out(int out_bf16, int w_pieces, const void* x, const void* wk,
               const void* bias, void* out, int N, int H, int W, int C, int O,
               int o_pad, cudaStream_t s, Plan* plan_only) {
  return out_bf16
             ? launch_pieces<T, __nv_bfloat16>(w_pieces, x, wk, bias, out, N, H, W,
                                               C, O, o_pad, s, plan_only)
             : launch_pieces<T, float>(w_pieces, x, wk, bias, out, N, H, W, C, O,
                                       o_pad, s, plan_only);
}

int dispatch(const void* x, int x_bf16, const void* wk, int w_pieces,
             const void* bias, void* out, int out_bf16, int N, int H, int W,
             int C, int O, int o_pad, void* stream, Plan* plan_only) {
  if (C < 1 || C > 4 || H % 4 || W % 4 || o_pad % OCB || O > o_pad ||
      (w_pieces != 1 && w_pieces != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_out<__nv_bfloat16>(out_bf16, w_pieces, x, wk, bias, out,
                                            N, H, W, C, O, o_pad, s, plan_only)
                : launch_out<float>(out_bf16, w_pieces, x, wk, bias, out, N, H,
                                    W, C, O, o_pad, s, plan_only);
}

}  // namespace

// Launches on `stream`; returns the CUDA error code (0 on success). out is
// bf16 where out_bf16, else f32.
extern "C" int bnn_fused_stem(const void* x, int x_bf16, const void* wk,
                              int w_pieces, const void* bias, void* out,
                              int out_bf16, int N, int H, int W, int C, int O,
                              int o_pad, void* stream) {
  return dispatch(x, x_bf16, wk, w_pieces, bias, out, out_bf16, N, H, W, C, O,
                  o_pad, stream, nullptr);
}

// The launch bnn_fused_stem would make: plan = {pooled rows an item, items,
// blocks, blocks an SM}. Returns the CUDA error code.
extern "C" int bnn_fused_stem_plan(int x_bf16, int w_pieces, int out_bf16,
                                   int N, int H, int W, int C, int O,
                                   int o_pad, int* plan) {
  Plan pl{};
  const int err = dispatch(nullptr, x_bf16, nullptr, w_pieces, nullptr,
                           nullptr, out_bf16, N, H, W, C, O, o_pad, nullptr, &pl);
  plan[0] = pl.rows;
  plan[1] = pl.items;
  plan[2] = pl.grid;
  plan[3] = pl.per_sm;
  return err;
}
