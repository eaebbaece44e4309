// The network entry of a binary ResNet in one kernel, hand-written for
// Hopper (sm_90a): the float stem (conv7x7/s2/p3 + bias + ReLU +
// maxpool3x3/s2/p1) and then layer1's stride-1 basic blocks.
//
// Replaces bnn_tpu/kernels/model.py:fused_stem_chain, a Pallas TPU kernel
// that feeds the stem's pooled tile to the block bodies in VMEM.
//
// One cooperative launch: phase 0 computes the stem of every image into
// scratch that stays in the 50 MB L2, rounded to the IO dtype where the
// split pipeline (fused_stem, then fused_chain) rounds it at its kernel
// boundary; after a grid barrier, layer1's blocks run through
// bnn_common.cuh's run_block on MmaTile, fused_chain's tile (mma.sync
// m16n8k32 s8 over a 3-stage cp.async ring, reading the blocks' K-major
// weight copies), the last one writing the output. The result equals
// fused_chain(fused_stem(x)) bit for bit: each stem output takes
// stem_common.cuh's arithmetic, whatever the tiling, and the integer sums
// are exact in any order.
//
// The stem phase runs stem_common.cuh's tile, as fused_stem.cu does, on its
// own tiling: the cooperative grid is sized for bnn::THREADS (128) threads,
// at most 128 registers (four blocks an SM) and the static shared memory of
// the larger phase. A stem work item is `rows` (at most 4) pooled rows x 7
// pooled columns x 64 channels; each of the four warps takes 16 channels
// (their weights' A fragments in registers, 52 words a lane) through the
// item's 2 * rows + 1 conv rows. The window (up to three bf16 pieces of 23
// rows at a pitch of 45 pixels, 24,840 bytes) shares a union with the block
// phases' cp.async ring (23,040 bytes), so the ring costs no residency.
//
// Bound on an H100 at (1, 224, 224, 3) bf16 with ResNet-18's layer1: 0.30 MB
// in, 0.40 MB out, 0.15 MB of int8 weights (0.26 us at 3.35 TB/s) against
// 0.24 GFLOP of stem and 0.92 G int8 operations; chip_smoke.py prints the
// bound of each measured shape. What holds the kernel back is the blocks'
// phases: layer1's two blocks take nine grid barriers over the full grid,
// which the stem phase needs, and elementwise passes between them.
#include <math_constants.h>

#include "bnn_common.cuh"
#include "stem_common.cuh"

namespace {

constexpr int SMT = 1;                                // m-tiles a warp: 16 channels
constexpr int SOCB = 16 * SMT * (bnn::THREADS / 32);  // channels an item: 64
constexpr int SMAX_ROWS = 4;                          // pooled rows an item, at most
constexpr int SPIECE_PX = (4 * SMAX_ROWS + 7) * stem::WIN_W;  // window pixels a piece

struct StemSmem {
  uint2 win[3 * SPIECE_PX];  // up to three x pieces, 4 bf16 channels a pixel
};

union Shared {
  bnn::MmaSmem gemm;
  StemSmem stem;
};

struct Params {
  bnn::ChainParams chain;  // chain.x is the stem's output (scratch)
  const void* x;           // (N, H, W, C) raw input, C <= 4
  const uint32_t* wk;      // K-major bf16 pieces (w_pieces, o_pad, 208)
  const float* bias;       // (o_pad,)
  int H, W, C, x_bf16, w_pieces, o_pad, rows;
};

// Every stem item of the grid: pooled rows p0 .. p0 + rows - 1, columns
// q0 .. q0 + 6 of image n, channels in groups of 64.
template <typename T, int NW>
__device__ void run_stem_t(const Params& p, StemSmem& sm) {
  constexpr int NX = sizeof(T) == 2 ? 1 : 3;
  const int O = p.chain.blk[0].ci;
  const int hc = p.H / 2, wc = p.W / 2, hp = hc / 2, wp = wc / 2;
  const int tiles_y = (hp + p.rows - 1) / p.rows;
  const int tiles_x = (wp + stem::PC - 1) / stem::PC;
  const int groups = p.o_pad / SOCB;
  const int items = p.chain.n * tiles_y * tiles_x * groups;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* x = static_cast<const T*>(p.x);
  void* out = const_cast<void*>(p.chain.x);

  stem::Tile<NX, NW, SMT> tile;
  float brow[SMT][2];
  int loaded = -1;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    int r = it;
    const int grp = r % groups;
    r /= groups;
    const int q0 = (r % tiles_x) * stem::PC;
    r /= tiles_x;
    const int p0 = (r % tiles_y) * p.rows, n = r / tiles_y;
    const int o0 = grp * SOCB + warp * 16 * SMT;
    if (grp != loaded) {
      tile.load(p.wk, p.o_pad, o0);
#pragma unroll
      for (int m = 0; m < SMT; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) brow[m][h] = p.bias[o0 + 16 * m + 8 * h + (lane >> 2)];
      }
      loaded = grp;
    }
    const int prows = min(p.rows, hp - p0);
    __syncthreads();  // the previous item is done with the window
    stem::load_window<T, NX>(sm.win, SPIECE_PX, x, n, p.H, p.W, p.C, 4 * p0 - 5,
                             4 * q0 - 5, 4 * prows + 7);
    __syncthreads();
    auto store = [&](int k, int j, int ch, float v) {
      const int pq = p0 + k, qq = q0 + j, o = o0 + ch;
      if (pq < hp && qq < wp && o < O) {
        bnn::stf(out, ((static_cast<size_t>(n) * hp + pq) * wp + qq) * O + o, v,
                 p.chain.x_bf16);
      }
    };
    stem::pooled_rows(tile, sm.win, SPIECE_PX, brow, p0, q0, prows, hc, wc, store);
  }
}

__device__ void run_stem(const Params& p, StemSmem& sm) {
  if (p.x_bf16) {
    if (p.w_pieces == 1) {
      run_stem_t<__nv_bfloat16, 1>(p, sm);
    } else {
      run_stem_t<__nv_bfloat16, 3>(p, sm);
    }
  } else if (p.w_pieces == 1) {
    run_stem_t<float, 1>(p, sm);
  } else {
    run_stem_t<float, 3>(p, sm);
  }
}

// At most 128 registers a thread, as the block phases take: four blocks an
// SM, whatever the stem phase would ask for.
__global__ void __launch_bounds__(bnn::THREADS, 4)
fused_stem_chain_kernel(const __grid_constant__ Params p) {
  __shared__ Shared sm;
  bnn::cg::grid_group grid = bnn::cg::this_grid();
  run_stem(p, sm.stem);
  grid.sync();
  const bnn::ChainParams& c = p.chain;
  const void* in = c.x;
  int in_bf16 = c.x_bf16;
  for (int i = 0; i < c.nblocks; ++i) {
    const bool last = i == c.nblocks - 1;
    void* out = last ? c.out : static_cast<void*>(c.act_buf[i & 1]);
    const int out_bf16 = last ? c.out_bf16 : 0;
    bnn::run_block<bnn::MmaTile, false>(c, c.blk[i], c.h, c.w, in, in_bf16,
                                        out, out_bf16, sm.gemm, grid);
    if (!last) grid.sync();
    in = out;
    in_bf16 = out_bf16;
  }
}

int capacity = 0;

// The stem phase's work for n images of hp x wp pooled outputs into o_pad
// channels: plan = {pooled rows an item, items, blocks (the cooperative
// grid), blocks an SM}. The launch takes its rows from here, and so does
// bnn_fused_stem_chain_plan. Returns the CUDA error code.
int stem_plan(int n, int hp, int wp, int o_pad, int* plan) {
  const int cap = bnn::grid_capacity(
      reinterpret_cast<const void*>(&fused_stem_chain_kernel), &capacity);
  plan[0] = stem::pick_rows(n, hp, wp, o_pad / SOCB, SMAX_ROWS,
                            [&](int) { return cap; });
  plan[1] = n * ((hp + plan[0] - 1) / plan[0]) *
            ((wp + stem::PC - 1) / stem::PC) * (o_pad / SOCB);
  plan[2] = cap;
  plan[3] = cap / bnn::sm_count();
  return cap > 0 ? 0 : static_cast<int>(cudaErrorLaunchOutOfResources);
}

int setup_stem(Params& p, int nblocks, const void* const* ptrs,
               const int* ints) {
  const int err = bnn::setup(p.chain, nblocks, ptrs, ints);
  if (err) return err;
  const void* const* sp = ptrs + nblocks * bnn::BLOCK_PTRS + 12;
  const int* si = ints + nblocks * bnn::BLOCK_INTS + 11;
  p.x = sp[0];
  p.wk = static_cast<const uint32_t*>(sp[1]);
  p.bias = static_cast<const float*>(sp[2]);
  p.H = si[0];
  p.W = si[1];
  p.C = si[2];
  p.x_bf16 = si[3];
  p.w_pieces = si[4];
  p.o_pad = si[5];
  if (p.C < 1 || p.C > 4 || p.H % 4 || p.W % 4 || p.H / 4 != p.chain.h ||
      p.W / 4 != p.chain.w || p.chain.classes != 0 || p.o_pad % SOCB ||
      p.chain.blk[0].ci > p.o_pad || (p.w_pieces != 1 && p.w_pieces != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < nblocks; ++i) {  // MmaTile reads the K-major copies
    const bnn::Block& b = p.chain.blk[i];
    if (b.down || !b.wt[0] || !b.wt[1]) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  int plan[4];
  const int plan_err = stem_plan(p.chain.n, p.chain.h, p.chain.w, p.o_pad, plan);
  p.rows = plan[0];
  return plan_err;
}

}  // namespace

// The stem and a chain of stride-1 basic blocks, each with its K-major
// weight copies (Block::wt). The arguments are
// bnn_common.cuh's flat arrays (see setup()), whose x is the stem's output
// scratch ((N, H/4, W/4, O) in the IO dtype, x_bf16 its type), followed by
// three more pointers (the raw input, the K-major bf16 stem weight pieces
// (w_pieces, o_pad, 208), the f32 (o_pad,) bias) and six more ints (H, W, C,
// input_bf16, w_pieces, o_pad). Returns the CUDA error code.
extern "C" int bnn_fused_stem_chain(int nblocks, const void* const* ptrs,
                                    const int* ints, void* stream) {
  Params p{};
  const int err = setup_stem(p, nblocks, ptrs, ints);
  if (err) return err;
  return bnn::launch(reinterpret_cast<const void*>(&fused_stem_chain_kernel),
                     &capacity, p, stream);
}

// stem_plan for a batch of n images of H x W into o_pad channels.
extern "C" int bnn_fused_stem_chain_plan(int n, int H, int W, int o_pad,
                                         int* plan) {
  return stem_plan(n, H / 4, W / 4, o_pad, plan);
}
