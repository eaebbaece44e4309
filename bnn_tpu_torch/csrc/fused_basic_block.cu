// Stride-1 binary BasicBlock in one kernel, hand-written for Hopper (sm_90a).
//
// Replaces bnn_tpu/kernels/block.py:fused_basic_block (a Pallas TPU kernel
// that keeps the block's feature map in VMEM between its two 3x3 convs):
//
//   out = act2(conv3x3(sign(act1(conv3x3(sign(x - thr), w1) * s1 + a1)
//                           - thr2), w2) * s2 + a2 + x)
//
// (pre=1: act2 before the residual add). x and out are NHWC, f32 or bf16;
// w1, w2 are (9C, C) int8 (HWIO flattened), read here through their K-major
// (C, 9C) copies (Block::wt).
//
// Bound on an H100 at its serving shape (ResNet-34 layer4.1, 1x7x7x512
// bf16): 4.7 MB of int8 weights against 0.46 G int8 operations, so the bytes
// bound it (1.4 us at 3.35 TB/s). The block is one cooperative launch whose
// phases (sign, conv1, conv2 + residual) are split by grid barriers; the two
// signed maps are int8 scratch that stays in the 50 MB L2. The convs run
// bnn_common.cuh's MmaTile (mma.sync m16n8k32 s8 over a 3-stage cp.async
// ring, weights as 16-byte rows of the K-major copies). At M = 49 pixels a
// conv has only 2 x 8 output tiles of K = 4608 (72 chunks), so mma_split
// slices K over the launch: what holds the kernel back is its four grid
// barriers and the elementwise passes between them, whose cost grows with
// the blocks of the launch, and the atomics of a sliced K. grid_for sizes
// the launch by the conv's tiles, as fused_bottleneck.cu does.
#include "bnn_common.cuh"

namespace {

__global__ void __launch_bounds__(bnn::THREADS)
fused_basic_block_kernel(const __grid_constant__ bnn::ChainParams p) {
  __shared__ bnn::MmaSmem sm;
  bnn::cg::grid_group grid = bnn::cg::this_grid();
  bnn::run_block<bnn::MmaTile, false>(p, p.blk[0], p.h, p.w, p.x, p.x_bf16,
                                      p.out, p.out_bf16, sm, grid);
}

int capacity = 0;  // resident blocks
int sms = 0;

// The blocks of a launch over M pixels of C channels: one per output tile
// of a conv, in whole SMs, 2 to 4 an SM; at most what can be resident. Each
// block makes every grid barrier dearer (about 2.7 ns a block on an H100),
// and blocks beyond the tiles only slice K more finely.
int grid_for(int M, int C) {
  const int cap = bnn::grid_capacity(
      reinterpret_cast<const void*>(&fused_basic_block_kernel), &capacity);
  if (cap <= 0) return cap;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int tiles = (M + bnn::TM - 1) / bnn::TM * ((C + bnn::TN - 1) / bnn::TN);
  const int per_sm = (tiles + sms - 1) / sms;
  const int grid = (per_sm < 2 ? 2 : per_sm > 4 ? 4 : per_sm) * sms;
  return grid < cap ? grid : cap;
}

}  // namespace

// One basic block. Scratch: xs and hs of N*H*W*C int8 each. The arguments
// are bnn_common.cuh's flat arrays (see setup()) with the K-major copies of
// w1 and w2. Returns the CUDA error code.
extern "C" int bnn_fused_basic_block(int nblocks, const void* const* ptrs,
                                     const int* ints, void* stream) {
  bnn::ChainParams p{};
  const int err = bnn::setup(p, nblocks, ptrs, ints);
  if (err) return err;
  const bnn::Block& b = p.blk[0];
  if (nblocks != 1 || b.down || p.classes || !b.wt[0] || !b.wt[1]) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = grid_for(p.n * p.h * p.w, b.co);
  if (grid <= 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
  return bnn::launch(reinterpret_cast<const void*>(&fused_basic_block_kernel),
                     &capacity, p, stream, grid);
}

// The launch on the current device of a block over m pixels of c channels:
// out = {blocks, resident blocks an SM, a conv's output tiles, its K
// slices}. Returns the CUDA error code.
extern "C" int bnn_fused_basic_block_plan(int m, int c, int* out) {
  const int blocks = grid_for(m, c);
  if (blocks <= 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const bnn::Split s = bnn::mma_split_of(blocks, m, 9 * c, c);
  out[0] = blocks;
  out[1] = capacity / sms;
  out[2] = s.items / s.slices;
  out[3] = s.slices;
  return 0;
}
