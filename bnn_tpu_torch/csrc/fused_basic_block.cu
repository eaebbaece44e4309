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
// the blocks of the launch, and the atomics of a sliced K. bnn::grid_for sizes
// the launch by the conv's tiles, as for the other block kernels.
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
  const void* kernel = reinterpret_cast<const void*>(&fused_basic_block_kernel);
  const int grid = bnn::grid_for(kernel, &capacity, p.n * p.h * p.w, b.co);
  if (grid <= 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
  return bnn::launch(kernel, &capacity, p, stream, grid);
}

// The launch on the current device of a block over m pixels of c channels
// (bnn::block_plan): out = {blocks, resident blocks an SM, a conv's output
// tiles, its K slices}. Returns the CUDA error code.
extern "C" int bnn_fused_basic_block_plan(int m, int c, int* out) {
  const int k = 9 * c;
  return bnn::block_plan(reinterpret_cast<const void*>(&fused_basic_block_kernel),
                         &capacity, m, c, &k, 1, out);
}
