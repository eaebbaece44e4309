// Stride-1 binary BasicBlock in one kernel, hand-written for Hopper (sm_90a).
//
// Replaces bnn_tpu/kernels/block.py:fused_basic_block (a Pallas TPU kernel
// that keeps the block's feature map in VMEM between its two 3x3 convs):
//
//   out = act2(conv3x3(sign(act1(conv3x3(sign(x - thr), w1) * s1 + a1)
//                           - thr2), w2) * s2 + a2 + x)
//
// (pre=1: act2 before the residual add). x and out are NHWC, f32 or bf16;
// w1, w2 are (9C, C) int8 (HWIO flattened).
//
// Bound on an H100 at its serving shape (ResNet-34 layer4.1, 1x7x7x512
// bf16): 4.7 MB of int8 weights against 0.46 G int8 operations, so the bytes
// bound it (1.4 us at 3.35 TB/s). The design keeps the two signed maps as
// int8 scratch that stays in the 50 MB L2 and runs the block as one
// cooperative launch whose phases (sign, conv1, conv2 + residual) are split
// by grid barriers, with each conv's output tiles spread over every SM
// (bnn_common.cuh). At M = 49 pixels the grid has only 16 tiles per conv,
// and each reads the full K = 4608 weight column: the first, simple form.
#include "bnn_common.cuh"

namespace {

__global__ void __launch_bounds__(bnn::THREADS)
fused_basic_block_kernel(const __grid_constant__ bnn::ChainParams p) {
  __shared__ bnn::Smem sm;
  bnn::cg::grid_group grid = bnn::cg::this_grid();
  bnn::run_block<bnn::Dp4aTile, false>(p, p.blk[0], p.h, p.w, p.x, p.x_bf16,
                                       p.out, p.out_bf16, sm, grid);
}

int capacity = 0;

}  // namespace

// One basic block. Scratch: xs and hs of N*H*W*C int8 each.
// The arguments are bnn_common.cuh's flat arrays (see setup()). Returns the
// CUDA error code.
extern "C" int bnn_fused_basic_block(int nblocks, const void* const* ptrs,
                                     const int* ints, void* stream) {
  bnn::ChainParams p{};
  const int err = bnn::setup(p, nblocks, ptrs, ints);
  if (err) return err;
  if (nblocks != 1 || p.blk[0].down || p.classes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return bnn::launch(reinterpret_cast<const void*>(&fused_basic_block_kernel),
                     &capacity, p, stream);
}
