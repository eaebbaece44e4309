// Stride-2 (downsample) binary BasicBlock in one kernel, hand-written for
// Hopper (sm_90a).
//
// Replaces bnn_tpu/kernels/strided_block.py:fused_downsample_block (a Pallas
// TPU kernel that runs conv1 as a 2x2 conv over the space-to-depth input and
// the shortcut's 2x2 avgpool as the mean of the four s2d phases):
//
//   y1  = act1(conv3x3_s2(sign(x - thr1), w1) * s1 + a1)
//   y2  = conv3x3(sign(y1 - thr2), w2) * s2 + a2
//   ds  = conv1x1(sign(avgpool2x2(x) - thrd), wd) * sd + ad
//   out = act2(y2 + ds)                  (pre=1: act2(y2) + ds)
//
// x is (N, H, W, Ci) NHWC with even H, W; out (N, H/2, W/2, Co). The convs
// read the K-major copies of the weights (Block::wt): conv1 (Co, 9Ci) as its
// taps in (dy, dx, c) order, conv2 (Co, 9Co), the shortcut (Co, Ci).
//
// Bound on an H100 at its serving shape (ResNet-34 layer4.0, 1x14x14x256
// bf16 -> 1x7x7x512): 3.8 MB of weights and activations against 0.36 G int8
// operations, so the bytes bound it (1.14 us at 3.35 TB/s). The design is
// fused_basic_block's: one cooperative launch, phases split by grid
// barriers, signed maps as int8 scratch in L2, the convs on bnn_common.cuh's
// MmaTile (mma.sync m16n8k32 s8 over a 3-stage cp.async ring), the launch
// sized by bnn::grid_for from the output tiles. Conv1 reads the
// full-resolution signed map through Conv3x3S2Taps, its 9*Ci taps (the JAX
// kernel's s2d form has 16*Ci, 7*Ci of them against zero weights), so no s2d
// copy of the input is made; the pooled shortcut is signed in the first
// phase beside the input.
#include "bnn_common.cuh"

namespace {

__global__ void __launch_bounds__(bnn::THREADS)
fused_downsample_block_kernel(const __grid_constant__ bnn::ChainParams p) {
  __shared__ bnn::MmaSmem sm;
  bnn::cg::grid_group grid = bnn::cg::this_grid();
  bnn::run_block<bnn::MmaTile, true>(p, p.blk[0], p.h, p.w, p.x, p.x_bf16,
                                     p.out, p.out_bf16, sm, grid);
}

int capacity = 0;  // resident blocks

}  // namespace

// One downsample block. Scratch: xs (N*H*W*Ci), hs (N*H/2*W/2*Co) and
// ds (N*H/2*W/2*Ci) int8. The arguments are bnn_common.cuh's flat arrays
// (see setup()) with the K-major copies of w1, w2 and wd. Returns the CUDA
// error code.
extern "C" int bnn_fused_downsample_block(int nblocks, const void* const* ptrs,
                                          const int* ints, void* stream) {
  bnn::ChainParams p{};
  const int err = bnn::setup(p, nblocks, ptrs, ints);
  if (err) return err;
  const bnn::Block& b = p.blk[0];
  if (nblocks != 1 || !b.down || p.classes || p.h % 2 || p.w % 2 || !b.wt[0] ||
      !b.wt[1] || !b.wt[2]) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* kernel = reinterpret_cast<const void*>(&fused_downsample_block_kernel);
  const int grid = bnn::grid_for(kernel, &capacity, p.n * (p.h / 2) * (p.w / 2), b.co);
  if (grid <= 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
  return bnn::launch(kernel, &capacity, p, stream, grid);
}

// The launch on the current device of a block over m output pixels, ci -> co
// channels (bnn::block_plan): out = {blocks, resident blocks an SM, a conv's
// output tiles, the K slices of conv1, conv2 and the shortcut}. Returns the
// CUDA error code.
extern "C" int bnn_fused_downsample_block_plan(int m, int ci, int co, int* out) {
  const int ks[3] = {9 * ci, 9 * co, ci};
  return bnn::block_plan(reinterpret_cast<const void*>(&fused_downsample_block_kernel),
                         &capacity, m, co, ks, 3, out);
}
