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
// x is (N, H, W, Ci) NHWC with even H, W; out (N, H/2, W/2, Co); w1 is
// (16Ci, Co) int8 in _transform_w1's s2d order, w2 (9Co, Co), wd (Ci, Co).
//
// Bound on an H100 at its serving shape (ResNet-34 layer4.0, 1x14x14x256
// bf16 -> 1x7x7x512): 3.8 MB of weights and activations (w1 as its 9*Ci*Co
// taps; the s2d form's other 7*Ci*Co bytes are zeros) against 0.36 G int8
// operations, so the bytes bound it (1.14 us at 3.35 TB/s). The design is
// fused_basic_block's (bnn_common.cuh): one cooperative launch, phases split
// by grid barriers, signed maps as int8 scratch in L2. The strided conv reads
// the full-resolution signed map through the s2d index map, so no s2d copy of
// the input is ever made, and the pooled shortcut is signed in the first
// phase beside the input.
#include "bnn_common.cuh"

namespace {

__global__ void __launch_bounds__(bnn::THREADS)
fused_downsample_block_kernel(const __grid_constant__ bnn::ChainParams p) {
  __shared__ bnn::Smem sm;
  bnn::cg::grid_group grid = bnn::cg::this_grid();
  bnn::run_block<bnn::Dp4aTile, true>(p, p.blk[0], p.h, p.w, p.x, p.x_bf16,
                                      p.out, p.out_bf16, sm, grid);
}

int capacity = 0;

}  // namespace

// One downsample block. Scratch: xs (N*H*W*Ci), hs (N*H/2*W/2*Co) and
// ds (N*H/2*W/2*Ci) int8.
// The arguments are bnn_common.cuh's flat arrays (see setup()). Returns the
// CUDA error code.
extern "C" int bnn_fused_downsample_block(int nblocks, const void* const* ptrs,
                                          const int* ints, void* stream) {
  bnn::ChainParams p{};
  const int err = bnn::setup(p, nblocks, ptrs, ints);
  if (err) return err;
  if (nblocks != 1 || !p.blk[0].down || p.classes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return bnn::launch(reinterpret_cast<const void*>(&fused_downsample_block_kernel),
                     &capacity, p, stream);
}
