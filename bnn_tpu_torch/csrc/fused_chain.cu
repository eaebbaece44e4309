// A whole residual stage of a binary ResNet in one kernel, hand-written for
// Hopper (sm_90a): an optional leading stride-2 block, then stride-1 basic
// blocks, then optionally the global avgpool and the float fc head.
//
// Replaces bnn_tpu/kernels/model.py:fused_chain (with fused_pair and
// fused_down_stage, which call it): a Pallas TPU kernel that holds a whole
// stage's weights and activations in VMEM and unrolls the batch's images.
//
// A stage does not fit one SM as it fit VMEM (ResNet-18's layer4 holds
// 8.4 MB of int8 weights), and at batch 1 one block per image would leave
// 131 of 132 SMs idle. So the stage is one cooperative launch over every SM
// that has work: each block of the chain runs as the three phases of
// bnn_common.cuh, with grid barriers between them, its int8 signed maps and
// the f32 block outputs in scratch that stays in the 50 MB L2 at these
// batches. The head pools each channel by a sequential sum over H*W, then
// takes each logit's f32 dot over the channels with one warp, in a fixed
// order that the plain version repeats, each multiply and add rounded on
// its own.
//
// Bound on an H100 at its serving shapes (ResNet-18 at batch 1 and 4): the
// weights dominate the bytes (0.15 MB for layer1 up to 8.4 MB for layer4,
// whose fc adds 1 MB in bf16, so 0.05 to 2.8 us at 3.35 TB/s; a down
// block's w1 counts as its 9*Ci*Co taps, not the s2d form's 16*Ci*Co) and
// each stage is bound by bytes at batch 1; chip_smoke.py prints the bound
// of each measured shape.
#include "bnn_common.cuh"

namespace {

// pooled[n, c] = mean over H*W of a[n, :, :, c] (a sequential sum); then
// logits[n, j] = pooled[n] . wfc[:, j] + bfc[j], one warp per logit: lane l
// sums the products of channels l*C/32 .. (l+1)*C/32 - 1 in order, and the
// 32 partial sums meet in a fixed butterfly (offsets 16, 8, 4, 2, 1).
__device__ void run_head(const bnn::ChainParams& p, const float* a, int hw,
                         int C, bnn::cg::grid_group& grid) {
  const size_t gtid = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t nthr = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = gtid; i < static_cast<size_t>(p.n) * C; i += nthr) {
    const size_t n = i / C, c = i % C;
    float s = 0.f;
    for (int q = 0; q < hw; ++q) s = __fadd_rn(s, a[(n * hw + q) * C + c]);
    p.pooled[i] = __fdiv_rn(s, static_cast<float>(hw));
  }
  grid.sync();
  const int lane = threadIdx.x % 32;
  const size_t nwarps = nthr / 32;
  const int per = (C + 31) / 32;
  for (size_t i = gtid / 32; i < static_cast<size_t>(p.n) * p.classes; i += nwarps) {
    const size_t n = i / p.classes, j = i % p.classes;
    float s = 0.f;
    for (int c = lane * per; c < min(C, (lane + 1) * per); ++c) {
      s = __fadd_rn(s, __fmul_rn(p.pooled[n * C + c],
                                 bnn::ldf(p.wfc, static_cast<size_t>(c) * p.classes + j,
                                          p.prm_bf16)));
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
    }
    if (lane == 0) {
      if (p.bfc != nullptr) s = __fadd_rn(s, bnn::ldf(p.bfc, j, p.prm_bf16));
      static_cast<float*>(p.out)[i] = s;
    }
  }
}

__global__ void __launch_bounds__(bnn::THREADS)
fused_chain_kernel(const __grid_constant__ bnn::ChainParams p) {
  __shared__ bnn::Smem sm;
  bnn::cg::grid_group grid = bnn::cg::this_grid();
  int h = p.h, w = p.w;
  const void* in = p.x;
  int in_bf16 = p.x_bf16;
  for (int i = 0; i < p.nblocks; ++i) {
    const bnn::Block& b = p.blk[i];
    const bool final_out = i == p.nblocks - 1 && p.classes == 0;
    void* out = final_out ? p.out : static_cast<void*>(p.act_buf[i & 1]);
    const int out_bf16 = final_out ? p.out_bf16 : 0;
    if (b.down) {
      bnn::run_block<true>(p, b, h, w, in, in_bf16, out, out_bf16, sm, grid);
      h /= 2;
      w /= 2;
    } else {
      bnn::run_block<false>(p, b, h, w, in, in_bf16, out, out_bf16, sm, grid);
    }
    grid.sync();
    in = out;
    in_bf16 = out_bf16;
  }
  if (p.classes) {
    run_head(p, static_cast<const float*>(in), h * w, p.blk[p.nblocks - 1].co,
             grid);
  }
}

int capacity = 0;

}  // namespace

// A chain of blocks. Scratch: act0, act1 f32 of the largest block output
// each; xs, hs, ds int8 of the largest block input, conv1 output and pooled
// shortcut input; with classes > 0, pooled (N*C_out f32), and out holds
// (N, classes) f32 logits.
// The arguments are bnn_common.cuh's flat arrays (see setup()). Returns the
// CUDA error code.
extern "C" int bnn_fused_chain(int nblocks, const void* const* ptrs,
                               const int* ints, void* stream) {
  bnn::ChainParams p{};
  const int err = bnn::setup(p, nblocks, ptrs, ints);
  if (err) return err;
  return bnn::launch(reinterpret_cast<const void*>(&fused_chain_kernel),
                     &capacity, p, stream);
}
