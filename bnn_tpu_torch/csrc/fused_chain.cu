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
// The GEMM phases run bnn_common.cuh's MmaTile: mma.sync m16n8k32 s8 x s8 ->
// s32 on the int8 tensor cores, fed by a 3-stage cp.async ring. A rows come
// from the signed map as 16-byte copies, one per 16 K values of a tap (any
// C % 16 == 0; other C % 4 == 0 widths copy word by word), and the weights,
// through L1, from K-major (Co, K) int8 copies that the block descriptor
// makes once per device, so no word is transposed on the card; a down
// block's conv1 runs as its 9*Ci taps (the s2d form's 7*Ci zero taps are
// skipped). A GEMM is split into about half an item per resident block; one
// whose K is one slice stores its sums, a sliced one adds them with atomics.
//
// Bound on an H100 at its serving shapes, from chip_smoke.py's phase 4
// (each input, weight and row read once, the output written once, against
// the int8 operations at 1979 TOPS): at batch 1 the bytes set it, since the
// weights dominate (0.15 MB for layer1 up to 8.4 MB for layer4, whose fc adds
// 1 MB in bf16; a down block's w1 counts as its 9*Ci*Co taps), 4.4 us over
// ResNet-18's four stages; at batch 4 layers 1-3 are bound by operations
// (3.7 G int8 operations in layer1, 1.9 us) and layer4 + head by bytes
// (2.9 us), 8.1 us over the four. What holds the kernel back is the rest of
// each stage: its ten grid barriers and the elementwise phases between them,
// which no tile changes, and in the GEMM phases the L2 traffic of a 32-row
// tile, which reads each weight column once per 32 output pixels.
//
// fused_bottleneck, fused_basic_block, fused_downsample_block and
// fused_stem_chain's block phases run the same tile.
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
  __shared__ bnn::MmaTile::Smem sm;
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
      bnn::run_block<bnn::MmaTile, true>(p, b, h, w, in, in_bf16, out,
                                         out_bf16, sm, grid);
      h /= 2;
      w /= 2;
    } else {
      bnn::run_block<bnn::MmaTile, false>(p, b, h, w, in, in_bf16, out,
                                          out_bf16, sm, grid);
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

// A chain of blocks, each with its K-major weight copies (Block::wt).
// Scratch: act0, act1 f32 of the largest block output
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
  for (int i = 0; i < nblocks; ++i) {  // MmaTile reads the K-major copies
    const bnn::Block& b = p.blk[i];
    if (!b.wt[0] || !b.wt[1] || (b.down && !b.wt[2])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return bnn::launch(reinterpret_cast<const void*>(&fused_chain_kernel),
                     &capacity, p, stream);
}
