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
// bnn_common.cuh's run_block on its Dp4aTile, the last one writing the
// output. The result equals fused_chain(fused_stem(x)) bit for bit, though
// fused_chain runs the tensor-core tile: each stem output takes
// stem_common.cuh's arithmetic, whatever the tile, and the integer sums are
// exact in any order.
//
// The stem's tile is not fused_stem.cu's: that kernel runs 512 threads with
// about 112 KB of dynamic shared memory, while a cooperative grid here is
// sized for bnn::THREADS (128) threads and the blocks' static shared
// memory. A stem work item is 4x4 pooled outputs (9x9 conv positions from a
// 23x23 input window) for 16 channels: 26 KB of shared memory, in a union
// with the block phases' GEMM tiles. Each thread owns 3 positions x 4
// channels in registers.
//
// Bound on an H100 at (1, 224, 224, 3) bf16 with ResNet-18's layer1: 0.30 MB
// in, 0.40 MB out, 0.15 MB of int8 weights (0.26 us at 3.35 TB/s) against
// 0.24 GFLOP of stem and 0.92 G int8 operations; chip_smoke.py prints the
// bound of each measured shape.
#include <math_constants.h>

#include "bnn_common.cuh"
#include "stem_common.cuh"

namespace {

constexpr int SP = 4;                                // pooled rows / cols per item
constexpr int SCT = 2 * SP + 1;                      // conv rows / cols per item
constexpr int SNPOS = SCT * SCT;                     // conv positions per item
constexpr int SIT = 4 * SP + 7;                      // input rows / cols per item
constexpr int SOC = 16;                              // output channels per item
constexpr int SJ = 4;                                // channels per thread
constexpr int SSLOTS = bnn::THREADS / (SOC / SJ);    // position slots
constexpr int SPPT = (SNPOS + SSLOTS - 1) / SSLOTS;  // positions per thread

struct StemSmem {
  float4 in[SIT * SIT];                  // input window, channels in lanes
  float w[stem::KS * stem::KS * 4 * SOC];  // [(tap * C + c) * SOC + o]
  float conv[SNPOS * SOC];               // relu(conv + bias), -inf outside
};

union Shared {
  bnn::Smem gemm;
  StemSmem stem;
};

struct Params {
  bnn::ChainParams chain;  // chain.x is the stem's output (scratch)
  const void* x;           // (N, H, W, C) raw input, C <= 4
  const float* w;          // (7, 7, C, O)
  const float* bias;       // (O,)
  int H, W, C, x_bf16;
};

// One stem item: pooled rows p0.., cols q0.. of image n, channels oc0..
template <int C>
__device__ void stem_item(const Params& p, int item, StemSmem& sm) {
  const int O = p.chain.blk[0].ci;
  const int hc = p.H / 2, wc = p.W / 2, hp = hc / 2, wp = wc / 2;
  const int groups = (O + SOC - 1) / SOC;
  const int tiles_x = (wp + SP - 1) / SP, tiles_y = (hp + SP - 1) / SP;
  int r = item;
  const int oc0 = (r % groups) * SOC;
  r /= groups;
  const int q0 = (r % tiles_x) * SP;
  r /= tiles_x;
  const int p0 = (r % tiles_y) * SP, n = r / tiles_y;
  const int tid = threadIdx.x;

  __syncthreads();  // the previous item is done with the shared memory
  // conv row 2*p0 - 1 + lr reads input rows 4*p0 - 5 + 2*lr + ky
  const int r0 = 4 * p0 - 5, c0 = 4 * q0 - 5;
  for (int i = tid; i < SIT * SIT; i += bnn::THREADS) {
    const int rr = r0 + i / SIT, cc = c0 + i % SIT;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (rr >= 0 && rr < p.H && cc >= 0 && cc < p.W) {
      const size_t base = ((static_cast<size_t>(n) * p.H + rr) * p.W + cc) * C;
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = bnn::ldf(p.x, base + c, p.x_bf16);
    }
    sm.in[i] = make_float4(v[0], v[1], v[2], v[3]);
  }
  for (int i = tid; i < stem::KS * stem::KS * C * SOC; i += bnn::THREADS) {
    const int o = i % SOC, tc = i / SOC, oc = oc0 + o;
    sm.w[i] = oc < O ? p.w[static_cast<size_t>(tc) * O + oc] : 0.f;
  }
  __syncthreads();

  const int g = tid % (SOC / SJ);     // channels g*SJ .. g*SJ+SJ-1 of the item
  const int slot = tid / (SOC / SJ);  // positions slot + SSLOTS * q
  int lr[SPPT], lc[SPPT];
  float acc[SPPT][SJ];
#pragma unroll
  for (int q = 0; q < SPPT; ++q) {
    const int pos = min(slot + SSLOTS * q, SNPOS - 1);
    lr[q] = pos / SCT;
    lc[q] = pos % SCT;
#pragma unroll
    for (int j = 0; j < SJ; ++j) acc[q][j] = 0.f;
  }
  for (int ky = 0; ky < stem::KS; ++ky) {
#pragma unroll
    for (int kx = 0; kx < stem::KS; ++kx) {
      float4 xin[SPPT];
#pragma unroll
      for (int q = 0; q < SPPT; ++q) {
        xin[q] = sm.in[(2 * lr[q] + ky) * SIT + 2 * lc[q] + kx];
      }
      const float* wt = sm.w + (ky * stem::KS + kx) * C * SOC + g * SJ;
      float wr[C][SJ];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 w4 = *reinterpret_cast<const float4*>(wt + c * SOC);
        wr[c][0] = w4.x; wr[c][1] = w4.y; wr[c][2] = w4.z; wr[c][3] = w4.w;
      }
      stem::tap<C, SPPT, SJ>(acc, xin, wr);
    }
  }
#pragma unroll
  for (int q = 0; q < SPPT; ++q) {
    const int pos = slot + SSLOTS * q;
    if (pos >= SNPOS) continue;
    const int cr = 2 * p0 - 1 + lr[q], cc = 2 * q0 - 1 + lc[q];
    const bool inside = cr >= 0 && cr < hc && cc >= 0 && cc < wc;
#pragma unroll
    for (int j = 0; j < SJ; ++j) {
      const int oc = oc0 + g * SJ + j;
      const float b = oc < O ? p.bias[oc] : 0.f;
      sm.conv[pos * SOC + g * SJ + j] =
          inside ? stem::relu_bias(acc[q][j], b) : -CUDART_INF_F;
    }
  }
  __syncthreads();

  // pooled (p0 + pr, q0 + pc) takes local conv rows 2pr..2pr+2, cols 2pc..2pc+2
  void* out = const_cast<void*>(p.chain.x);
  for (int i = tid; i < SP * SP * SOC; i += bnn::THREADS) {
    const int o = i % SOC, pp = i / SOC, pr = pp / SP, pc = pp % SP;
    const int pq = p0 + pr, qq = q0 + pc, oc = oc0 + o;
    if (pq >= hp || qq >= wp || oc >= O) continue;
    float m = -CUDART_INF_F;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        m = fmaxf(m, sm.conv[((2 * pr + dy) * SCT + 2 * pc + dx) * SOC + o]);
    bnn::stf(out, ((static_cast<size_t>(n) * hp + pq) * wp + qq) * O + oc, m,
             p.chain.x_bf16);
  }
}

__device__ void run_stem(const Params& p, StemSmem& sm) {
  const int O = p.chain.blk[0].ci;
  const int hp = p.H / 4, wp = p.W / 4;
  const int items = p.chain.n * ((hp + SP - 1) / SP) * ((wp + SP - 1) / SP) *
                    ((O + SOC - 1) / SOC);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    switch (p.C) {
      case 1: stem_item<1>(p, it, sm); break;
      case 2: stem_item<2>(p, it, sm); break;
      case 3: stem_item<3>(p, it, sm); break;
      default: stem_item<4>(p, it, sm); break;
    }
  }
}

__global__ void __launch_bounds__(bnn::THREADS)
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
    bnn::run_block<bnn::Dp4aTile, false>(c, c.blk[i], c.h, c.w, in, in_bf16,
                                         out, out_bf16, sm.gemm, grid);
    if (!last) grid.sync();
    in = out;
    in_bf16 = out_bf16;
  }
}

int capacity = 0;

}  // namespace

// The stem and a chain of stride-1 basic blocks. The arguments are
// bnn_common.cuh's flat arrays (see setup()), whose x is the stem's output
// scratch ((N, H/4, W/4, O) in the IO dtype, x_bf16 its type), followed by
// three more pointers (the raw input, the f32 (7, 7, C, O) stem weights, the
// f32 (O,) bias) and four more ints (H, W, C, input_bf16). Returns the CUDA
// error code.
extern "C" int bnn_fused_stem_chain(int nblocks, const void* const* ptrs,
                                    const int* ints, void* stream) {
  Params p{};
  const int err = bnn::setup(p.chain, nblocks, ptrs, ints);
  if (err) return err;
  const void* const* sp = ptrs + nblocks * bnn::BLOCK_PTRS + 12;
  const int* si = ints + nblocks * bnn::BLOCK_INTS + 11;
  p.x = sp[0];
  p.w = static_cast<const float*>(sp[1]);
  p.bias = static_cast<const float*>(sp[2]);
  p.H = si[0];
  p.W = si[1];
  p.C = si[2];
  p.x_bf16 = si[3];
  if (p.C < 1 || p.C > 4 || p.H % 4 || p.W % 4 || p.H / 4 != p.chain.h ||
      p.W / 4 != p.chain.w || p.chain.classes != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < nblocks; ++i) {
    if (p.chain.blk[i].down) return static_cast<int>(cudaErrorInvalidValue);
  }
  return bnn::launch(reinterpret_cast<const void*>(&fused_stem_chain_kernel),
                     &capacity, p, stream);
}
