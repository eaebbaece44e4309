// Stride-1 binary Bottleneck (ResNet-50's block) in one kernel, hand-written
// for Hopper (sm_90a).
//
// Replaces bnn_tpu/kernels/bottleneck.py:fused_bottleneck (a Pallas TPU
// kernel that runs the block over row slabs held in VMEM, the two 1x1 convs
// as single MXU dots):
//
//   y1  = act1(conv1x1(sign(x - thr1), w1) * s1 + a1)
//   y2  = act2(conv3x3(sign(y1 - thr2), w2) * s2 + a2)
//   y3  = conv1x1(sign(y2 - thr3), w3) * s3 + a3
//   r   = x, or conv1x1(sign(x - thrd), wd) * sd + ad (projection)
//   out = act3(y3 + r)
//
// x is (N, H, W, C) NHWC, f32 or bf16; out (N, H, W, C_out); w1 (C, width),
// w2 (9 * width, width) tap-major, w3 (width, C_out), wd (C, C_out), all
// int8. C, width and C_out are multiples of 4 (the gathers read K words).
//
// Bound on an H100 at batch 1: the int8 weights are 69.6 KB per layer1 block
// and 4.46 MB per layer4 block; with the bf16 input and output the bytes
// bound a call to 0.6-1.5 us (the 0.44 G int8 operations take 0.22 us at
// the tensor-core peak). The design is the basic block's (bnn_common.cuh):
// one cooperative launch whose phases are split by grid barriers, every
// conv an implicit GEMM whose tiles and K slices spread over the whole card
// with exact int32 partial sums joined by atomics, the signed maps as int8
// scratch that stays in the 50 MB L2:
//
//   P0  xs = sign(x - thr1); ds = sign(x - thrd) (projection); zero the sums
//   P1  conv1 over xs, and the projection over ds, which reads the same
//       input; then hs1 = sign(act1(...) - thr2)
//   P2  conv2 (3x3) over hs1; then hs2 = sign(act2(...) - thr3)
//   P3  conv3 over hs2; then the epilogues, the residual add and act3
//
// The projection runs in P1, beside conv1's quarter-width output (C x width
// against conv3's width x C_out), so that P1 and P3 carry about the same
// number of work items. Six grid barriers per call; at batch 1 a phase costs
// a few microseconds whatever its size, which sets the call's time.
#include "bnn_common.cuh"

namespace {

// epilogue rows, in bnn_tpu_torch/kernels/bottleneck.py's ROWS order
enum Row { S1, A1, P1, THR2, S2, A2, P2, THR3, S3, A3, P3, SD, AD, THR1, THRD, NROWS };

struct Params {
  int n, h, w, c, width, cout, projection;
  int act1, act2, act3, zero_to_one, x_bf16, out_bf16, prm_bf16;
  const void* x;
  void* out;
  const int8_t* w1;
  const int8_t* w2;
  const int8_t* w3;
  const int8_t* wd;
  const void* ptr[NROWS];  // a row of length 0 takes its default, of 1 is broadcast
  int len[NROWS];
  int8_t* xs;   // (M, C) signed input
  int8_t* ds;   // (M, C) signed projection input
  int8_t* hs1;  // (M, width) signed conv1 output
  int8_t* hs2;  // (M, width) signed conv2 output
  int* acc;     // (M, width) int32 sums of conv1, then of conv2
  int* acc3;    // (M, C_out) int32 sums of conv3
  int* accd;    // (M, C_out) int32 sums of the projection
};

__device__ __forceinline__ float row(const Params& p, int r, int c) {
  const float dflt = (r == S1 || r == S2 || r == S3 || r == SD) ? 1.f
                     : (r == P1 || r == P2 || r == P3)          ? 0.25f
                                                                : 0.f;
  if (p.len[r] == 0) return dflt;
  return bnn::ldf(p.ptr[r], p.len[r] == 1 ? 0 : c, p.prm_bf16);
}

__global__ void __launch_bounds__(bnn::THREADS)
fused_bottleneck_kernel(const __grid_constant__ Params p) {
  __shared__ bnn::Smem sm;
  bnn::cg::grid_group grid = bnn::cg::this_grid();
  const size_t gtid = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t nthr = static_cast<size_t>(gridDim.x) * blockDim.x;
  const int M = p.n * p.h * p.w, C = p.c, Wd = p.width, Co = p.cout;
  const size_t nin = static_cast<size_t>(M) * C;
  const size_t nmid = static_cast<size_t>(M) * Wd;
  const size_t nout = static_cast<size_t>(M) * Co;

  // P0: signs of the block input; zero the sums
  for (size_t i = gtid; i < nin; i += nthr) {
    const int c = i % C;
    const float v = bnn::ldf(p.x, i, p.x_bf16);
    p.xs[i] = bnn::sign_i8(v, row(p, THR1, c), p.zero_to_one);
    if (p.projection) p.ds[i] = bnn::sign_i8(v, row(p, THRD, c), p.zero_to_one);
  }
  for (size_t i = gtid; i < nmid; i += nthr) p.acc[i] = 0;
  for (size_t i = gtid; i < nout; i += nthr) {
    p.acc3[i] = 0;
    if (p.projection) p.accd[i] = 0;
  }
  grid.sync();

  // P1: conv1 into acc, the projection into accd
  const bnn::Split s1 = bnn::split(M, C, Wd);
  const bnn::Split sd = bnn::split(M, C, Co);
  const int items1 = s1.items + (p.projection ? sd.items : 0);
  for (int it = blockIdx.x; it < items1; it += gridDim.x) {
    if (it < s1.items) {
      bnn::gemm_item(bnn::Pointwise{p.xs, C}, p.w1, M, C, Wd, s1, it, sm, p.acc);
    } else {
      bnn::gemm_item(bnn::Pointwise{p.ds, C}, p.wd, M, C, Co, sd, it - s1.items,
                     sm, p.accd);
    }
  }
  grid.sync();
  // ... epilogue -> act1 -> sign; acc is zeroed again for conv2
  for (size_t i = gtid; i < nmid; i += nthr) {
    const int n = i % Wd;
    const float y = bnn::act(bnn::epilogue(p.acc[i], row(p, S1, n), row(p, A1, n)),
                             p.act1, row(p, P1, n));
    p.hs1[i] = bnn::sign_i8(y, row(p, THR2, n), p.zero_to_one);
    p.acc[i] = 0;
  }
  grid.sync();

  // P2: conv2 (3x3, pad 1: the padded taps read 0 after the sign) into acc
  const bnn::Split s2 = bnn::split(M, 9 * Wd, Wd);
  for (int it = blockIdx.x; it < s2.items; it += gridDim.x) {
    bnn::gemm_item(bnn::Conv3x3{p.hs1, p.h, p.w, Wd}, p.w2, M, 9 * Wd, Wd, s2, it,
                   sm, p.acc);
  }
  grid.sync();
  // ... epilogue -> act2 -> sign
  for (size_t i = gtid; i < nmid; i += nthr) {
    const int n = i % Wd;
    const float y = bnn::act(bnn::epilogue(p.acc[i], row(p, S2, n), row(p, A2, n)),
                             p.act2, row(p, P2, n));
    p.hs2[i] = bnn::sign_i8(y, row(p, THR3, n), p.zero_to_one);
  }
  grid.sync();

  // P3: conv3 into acc3
  const bnn::Split s3 = bnn::split(M, Wd, Co);
  for (int it = blockIdx.x; it < s3.items; it += gridDim.x) {
    bnn::gemm_item(bnn::Pointwise{p.hs2, Wd}, p.w3, M, Wd, Co, s3, it, sm, p.acc3);
  }
  grid.sync();
  // ... epilogues, the residual add and act3
  for (size_t i = gtid; i < nout; i += nthr) {
    const int n = i % Co;
    const float y3 = bnn::epilogue(p.acc3[i], row(p, S3, n), row(p, A3, n));
    const float r = p.projection
                        ? bnn::epilogue(p.accd[i], row(p, SD, n), row(p, AD, n))
                        : bnn::ldf(p.x, i, p.x_bf16);
    bnn::stf(p.out, i, bnn::act(__fadd_rn(y3, r), p.act3, row(p, P3, n)),
             p.out_bf16);
  }
}

int capacity = 0;

}  // namespace

// One Bottleneck. ptrs: x, out, w1, w2, w3, wd (null: identity shortcut),
// the NROWS rows, then the scratch xs, ds, hs1, hs2, acc, acc3, accd; ints:
// n, h, w, c, width, cout, projection, act1, act2, act3, zero_to_one,
// x_bf16, out_bf16, prm_bf16, then the NROWS row lengths. Returns the CUDA
// error code.
extern "C" int bnn_fused_bottleneck(const void* const* ptrs, const int* ints,
                                    void* stream) {
  Params p{};
  p.n = ints[0];
  p.h = ints[1];
  p.w = ints[2];
  p.c = ints[3];
  p.width = ints[4];
  p.cout = ints[5];
  p.projection = ints[6];
  p.act1 = ints[7];
  p.act2 = ints[8];
  p.act3 = ints[9];
  p.zero_to_one = ints[10];
  p.x_bf16 = ints[11];
  p.out_bf16 = ints[12];
  p.prm_bf16 = ints[13];
  for (int r = 0; r < NROWS; ++r) {
    p.ptr[r] = ptrs[6 + r];
    p.len[r] = ints[14 + r];
  }
  if (p.n < 1 || p.h < 1 || p.w < 1 || p.c % 4 || p.width % 4 || p.cout % 4 ||
      p.c < 4 || p.width < 4 || p.cout < 4 ||
      (p.projection ? ptrs[5] == nullptr : p.c != p.cout)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.x = ptrs[0];
  p.out = const_cast<void*>(ptrs[1]);
  p.w1 = static_cast<const int8_t*>(ptrs[2]);
  p.w2 = static_cast<const int8_t*>(ptrs[3]);
  p.w3 = static_cast<const int8_t*>(ptrs[4]);
  p.wd = static_cast<const int8_t*>(ptrs[5]);
  const void* const* s = ptrs + 6 + NROWS;
  p.xs = static_cast<int8_t*>(const_cast<void*>(s[0]));
  p.ds = static_cast<int8_t*>(const_cast<void*>(s[1]));
  p.hs1 = static_cast<int8_t*>(const_cast<void*>(s[2]));
  p.hs2 = static_cast<int8_t*>(const_cast<void*>(s[3]));
  p.acc = static_cast<int*>(const_cast<void*>(s[4]));
  p.acc3 = static_cast<int*>(const_cast<void*>(s[5]));
  p.accd = static_cast<int*>(const_cast<void*>(s[6]));
  return bnn::launch(reinterpret_cast<const void*>(&fused_bottleneck_kernel),
                     &capacity, p, stream);
}
