// Fused binary convolution, stride 1, hand-written for Hopper (sm_90a):
//
//   out = conv(x >= 0 ? +1 : -1, w) * scale + add
//
// over an odd k x k kernel with "same" zero padding, in NHWC. Replaces
// bnn_tpu/kernels/conv.py:binary_conv2d_s1, a Pallas TPU kernel that signs
// x in VMEM and sums k*k shifted int8 slab products on the MXU.
//
// x: (N, H, W, C) f32 or bf16; w: (K4, O4) int8 +/-1, the (k, k, C, O)
// weights flattened to K = k*k*C rows in (dy, dx, c) order and zero-padded
// to K4 and O4, multiples of 4; scale, add: (O,) f32; out: (N, H, W, O) f32.
// The sign is taken in the kernel with sign(0) = +1 whatever the layer's
// convention, as the TPU kernel does, and the conv's zero padding comes
// after the sign: padded taps add exactly 0.
//
// An implicit GEMM over bnn_common.cuh's tiles: a thread block owns a
// TM x TN (32 x 64) output tile and walks K in chunks of 64, gathering the
// signed activations straight from x (four K values packed in one int8
// word), with the weights staged in shared memory; __dp4a sums the products
// exactly in int32, and the epilogue rounds the multiply and the add apart
// (__fmul_rn, __fadd_rn) as the plain version does.
//
// Bound on an H100 at its serving shape (8, 56, 56, 64) bf16 with 64
// output channels: 3.2 MB of x in and 6.4 MB of f32 out (2.9 us at
// 3.35 TB/s) against 1.85 G int8 operations (0.9 us at the int8 tensor-core
// rate), so bytes bound it; the kernel reads each x value once per K chunk
// that covers it (9 times at k = 3, from L1 and L2) and writes each output
// once.
#include "bnn_common.cuh"

namespace {

// K word kw of output pixel m: K values 4kw..4kw+3, (dy, dx, c) order,
// signed, 0 outside the image and past K
struct SignGather {
  const void* x;
  int bf16, H, W, C, k, K;
  struct Pix {
    size_t img;  // element offset of the pixel's image
    int y, x;
  };
  __device__ __forceinline__ Pix pixel(int m, int M) const {
    const int hw = H * W, n = m / hw, r = m - n * hw, y = r / W;
    if (m >= M) return {0, -(1 << 20), -(1 << 20)};
    return {static_cast<size_t>(n) * hw * C, y, r - y * W};
  }
  __device__ __forceinline__ int sign_at(size_t i) const {
    return bnn::sign_i8(bnn::ldf(x, i, bf16), 0.f, 1);  // sign(0) = +1
  }
  __device__ __forceinline__ bool inside(int yy, int xx) const {
    return yy >= 0 && yy < H && xx >= 0 && xx < W;
  }
  // one K value kk (any C)
  __device__ __forceinline__ int value(const Pix& p, int kk) const {
    if (kk >= K) return 0;
    const int tap = kk / C, c = kk - tap * C, dy = tap / k, dx = tap - dy * k;
    const int yy = p.y + dy - k / 2, xx = p.x + dx - k / 2;
    if (!inside(yy, xx)) return 0;
    return sign_at(p.img + (static_cast<size_t>(yy) * W + xx) * C + c);
  }
  __device__ __forceinline__ int load(const Pix& p, int kw) const {
    const int kk = 4 * kw;
    if (C % 4 == 0) {  // the word lies in one tap
      const int tap = kk / C, c = kk - tap * C, dy = tap / k, dx = tap - dy * k;
      const int yy = p.y + dy - k / 2, xx = p.x + dx - k / 2;
      if (!inside(yy, xx)) return 0;
      const size_t i = p.img + (static_cast<size_t>(yy) * W + xx) * C + c;
      return bnn::pack4(sign_at(i), sign_at(i + 1), sign_at(i + 2), sign_at(i + 3));
    }
    return bnn::pack4(value(p, kk), value(p, kk + 1), value(p, kk + 2),
                      value(p, kk + 3));
  }
};

struct Params {
  SignGather g;
  const int8_t* w;
  const float* scale;
  const float* add;
  float* out;
  int M, K4, O4, O;
};

__global__ void __launch_bounds__(bnn::THREADS)
binary_conv2d_s1_kernel(const __grid_constant__ Params p) {
  __shared__ bnn::Smem sm;
  const int m0 = blockIdx.x * bnn::TM, n0 = blockIdx.y * bnn::TN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int kwords = p.K4 / 4;
  const int chunks = (kwords + bnn::KCW - 1) / bnn::KCW;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  SignGather::Pix px[bnn::A_PER];
#pragma unroll
  for (int i = 0; i < bnn::A_PER; ++i) {
    px[i] = p.g.pixel(m0 + tid / bnn::KCW + i * (bnn::THREADS / bnn::KCW), p.M);
  }
  int ra[bnn::A_PER], rw[bnn::W_PER][4];
  bnn::load_chunk(p.g, px, p.w, p.O4, kwords, n0, 0, ra, rw);
  for (int c = 0; c < chunks; ++c) {
    bnn::store_chunk(sm, ra, rw);
    __syncthreads();
    if (c + 1 < chunks) {
      bnn::load_chunk(p.g, px, p.w, p.O4, kwords, n0, (c + 1) * bnn::KCW, ra, rw);
    }
#pragma unroll
    for (int q = 0; q < bnn::KCW; ++q) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.a[ty * 4 + i][q];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sm.w[tx + 16 * j][q];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < p.M && n < p.O) {
        p.out[static_cast<size_t>(m) * p.O + n] =
            bnn::epilogue(acc[i][j], p.scale[n], p.add[n]);
      }
    }
  }
}

}  // namespace

// Launches on `stream`; returns the CUDA error code (0 on success).
extern "C" int bnn_binary_conv2d_s1(const void* x, int x_bf16, const void* w,
                                    const void* scale, const void* add,
                                    void* out, int N, int H, int W, int C,
                                    int k, int K4, int O4, int O, void* stream) {
  if (k < 1 || k % 2 == 0 || K4 % 4 || O4 % 4 || K4 < k * k * C || O4 < O) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.g = SignGather{x, x_bf16, H, W, C, k, k * k * C};
  p.w = static_cast<const int8_t*>(w);
  p.scale = static_cast<const float*>(scale);
  p.add = static_cast<const float*>(add);
  p.out = static_cast<float*>(out);
  p.M = N * H * W;
  p.K4 = K4;
  p.O4 = O4;
  p.O = O;
  const dim3 grid((p.M + bnn::TM - 1) / bnn::TM, (O4 + bnn::TN - 1) / bnn::TN);
  binary_conv2d_s1_kernel<<<grid, bnn::THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
