// The fused stem's arithmetic, shared by fused_stem.cu and fused_stem_chain.cu
// so that both kernels give the same bits whatever their tiling:
//
//   out = maxpool3x3/s2/p1(relu(conv7x7/s2/p3(x, w) + bias))
//
// The conv is an implicit GEMM on the bf16 tensor cores (mma.sync m16n8k16,
// f32 accumulators), computed transposed: M is 16 output channels (the
// weights are the A operand, kept in registers), N is 8 conv positions of
// one conv row (the window is the B operand), two n-tiles a row of 16. K
// runs over (ky, kx, c) with the channels padded to 4: 49 taps x 4 = 196,
// padded to 208, 13 k-steps of 16; inside a k-step (taps 4s .. 4s + 3) lane
// u = lane % 4 takes tap 4s + u, its channels 0 and 1 in the fragment's
// first K half and 2 and 3 in its second (K index 16s + 8h + 2u + e is tap
// 4s + u, channel 2h + e), so a lane's two B registers are one pixel, one
// 64-bit load. The three padding taps carry zero weights; their reads clamp
// to tap 48.
//
// Pieces and passes: an f32 operand is split exactly into three bf16 pieces,
// hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid); a bf16 operand
// is one piece. A pass multiplies one x piece by one w piece; the passes
// are the pairs STEM_PASSES below that both operands have, in that order:
// 1 for bf16 x and bf16 w, 3 for bf16 x and f32 w (or the reverse), 6 for
// f32 x and f32 w (the dropped pairs are below 2^-24 of a product). The
// order of every output's sum is fixed:
//
//   1 pass:  acc = 0; for each k-step: acc = mma(w0, x0, acc)
//   more:    main = 0, corr = 0; for each k-step: main = main + mma(w0, x0, 0)
//            (an f32 add, rounded to nearest), then corr = mma(wj, xi, corr)
//            for each further pass in order; acc = main + corr
//   out = fmaxf(m + bias, 0), m = max of acc over the 3x3/s2/p1 pool window
//         (positions outside the conv map left out), rounded to the output
//         dtype at the store
//
// which is the max of relu(acc + bias) over the window bit for bit (f32
// rounding and relu are monotone), so the pool runs on the sums: a running
// max down a pooled row's three conv rows in each lane, then the 3-wide max
// across columns with one warp shuffle per value.
//
// The input window in shared memory holds 4 bf16 channels a pixel (one
// 8-byte word pair), WIN_COLS = 37 pixels of a row at a pitch of WIN_W = 45,
// one array per x piece. A half-warp's 64-bit loads read pixels 2 apart for
// its positions and 1 apart for its taps; at the pitch of 45 (the only one
// from 33 to 47) they hit distinct banks also where the taps wrap to the
// next kernel row.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

// (x piece, w piece) of each pass, in summation order
#define STEM_PASSES {0, 0}, {0, 1}, {1, 0}, {0, 2}, {1, 1}, {2, 0}

namespace stem {

constexpr int KS = 7;                       // conv kernel extent
constexpr int TAPS = KS * KS;               // 49
constexpr int KSTEPS = 13;                  // 52 taps of 4 channels
constexpr int KP = 16 * KSTEPS;             // 208: K of a weight piece row
constexpr int KW = KP / 2;                  // its 32-bit words
constexpr int NC = 16;                      // conv columns of a row tile
constexpr int PC = (NC - 1) / 2;            // pooled columns they feed: 7
constexpr int WIN_COLS = 2 * (NC - 1) + KS; // window pixels a row: 37
constexpr int WIN_W = 45;                   // their pitch: conflict-free
constexpr int NPASS_ALL = 6;
constexpr unsigned FULL = 0xffffffffu;

struct Pass {
  int x, w;
};

__host__ __device__ constexpr Pass pass(int p) {
  constexpr Pass table[NPASS_ALL] = {STEM_PASSES};
  return table[p];
}

// The passes that NX x pieces and NW w pieces run.
__host__ __device__ constexpr int passes(int nx, int nw) {
  int n = 0;
  for (int p = 0; p < NPASS_ALL; ++p) n += pass(p).x < nx && pass(p).w < nw;
  return n;
}

// Pixel offset of tap t in a window; padding taps read tap 48.
__host__ __device__ constexpr int tap_px(int t) {
  return (t < TAPS ? t : TAPS - 1) / KS * WIN_W + (t < TAPS ? t : TAPS - 1) % KS;
}

// Pooled rows an item takes, of 1 .. max_rows: the fewest rounds of work,
// where a round is as many items as blocks run at once (slots(rows): the
// resident blocks, a block an item) and an item costs its 2 * rows + 1 conv
// rows plus about two for its window load. More items in flight hide the
// chain of k-steps each warp waits on; taller items repeat fewer conv rows.
template <class Slots>
inline int pick_rows(int n, int hp, int wp, int groups, int max_rows,
                     Slots&& slots) {
  int best = 1;
  long best_cost = -1;
  for (int r = 1; r <= max_rows; ++r) {
    const long items = static_cast<long>(n) * ((hp + r - 1) / r) *
                       ((wp + PC - 1) / PC) * groups;
    const long s = slots(r) > 0 ? slots(r) : 1;
    const long cost = (items + s - 1) / s * (2 * r + 3);
    if (best_cost < 0 || cost < best_cost) {
      best = r;
      best_cost = cost;
    }
  }
  return best;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// v = hi + mid + lo exactly (f32 normal range), each a bf16
__device__ __forceinline__ void split3(float v, __nv_bfloat16 (&p)[3]) {
  p[0] = __float2bfloat16_rn(v);
  const float r1 = __fsub_rn(v, __bfloat162float(p[0]));
  p[1] = __float2bfloat16_rn(r1);
  p[2] = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(p[1])));
}

// Input pixels r0 .. r0 + rows - 1 x c0 .. c0 + WIN_COLS - 1 of image n into
// the window (NX pieces of rows x WIN_W pixels, `piece_px` pixels apart):
// zero outside the image and in channels C .. 3. T is bf16 (one piece) or
// f32. A thread loads LOAD_BATCH pixels before it stores any, so that their
// device-memory latencies overlap.
constexpr int LOAD_BATCH = 8;

template <typename T, int NX>
__device__ __forceinline__ void load_window(uint2* win, int piece_px, const T* x,
                                            int n, int H, int W, int C, int r0,
                                            int c0, int rows) {
  const int total = rows * WIN_COLS;
  for (int i0 = threadIdx.x; i0 < total; i0 += LOAD_BATCH * blockDim.x) {
    float v[LOAD_BATCH][4];
#pragma unroll
    for (int b = 0; b < LOAD_BATCH; ++b) {
      const int i = i0 + b * blockDim.x;
      const int rr = r0 + i / WIN_COLS, cc = c0 + i % WIN_COLS;
#pragma unroll
      for (int c = 0; c < 4; ++c) v[b][c] = 0.f;
      if (i < total && rr >= 0 && rr < H && cc >= 0 && cc < W) {
        const T* px = x + ((static_cast<size_t>(n) * H + rr) * W + cc) * C;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c < C) v[b][c] = to_float(px[c]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < LOAD_BATCH; ++b) {
      const int i = i0 + b * blockDim.x;
      if (i >= total) break;
      __nv_bfloat16 pc[4][3];
#pragma unroll
      for (int c = 0; c < 4; ++c) split3(v[b][c], pc[c]);
      const int at = i / WIN_COLS * WIN_W + i % WIN_COLS;
#pragma unroll
      for (int p = 0; p < NX; ++p) {
        win[p * piece_px + at] = make_uint2(pack2(pc[0][p], pc[1][p]),
                                            pack2(pc[2][p], pc[3][p]));
      }
    }
  }
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp's share of the stem GEMM: the A fragments (weights) of 16 * MT
// channels for NX x pieces and NW w pieces. w piece 0 stays in registers;
// the others (the f32-weight paths, which are not timed) are read per
// k-step.
template <int NX, int NW, int MT>
struct Tile {
  static constexpr int NPASS = passes(NX, NW);
  uint32_t a[KSTEPS][MT][4];
  const uint32_t* rest;  // this lane's words of w piece 1
  int piece_words;

  // Channels o0 .. o0 + 16 * MT - 1 of the K-major pieces wk: (pieces, o_pad,
  // KP) bf16, K index 16s + 8h + 2u + e holding tap 4s + u, channel 2h + e.
  __device__ __forceinline__ void load(const uint32_t* __restrict__ wk,
                                       int o_pad, int o0) {
    const int lane = threadIdx.x & 31;
    const uint32_t* col = wk + static_cast<size_t>(o0 + (lane >> 2)) * KW + (lane & 3);
    piece_words = o_pad * KW;
    rest = col + piece_words;
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
#pragma unroll
      for (int m = 0; m < MT; ++m) frag(a[s][m], col, m, s);
    }
  }

  static __device__ __forceinline__ void frag(uint32_t (&f)[4], const uint32_t* col,
                                              int m, int s) {
    f[0] = __ldg(col + 16 * m * KW + 8 * s);            // channel g, ch 0-1
    f[1] = __ldg(col + (16 * m + 8) * KW + 8 * s);      // channel g + 8
    f[2] = __ldg(col + 16 * m * KW + 8 * s + 4);        // channel g, ch 2-3
    f[3] = __ldg(col + (16 * m + 8) * KW + 8 * s + 4);
  }

  // The conv of one row tile into acc[m][n]: lane (g, u) holds channels
  // 16m + g (registers 0, 1) and 16m + g + 8 (2, 3) at positions 8n + 2u and
  // 8n + 2u + 1. win: the row's first window row in piece 0, x pieces
  // `piece_px` pixels apart.
  __device__ __forceinline__ void conv(float (&acc)[MT][2][4], const uint2* win,
                                       int piece_px) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, u = lane & 3;
    // position g reads pixel 2g + kx; the lane's tap 4s + u sits u pixels
    // on, or on the next kernel row where the step's taps wrap after k
    const uint2* pad = win + 2 * g;
    const uint2* q[4] = {pad + u, pad + u + (u >= 1 ? WIN_W - KS : 0),
                         pad + u + (u >= 2 ? WIN_W - KS : 0),
                         pad + u + (u >= 3 ? WIN_W - KS : 0)};
    float main[MT][2][4], corr[MT][2][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) main[m][n][e] = corr[m][n][e] = 0.f;
      }
    }
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      const int kx0 = 4 * s % KS;
      const uint2* p = 4 * s + 3 >= TAPS ? pad
                       : kx0 + 3 >= KS   ? q[KS - kx0]
                                         : q[0];
      uint2 b[NX][2];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        b[i][0] = p[i * piece_px + tap_px(4 * s)];       // positions 0-7
        b[i][1] = p[i * piece_px + tap_px(4 * s) + 16];  // positions 8-15
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          if (NPASS == 1) {
            mma(main[m][n], a[s][m], b[0][n].x, b[0][n].y);
          } else {
            float f[4] = {0.f, 0.f, 0.f, 0.f};
            mma(f, a[s][m], b[0][n].x, b[0][n].y);
#pragma unroll
            for (int e = 0; e < 4; ++e) main[m][n][e] = __fadd_rn(main[m][n][e], f[e]);
          }
        }
      }
#pragma unroll
      for (int pp = 1; pp < NPASS_ALL; ++pp) {
        if (pass(pp).x >= NX || pass(pp).w >= NW) continue;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          uint32_t w[4] = {a[s][m][0], a[s][m][1], a[s][m][2], a[s][m][3]};
          if (pass(pp).w > 0) frag(w, rest + (pass(pp).w - 1) * piece_words, m, s);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            mma(corr[m][n], w, b[pass(pp).x][n].x, b[pass(pp).x][n].y);
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[m][n][e] = NPASS == 1 ? main[m][n][e]
                                    : __fadd_rn(main[m][n][e], corr[m][n][e]);
        }
      }
    }
  }
};

// relu(m + bias): the pooled output of the max m of the window's sums
__device__ __forceinline__ float relu_bias(float m, float bias) {
  return fmaxf(m + bias, 0.f);
}

// One warp's item: conv rows 2 * p0 - 1 + i, i = 0 .. 2 * rows, at conv
// columns 2 * q0 - 1 .. 2 * q0 + 14 (window row 2 * i; x pieces `piece_px`
// pixels apart), its 16 * MT channels, pooled as they come: pooled row
// p0 + k takes conv rows i = 2k .. 2k + 2 and pooled column q0 + j conv
// columns 2j .. 2j + 2 of the tile. Each output goes to
// store(k, j, channel of the warp's 16 * MT, value).
template <int NX, int NW, int MT, class Store>
__device__ __forceinline__ void pooled_rows(const Tile<NX, NW, MT>& tile,
                                            const uint2* win, int piece_px,
                                            const float (&bias)[MT][2], int p0,
                                            int q0, int rows, int hc, int wc,
                                            Store&& store) {
  const int lane = threadIdx.x & 31, g = lane >> 2, u = lane & 3;
  const int src = (lane & ~3) | ((u + 1) & 3);  // the lane of positions + 2
  // warp-uniform: some column of the tile lies outside the conv map
  const bool edge = q0 == 0 || 2 * q0 + 14 >= wc;
  float cur[MT][2][4];
  for (int i = 0; i <= 2 * rows; ++i) {
    const int r = 2 * p0 - 1 + i;
    const bool inside = r >= 0 && r < hc;  // warp-uniform
    float v[MT][2][4];
    if (inside) tile.conv(v, win + 2 * i * WIN_W, piece_px);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float up = i == 0 ? -CUDART_INF_F : cur[m][n][e];
          if (!inside) v[m][n][e] = -CUDART_INF_F;
          // an even row closes pooled row i / 2 - 1 in v and opens i / 2
          const float done = fmaxf(up, v[m][n][e]);
          cur[m][n][e] = i % 2 == 0 ? v[m][n][e] : done;
          v[m][n][e] = done;
        }
      }
    }
    if (i == 0 || i % 2) continue;
    if (edge) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 2 * q0 - 1 + 8 * n + 2 * u + e;
          if (c < 0 || c >= wc) {
#pragma unroll
            for (int m = 0; m < MT; ++m) v[m][n][e] = v[m][n][2 + e] = -CUDART_INF_F;
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float x0 = v[m][0][2 * h], x1 = v[m][0][2 * h + 1];
        const float y0 = v[m][1][2 * h], y1 = v[m][1][2 * h + 1];
        const float n0 = __shfl_sync(FULL, x0, src), n1 = __shfl_sync(FULL, y0, src);
        const int ch = 16 * m + 8 * h + g;
        store(i / 2 - 1, u, ch, relu_bias(fmaxf(fmaxf(x0, x1), u < 3 ? n0 : n1),
                                          bias[m][h]));
        if (u < 3) {
          store(i / 2 - 1, 4 + u, ch, relu_bias(fmaxf(fmaxf(y0, y1), n1), bias[m][h]));
        }
      }
    }
  }
}

}  // namespace stem
