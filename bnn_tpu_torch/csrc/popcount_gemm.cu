// XNOR / popcount GEMM over packed activations and packed weights,
// hand-written for Hopper (sm_90a):
//
//   out[m, n] = (K - 2 * sum_w popcount(xp[m, w] ^ wp[w, n])) * scale[n] + add[n]
//
// Replaces bnn_tpu/kernels/gemm.py:popcount_gemm, a Pallas TPU kernel that
// XORs word-major tiles on the VPU and carries the mismatch counts across
// its sequential K grid axis in VMEM scratch.
//
// xp: (M, KW) 32-bit words of the signed activations (bit j of word w is
// x[32w + j] >= 0); wp: (KW, N) words of the weights; scale, add: (N,) f32;
// out: (M, N) f32. The pad bits past K are 0 in both operands. The sums are
// exact in int32 and the epilogue rounds the multiply and the add apart
// (__fmul_rn, __fadd_rn), as the plain version does.
//
// Bound on an H100 at path C's shapes (a ResNet-50's 36 pointwise convs at
// batch 8): 9.1 MB of words in and 285.8 MB of f32 out, 88 us at 3.35
// TB/s, against 34 G bit operations (17 us even at the int8 tensor-core
// rate). So the f32 output bounds it: 97% of the bytes. At batch 1 every
// call is a few us of launch and latency.
//
// Design:
// - 1-bit tensor-core products on the words as they are:
//   mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc (SASS
//   BMMA.168256.AND.POPC). In a 256-deep step lane group t holds words t
//   and t + 4 of its A rows (a0-a1 and a2-a3) and of its B column (b0 and
//   b1), so the words go from shared memory to the fragments with no
//   reshuffle. The mismatches come from AND alone:
//   popc(x ^ w) = popc(x & ~w) + popc(~x & w), two mma into the same
//   accumulator, the complements taken in registers (one LOP3 each). The
//   pad bits stay harmless: x pad 0 & ~w pad 1 = 0 and ~x pad 1 & w pad 0
//   = 0, and words past KW are zero-filled in both operands. .and.popc is
//   the form wgmma also offers for .b1; CUDA 12.9's ptxas accepts the older
//   .xor.popc for sm_90a but lowers it to the same two AND.POPC BMMA and
//   LOP3 complements, so it is written out here.
// - A warp group (four warps, 2x2 over a 64x64 or 32x32 output tile) walks
//   K in chunks of 8 words, one mma step, through a 4-stage ring of
//   cp.async copies: 8-byte copies of x word pairs and 16-byte copies of 4
//   neighbouring weight columns, zero-filled past M, N and KW. Rows are
//   padded (x to 12 words, w to TILE + 8) so that the fragment reads of a
//   warp hit 32 distinct banks. Where those copies cannot be made (KW odd,
//   N not a multiple of 4, a pointer off 8 or 16 bytes) the scalar-loader
//   instance copies word by word.
// - K split: where the host plan asks for it, a block holds 2 or 4 warp
//   groups over the same tile; group s walks chunks s, s + SPLIT, ... with
//   its own ring and named barrier (bar.sync 1 + s, 128), and the partial
//   int32 tiles meet in shared memory before group 0's epilogue. One
//   launch, no workspace.
// - The store is the bound, so the vector instance stages the f32 tile in
//   shared memory and writes it in rows of 16-byte stores, which on the
//   H100 ran faster at path C's shapes than 8-byte stores of each lane's
//   accumulator pairs (a quad of lanes per 32-byte sector). The scalar
//   instance stores element by element. scale and add are read before the
//   K loop.
// - The host plan (kernels/gemm.py popcount_plan) picks the tile (64x64
//   when its grid reaches half a wave of SMs, else 32x32), the loader and
//   the split (32x32 tiles only, at least 2 chunks a group, at most four
//   groups per SM).
#include "mma_s8.cuh"

namespace {

constexpr int GROUP = 128;  // threads of a warp group: 2x2 warps
constexpr int KWC = 8;      // words per chunk: one 256-deep mma step
constexpr int STAGES = 4;
constexpr int XR = KWC + 4;  // words of an x row in shared memory

// words of a weight row in shared memory
template <int TILE>
constexpr int WR = TILE + 8;

// words of a row of the staged output tile
template <int TILE>
constexpr int OUT_ROW = TILE + 8;

template <int TILE>
__host__ __device__ constexpr int group_bytes() {
  return STAGES * (TILE * XR + KWC * WR<TILE>) * 4;
}

template <int TILE, int SPLIT>
constexpr int smem_bytes() {
  const int rings = SPLIT * group_bytes<TILE>();
  const int out = ((SPLIT - 1) * TILE * TILE + TILE * OUT_ROW<TILE>) * 4;
  return rings > out ? rings : out;
}

struct Params {
  const uint32_t* x;  // (M, KW)
  const uint32_t* w;  // (KW, N)
  const float* scale;
  const float* add;
  float* out;
  int M, KW, N, K;
};

// 4 or 8 bytes from global to shared memory through L1; src_bytes 0 writes
// zeros
template <int BYTES>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(BYTES), "r"(src_bytes));
}

__device__ __forceinline__ void mma_b1(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (K - 2 mism) * scale + add, the multiply and the add rounded apart
__device__ __forceinline__ float epilogue(int K, int mism, float scale,
                                          float add) {
  return __fadd_rn(__fmul_rn(static_cast<float>(K - 2 * mism), scale), add);
}

// One chunk of x words and weight words into a stage of a group's ring.
template <int TILE, bool VEC>
__device__ __forceinline__ void load_chunk(uint32_t* __restrict__ xs,
                                           uint32_t* __restrict__ ws,
                                           const Params& p, int tid, int m0,
                                           int n0, int chunk) {
  const int w0 = chunk * KWC;
  if constexpr (VEC) {
    // x: 8-byte copies of word pairs (KW is even); w: 16-byte copies of 4
    // neighbouring columns of a word row (N % 4 == 0)
    constexpr int XCOPIES = TILE * KWC / 2, WCOPIES = KWC * TILE / 4;
#pragma unroll
    for (int it = 0; it < (XCOPIES + GROUP - 1) / GROUP; ++it) {
      const int idx = it * GROUP + tid;
      if (XCOPIES % GROUP != 0 && idx >= XCOPIES) break;
      const int r = idx / (KWC / 2), q = (idx % (KWC / 2)) * 2;
      const bool ok = m0 + r < p.M && w0 + q < p.KW;
      const uint32_t* src = ok ? p.x + static_cast<size_t>(m0 + r) * p.KW + w0 + q : p.x;
      cp_async_ca<8>(xs + r * XR + q, src, ok ? 8 : 0);
    }
#pragma unroll
    for (int it = 0; it < (WCOPIES + GROUP - 1) / GROUP; ++it) {
      const int idx = it * GROUP + tid;
      if (WCOPIES % GROUP != 0 && idx >= WCOPIES) break;
      const int q = idx / (TILE / 4), c = (idx % (TILE / 4)) * 4;
      const bool ok = w0 + q < p.KW && n0 + c < p.N;
      const uint32_t* src = ok ? p.w + static_cast<size_t>(w0 + q) * p.N + n0 + c : p.w;
      cp_async16(ws + q * WR<TILE> + c, src, ok ? 16 : 0);
    }
  } else {
    // word by word (TILE * KWC is a multiple of GROUP)
#pragma unroll
    for (int it = 0; it < TILE * KWC / GROUP; ++it) {
      const int idx = it * GROUP + tid;
      const int r = idx / KWC, q = idx % KWC;
      const bool ok = m0 + r < p.M && w0 + q < p.KW;
      const uint32_t* src = ok ? p.x + static_cast<size_t>(m0 + r) * p.KW + w0 + q : p.x;
      cp_async_ca<4>(xs + r * XR + q, src, ok ? 4 : 0);
    }
#pragma unroll
    for (int it = 0; it < KWC * TILE / GROUP; ++it) {
      const int idx = it * GROUP + tid;
      const int q = idx / TILE, c = idx % TILE;
      const bool ok = w0 + q < p.KW && n0 + c < p.N;
      const uint32_t* src = ok ? p.w + static_cast<size_t>(w0 + q) * p.N + n0 + c : p.w;
      cp_async_ca<4>(ws + q * WR<TILE> + c, src, ok ? 4 : 0);
    }
  }
}

// a barrier of one warp group (id 1 + s), or of the block when there is one
template <int SPLIT>
__device__ __forceinline__ void group_sync(int s) {
  if constexpr (SPLIT == 1) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(s + 1), "n"(GROUP) : "memory");
  }
}

template <int TILE, bool VEC, int SPLIT>
__global__ void __launch_bounds__(GROUP* SPLIT)
popcount_gemm_kernel(const __grid_constant__ Params p) {
  constexpr int WM = TILE / 2, WN = TILE / 2;  // each warp's output tile
  constexpr int MT = WM / 16, NT = WN / 8;     // its m16n8 tiles
  constexpr int XSTAGE = TILE * XR, WSTAGE = KWC * WR<TILE>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = threadIdx.x / GROUP, tid = threadIdx.x % GROUP;
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem + s * group_bytes<TILE>());
  uint32_t* ws = xs + STAGES * XSTAGE;

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row / word group
  const int wm0 = (warp / 2) * WM, wn0 = (warp % 2) * WN;
  const int m0 = blockIdx.x * TILE, n0 = blockIdx.y * TILE;
  const int chunks = (p.KW + KWC - 1) / KWC;
  const int mine = (chunks - s + SPLIT - 1) / SPLIT;  // s, s + SPLIT, ...

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < mine)
      load_chunk<TILE, VEC>(xs + c * XSTAGE, ws + c * WSTAGE, p, tid, m0, n0,
                            s + c * SPLIT);
    cp_async_commit();
  }

  // this lane's epilogue columns, read while the copies are in flight
  float sc[NT][2], ad[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn0 + j * 8 + 2 * t + e;
      sc[j][e] = n < p.N ? p.scale[n] : 0.f;
      ad[j][e] = n < p.N ? p.add[n] : 0.f;
    }

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int c = 0; c < mine; ++c) {
    cp_async_wait<STAGES - 2>();  // chunk c has landed
    group_sync<SPLIT>(s);         // ... for the group, and c - 1 is done
    const int next = c + STAGES - 1;
    if (next < mine) {
      const int st = next % STAGES;
      load_chunk<TILE, VEC>(xs + st * XSTAGE, ws + st * WSTAGE, p, tid, m0, n0,
                            s + next * SPLIT);
    }
    cp_async_commit();

    const uint32_t* xc = xs + (c % STAGES) * XSTAGE;
    const uint32_t* wc = ws + (c % STAGES) * WSTAGE;
    uint32_t b[NT][2], nb[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = wn0 + j * 8 + g;
      b[j][0] = wc[t * WR<TILE> + col];
      b[j][1] = wc[(t + 4) * WR<TILE> + col];
      nb[j][0] = ~b[j][0];
      nb[j][1] = ~b[j][1];
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const uint32_t* r0 = xc + (wm0 + i * 16 + g) * XR + t;
      const uint32_t* r1 = r0 + 8 * XR;
      // fragment registers: row g word t, row g+8 word t, row g word t+4,
      // row g+8 word t+4
      const uint32_t a[4] = {r0[0], r1[0], r0[4], r1[4]};
      const uint32_t na[4] = {~a[0], ~a[1], ~a[2], ~a[3]};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mma_b1(acc[i][j], a, nb[j][0], nb[j][1]);  // x & ~w
        mma_b1(acc[i][j], na, b[j][0], b[j][1]);   // ~x & w
      }
    }
  }
  cp_async_wait<0>();

  if constexpr (SPLIT > 1) {
    // the groups' partial tiles meet in shared memory (the rings are idle)
    __syncthreads();
    constexpr int PER_WARP = MT * NT * 4 * 32;
    int* part = reinterpret_cast<int*>(smem) + warp * PER_WARP + lane;
    if (s > 0) {
      int* dst = part + (s - 1) * TILE * TILE;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dst[((i * NT + j) * 4 + e) * 32] = acc[i][j][e];
    }
    __syncthreads();
    if (s > 0) return;
#pragma unroll
    for (int o = 0; o < SPLIT - 1; ++o)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][j][e] += part[o * TILE * TILE + ((i * NT + j) * 4 + e) * 32];
  }

  if constexpr (VEC) {
    // the tile through shared memory (past the partial tiles), then rows of
    // 16-byte stores (N % 4 == 0)
    float* ot = reinterpret_cast<float*>(smem) + (SPLIT - 1) * TILE * TILE;
    if constexpr (SPLIT == 1) __syncthreads();  // the ring is done
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          *reinterpret_cast<float2*>(ot + (wm0 + i * 16 + g + 8 * h) * OUT_ROW<TILE> +
                                     wn0 + j * 8 + 2 * t) =
              make_float2(epilogue(p.K, acc[i][j][2 * h], sc[j][0], ad[j][0]),
                          epilogue(p.K, acc[i][j][2 * h + 1], sc[j][1], ad[j][1]));
    group_sync<SPLIT>(0);
#pragma unroll
    for (int it = 0; it < TILE * TILE / 4 / GROUP; ++it) {
      const int idx = it * GROUP + tid;
      const int r = idx / (TILE / 4), c = (idx % (TILE / 4)) * 4;
      const int m = m0 + r, n = n0 + c;
      if (m < p.M && n < p.N)
        *reinterpret_cast<float4*>(p.out + static_cast<size_t>(m) * p.N + n) =
            *reinterpret_cast<const float4*>(ot + r * OUT_ROW<TILE> + c);
    }
  } else {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm0 + i * 16 + g + 8 * h;
        if (m >= p.M) continue;
        float* row = p.out + static_cast<size_t>(m) * p.N;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = n0 + wn0 + j * 8 + 2 * t;
          if (n < p.N) row[n] = epilogue(p.K, acc[i][j][2 * h], sc[j][0], ad[j][0]);
          if (n + 1 < p.N)
            row[n + 1] = epilogue(p.K, acc[i][j][2 * h + 1], sc[j][1], ad[j][1]);
        }
      }
  }
}

template <int TILE, bool VEC, int SPLIT>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<TILE, SPLIT>();
  auto* kernel = popcount_gemm_kernel<TILE, VEC, SPLIT>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const dim3 grid((p.M + TILE - 1) / TILE, (p.N + TILE - 1) / TILE);
  kernel<<<grid, GROUP * SPLIT, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int TILE, bool VEC>
int pick_split(const Params& p, int split, cudaStream_t stream) {
  if (split == 1) return launch<TILE, VEC, 1>(p, stream);
  if (split == 2) return launch<TILE, VEC, 2>(p, stream);
  if (split == 4) return launch<TILE, VEC, 4>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int TILE>
int pick_loader(const Params& p, int vector_loads, int split,
                cudaStream_t stream) {
  return vector_loads ? pick_split<TILE, true>(p, split, stream)
                      : pick_split<TILE, false>(p, split, stream);
}

}  // namespace

// xp: (M, KW) int32 words; wp: (KW, N) int32 words; scale, add: (N,) f32;
// out: (M, N) f32. `tile` (64 or 32 outputs a side), `vector_loads` (8-byte
// x and 16-byte w copies; the caller checks that KW, N and both pointers
// allow them) and `split` (1, 2 or 4 warp groups sharing K) come from the
// host plan. Launches on `stream` and returns cudaGetLastError().
extern "C" int bnn_popcount_gemm(const void* xp, const void* wp,
                                 const void* scale, const void* add, void* out,
                                 int M, int KW, int N, int K, int tile,
                                 int vector_loads, int split, void* stream) {
  if (KW != (K + 31) / 32 || M < 1 || N < 1 || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.x = static_cast<const uint32_t*>(xp);
  p.w = static_cast<const uint32_t*>(wp);
  p.scale = static_cast<const float*>(scale);
  p.add = static_cast<const float*>(add);
  p.out = static_cast<float*>(out);
  p.M = M;
  p.KW = KW;
  p.N = N;
  p.K = K;
  const auto s = static_cast<cudaStream_t>(stream);
  if (tile == 64) return pick_loader<64>(p, vector_loads, split, s);
  if (tile == 32) return pick_loader<32>(p, vector_loads, split, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
