// Host-side XNOR/popcount binary GEMM engine.
//
// The CPU engine of bnn_tpu_torch.native: bit-packed XNOR/popcount
// execution on the host, beside the card's kernels in csrc/.
//
// Layout contract matches bnn_tpu_torch.kernels.packing:
//   packed word w, bit j  <->  element k = w*32 + j, bit = (x >= 0)
//   A: (M, Kw) uint32 packed activations (row-major)
//   B: (Kw, N) uint32 packed weights (row-major; column n in word-lane order)
//   dot(m, n) = K - 2 * popcount(A[m] XOR B[:, n])   (padding bits cancel)
//   out(m, n) = dot * scale[n] + add[n]
//
// Built by bnn_tpu_torch/native/__init__.py with
// g++ -O3 -march=native -fopenmp -shared -fPIC.

#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// Pack the sign bits of float rows: x (M, K) row-major -> out (M, Kw) uint32.
void bnn_pack_rows(const float* x, uint32_t* out, int64_t m, int64_t k) {
  const int64_t kw = (k + 31) / 32;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < m; ++i) {
    const float* row = x + i * k;
    uint32_t* orow = out + i * kw;
    for (int64_t w = 0; w < kw; ++w) {
      uint32_t word = 0;
      const int64_t base = w * 32;
      const int64_t hi = (base + 32 < k) ? base + 32 : k;
      for (int64_t j = base; j < hi; ++j) {
        word |= (uint32_t)(row[j] >= 0.0f) << (j - base);
      }
      orow[w] = word;
    }
  }
}

// Transpose-and-pack a (K, N) float weight matrix into B (Kw, N) uint32 with
// the packing layout above (word r holds bits for k = r*32 .. r*32+31).
void bnn_pack_weights(const float* wkn, uint32_t* out, int64_t k, int64_t n) {
  const int64_t kw = (k + 31) / 32;
  std::memset(out, 0, sizeof(uint32_t) * kw * n);
#pragma omp parallel for schedule(static)
  for (int64_t w = 0; w < kw; ++w) {
    const int64_t base = w * 32;
    const int64_t hi = (base + 32 < k) ? base + 32 : k;
    uint32_t* orow = out + w * n;
    for (int64_t kk = base; kk < hi; ++kk) {
      const float* wrow = wkn + kk * n;
      const uint32_t bit = 1u << (kk - base);
      for (int64_t j = 0; j < n; ++j) {
        if (wrow[j] >= 0.0f) orow[j] |= bit;
      }
    }
  }
}

// Binary GEMM over packed operands.
//   a:     (M, Kw) uint32
//   b:     (Kw, N) uint32
//   out:   (M, N) float
//   scale: (N) or nullptr, add: (N) or nullptr
// Tiled over N so the B panel stays in cache; popcount via builtin (lowers
// to POPCNT/NEON-CNT under -march=native).
void bnn_gemm(const uint32_t* a, const uint32_t* b, float* out,
              int64_t m, int64_t k, int64_t n,
              const float* scale, const float* add) {
  const int64_t kw = (k + 31) / 32;
  const int64_t NT = 64;  // N-tile
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < m; ++i) {
    const uint32_t* arow = a + i * kw;
    float* orow = out + i * n;
    for (int64_t n0 = 0; n0 < n; n0 += NT) {
      const int64_t n1 = (n0 + NT < n) ? n0 + NT : n;
      int32_t acc[64];
      for (int64_t j = n0; j < n1; ++j) acc[j - n0] = 0;
      for (int64_t w = 0; w < kw; ++w) {
        const uint32_t aw = arow[w];
        const uint32_t* brow = b + w * n;
        for (int64_t j = n0; j < n1; ++j) {
          acc[j - n0] += __builtin_popcount(aw ^ brow[j]);
        }
      }
      for (int64_t j = n0; j < n1; ++j) {
        float dot = (float)(k - 2 * acc[j - n0]);
        if (scale) dot *= scale[j];
        if (add) dot += add[j];
        orow[j] = dot;
      }
    }
  }
}

// Convenience: float activations in, packs rows then runs bnn_gemm.
void bnn_gemm_f32(const float* x, const uint32_t* b, float* out,
                  uint32_t* scratch, int64_t m, int64_t k, int64_t n,
                  const float* scale, const float* add) {
  bnn_pack_rows(x, scratch, m, k);
  bnn_gemm(scratch, b, out, m, k, n, scale, add);
}

int bnn_num_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
