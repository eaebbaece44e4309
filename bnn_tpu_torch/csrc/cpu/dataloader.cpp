// Native batch-assembly engine for the input pipeline of bnn_tpu_torch.
//
// It gathers a batch of samples by index from a (possibly memory-mapped)
// uint8 NHWC image store, applies the training augmentations (zero- or
// reflect-padded random crop + horizontal flip, torchvision's RandomCrop /
// RandomHorizontalFlip semantics) and writes normalized float32 in NCHW,
// the layout the port's models take, directly into the caller's buffer.
// Sample b's pixel (y, x, c) is the value bnn_tpu/native/dataloader.cpp
// writes at NHWC (b, y, x, c): the same arithmetic and the same RNG, only
// the place it lands differs.
//
// Parallelism: OpenMP across samples within the batch (one ctypes call,
// GIL released). Pipeline overlap with device compute comes from the Python
// prefetcher (bnn_tpu_torch.data.prefetch_to_device) running this call in a
// background thread.
//
// Determinism: each sample's augmentation RNG is splitmix64(seed ^ global
// index), so results are independent of thread scheduling and batch order.
#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

// reflect index into [0, n) without repeating the edge (numpy 'reflect')
inline int64_t reflect(int64_t v, int64_t n) {
  if (n == 1) return 0;
  const int64_t period = 2 * (n - 1);
  v %= period;
  if (v < 0) v += period;
  return v < n ? v : period - v;
}

}  // namespace

extern "C" {

// Gather + augment + normalize one batch.
//
//   images : (N, H, W, C) uint8, C-contiguous (may be a numpy mmap)
//   indices: (batch,) int64 sample indices into images/labels
//   labels : (N,) int32 (may be null; then out_y is untouched)
//   out_x  : (batch, C, H, W) float32, prealloc'd by caller
//   out_y  : (batch,) int32
//   scale/bias: (C,) float32 per-channel affine: out = u8 * scale + bias
//               (normalize (x/255 - mean)/std as scale=1/(255 std),
//                bias=-mean/std)
//   pad    : random-crop padding; 0 disables the crop
//   pad_mode: 0 = zeros (torchvision RandomCrop default), 1 = reflect
//   do_flip: 1 enables random horizontal flip
//   seed   : epoch seed; sample RNG = splitmix64(seed ^ index)
void bnn_load_batch(const uint8_t* images, int64_t H, int64_t W, int64_t C,
                    const int64_t* indices, int64_t batch,
                    const int32_t* labels, float* out_x, int32_t* out_y,
                    const float* scale, const float* bias, int64_t pad,
                    int pad_mode, int do_flip, uint64_t seed) {
  const int64_t plane = H * W * C;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t b = 0; b < batch; ++b) {
    const int64_t idx = indices[b];
    const uint8_t* src = images + idx * plane;
    float* dst = out_x + b * plane;
    if (labels && out_y) out_y[b] = labels[idx];

    int64_t oy = 0, ox = 0;
    bool flip = false;
    if (pad > 0 || do_flip) {
      uint64_t r = splitmix64(seed ^ static_cast<uint64_t>(idx));
      if (pad > 0) {
        oy = static_cast<int64_t>(r % (2 * pad + 1));
        r = splitmix64(r);
        ox = static_cast<int64_t>(r % (2 * pad + 1));
        r = splitmix64(r);
      }
      if (do_flip) flip = (r & 1ULL) != 0;
    }

    const int64_t hw = H * W;
    for (int64_t y = 0; y < H; ++y) {
      // source row in the virtual padded image, mapped back to the original
      const int64_t sy = y + oy - pad;
      const bool row_oob = (sy < 0 || sy >= H);
      const int64_t ry = pad_mode == 1 ? reflect(sy, H) : sy;
      float* drow = dst + y * W;
      for (int64_t x = 0; x < W; ++x) {
        const int64_t xx = flip ? (W - 1 - x) : x;
        const int64_t sx = xx + ox - pad;
        const bool oob = row_oob || sx < 0 || sx >= W;
        if (oob && pad_mode == 0) {
          for (int64_t c = 0; c < C; ++c) drow[c * hw + x] = bias[c];  // u8 value 0
          continue;
        }
        const int64_t rx = pad_mode == 1 ? reflect(sx, W) : sx;
        const uint8_t* spix = src + (ry * W + rx) * C;
        for (int64_t c = 0; c < C; ++c) {
          drow[c * hw + x] = static_cast<float>(spix[c]) * scale[c] + bias[c];
        }
      }
    }
  }
}

int bnn_loader_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
