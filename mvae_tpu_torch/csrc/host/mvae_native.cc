// The port's host library for the data layer (its own copy of the JAX
// package's mvae_native.cc; the arithmetic is that file's, so that both
// write the same MultiMNIST shards on one host). Built with g++ at first
// use by mvae_tpu_torch/data/native.py as the `core` library:
//
//   * multimnist_generate: the MultiMNIST compositing generator
//     (behavioural spec: the reference's multimnist/datasets.py:107-204 —
//     k ~ U{min..max} digits per 50x50 canvas; each digit SHRUNK to side
//     int(28/s), s ~ N(1.3, 0.1) (imresize(digit, 1/s) semantics, :112-113);
//     random placement with offsets in [0, 50-side-1] (:120-122); digits
//     summed; if any final pixel exceeds 255 the WHOLE canvas is redrawn —
//     identities, scales and positions all resampled — and labels are only
//     recorded for accepted canvases (:141-146)). The reference runs ~60k
//     Python-level composites; this is the same algorithm in C++
//     (deterministic xoshiro/Box-Muller RNG: not bit-identical to numpy's
//     Generator, the same distribution).
//
// The JAX source's row gather (gather_rows_{u8,f32}) is left out: numpy's
// fancy indexing gathers the port's batches (data/pipeline.py).
//
// A plain C ABI, bound with ctypes.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>

namespace {

// SplitMix64 seeding + xoshiro256** core: deterministic, seedable.
struct Rng {
  uint64_t s[4];
  explicit Rng(uint64_t seed) {
    uint64_t x = seed;
    for (int i = 0; i < 4; i++) {
      x += 0x9e3779b97f4a7c15ULL;
      uint64_t z = x;
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      s[i] = z ^ (z >> 31);
    }
  }
  static uint64_t rotl(uint64_t x, int k) { return (x << k) | (x >> (64 - k)); }
  uint64_t next() {
    uint64_t result = rotl(s[1] * 5, 7) * 9;
    uint64_t t = s[1] << 17;
    s[2] ^= s[0]; s[3] ^= s[1]; s[1] ^= s[2]; s[0] ^= s[3];
    s[2] ^= t; s[3] = rotl(s[3], 45);
    return result;
  }
  // uniform in [0, 1)
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
  // uniform integer in [0, n)
  int64_t randint(int64_t n) { return (int64_t)(uniform() * n); }
  // standard normal via Box-Muller
  double normal() {
    double u1 = uniform(), u2 = uniform();
    if (u1 < 1e-300) u1 = 1e-300;
    return std::sqrt(-2.0 * std::log(u1)) * std::cos(6.283185307179586 * u2);
  }
};

constexpr int kCanvas = 50;
constexpr int kSrc = 28;
constexpr int kMaxLen = 4;
constexpr int kFill = 11;

// bilinear resize (align_corners=false), src 28x28 float -> dst hw x hw
void resize_digit(const float* src, float* dst, int hw) {
  for (int y = 0; y < hw; y++) {
    double sy = (y + 0.5) * kSrc / hw - 0.5;
    int y0 = std::clamp((int)std::floor(sy), 0, kSrc - 1);
    int y1 = std::min(y0 + 1, kSrc - 1);
    double wy = std::clamp(sy - y0, 0.0, 1.0);
    for (int x = 0; x < hw; x++) {
      double sx = (x + 0.5) * kSrc / hw - 0.5;
      int x0 = std::clamp((int)std::floor(sx), 0, kSrc - 1);
      int x1 = std::min(x0 + 1, kSrc - 1);
      double wx = std::clamp(sx - x0, 0.0, 1.0);
      double a = src[y0 * kSrc + x0], b = src[y0 * kSrc + x1];
      double c = src[y1 * kSrc + x0], d = src[y1 * kSrc + x1];
      dst[y * hw + x] = (float)(a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx +
                                c * wy * (1 - wx) + d * wy * wx);
    }
  }
}

}  // namespace

extern "C" {

// digits: (n_pool, 28, 28) uint8; labels: (n_pool,) int32
// out_images: (n_out, 50, 50) uint8; out_texts: (n_out, 4) int32
// (FILL-padded). Returns the number of canvases that exhausted the retry
// budget (0 on success; the Python wrapper raises on nonzero — matching
// the numpy path's RuntimeError instead of silently emitting blanks).
int64_t multimnist_generate(const uint8_t* digits, const int32_t* labels,
                            int64_t n_pool, int64_t n_out, int min_digits,
                            int max_digits, int do_resize, int do_translate,
                            uint64_t seed, uint8_t* out_images,
                            int32_t* out_texts) {
  int64_t n_failed = 0;
  Rng rng(seed);
  float canvas[kCanvas * kCanvas];
  float srcbuf[kSrc * kSrc];
  float resized[kCanvas * kCanvas];

  for (int64_t i = 0; i < n_out; i++) {
    int k = min_digits + (int)rng.randint(max_digits - min_digits + 1);
    int32_t accepted[kMaxLen] = {0, 0, 0, 0};
    // Reject-and-fully-redraw: a canvas whose summed max exceeds 255 is
    // discarded ENTIRELY (new digit identities, scales, positions), exactly
    // as the reference's recursive retry (datasets.py:141-146). kMaxTries
    // only guards pathological configs the reference would RecursionError
    // on (e.g. no-translate with k >= 2).
    const int kMaxTries = 10000;
    bool ok = false;
    for (int attempt_i = 0; attempt_i < kMaxTries && !ok; attempt_i++) {
      std::memset(canvas, 0, sizeof(canvas));
      int32_t chosen[kMaxLen] = {0, 0, 0, 0};
      for (int j = 0; j < k; j++) {
        int64_t idx = rng.randint(n_pool);
        chosen[j] = (int32_t)labels[idx];
        const uint8_t* d8 = digits + idx * kSrc * kSrc;
        for (int p = 0; p < kSrc * kSrc; p++) srcbuf[p] = (float)d8[p];
        const float* img = srcbuf;
        int hw = kSrc;
        if (do_resize) {
          // imresize(digit, 1/s): side = int(28/s), truncated (:112-113)
          double s = 1.3 + 0.1 * rng.normal();
          hw = (s <= 0.0) ? 1 : std::clamp((int)(kSrc / s), 1, kCanvas);
          resize_digit(srcbuf, resized, hw);
          img = resized;
        }
        int padding = kCanvas - hw;
        int top, left;
        if (do_translate && padding > 0) {
          // randint(0, padding) EXCLUDES padding (:120-122)
          top = (int)rng.randint(padding);
          left = (int)rng.randint(padding);
        } else {
          top = left = padding / 2;
        }
        for (int y = 0; y < hw; y++) {
          for (int x = 0; x < hw; x++) {
            canvas[(top + y) * kCanvas + (left + x)] += img[y * hw + x];
          }
        }
      }
      float mx = 0.0f;
      for (int p = 0; p < kCanvas * kCanvas; p++) mx = std::max(mx, canvas[p]);
      if (mx <= 255.0f) {
        ok = true;
        for (int j = 0; j < k; j++) accepted[j] = chosen[j];
      }
    }
    if (!ok) {
      // unreachable for the reference's real-MNIST pools (sparse ink);
      // reported to the caller, which raises
      n_failed++;
      std::memset(canvas, 0, sizeof(canvas));
      k = 0;
    }
    uint8_t* out = out_images + i * kCanvas * kCanvas;
    for (int p = 0; p < kCanvas * kCanvas; p++) {
      out[p] = (uint8_t)canvas[p];
    }
    int32_t* text = out_texts + i * kMaxLen;
    for (int j = 0; j < kMaxLen; j++) {
      text[j] = (j < k) ? accepted[j] : kFill;
    }
  }
  return n_failed;
}

int mvae_native_abi_version() { return 4; }

}  // extern "C"
