// Fused anyres tile extraction: bicubic resize + center-pad + tile, one pass
// (the port's copy of radvlm_tpu/native/anyres.cc).
//
// Native runtime component of the host image pipeline (the reference leans on
// torch DataLoader's C++ workers + PIL). Takes a decoded uint8
// HWC RGB image and emits the [T, ts, ts, 3] uint8 tile stack (base tile first,
// then the grid tiles of the aspect-preserving resize-and-pad), OpenMP-parallel
// over output rows. Bicubic uses the Keys kernel (a = -0.5) with PIL-style
// antialiasing (filter support scaled by the downscale factor), matching the
// Python path within ±2/255 (exact PIL parity is kept by the PIL path, which
// remains the golden reference for training).
//
// Built by radvlm_tpu_torch/native/__init__.py: c++ -O3 -fopenmp -shared -fPIC.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Keys bicubic kernel, a = -0.5 (PIL / OpenCV convention).
inline double cubic(double x) {
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct Weights {
  std::vector<int> first;       // first source index per output pixel
  std::vector<double> coeffs;   // ksize coefficients per output pixel
  int ksize = 0;
};

// PIL-style separable resample weights with antialiasing on downscale.
Weights compute_weights(int in_size, int out_size) {
  Weights w;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 2.0 * filterscale;
  w.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  w.first.resize(out_size);
  w.coeffs.assign(static_cast<size_t>(out_size) * w.ksize, 0.0);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    double total = 0.0;
    double* k = &w.coeffs[static_cast<size_t>(xx) * w.ksize];
    for (int x = xmin; x < xmax; ++x) {
      const double weight = cubic((x - center + 0.5) / filterscale);
      k[x - xmin] = weight;
      total += weight;
    }
    if (total != 0.0) {
      for (int x = 0; x < xmax - xmin; ++x) k[x] /= total;
    }
    w.first[xx] = xmin;
    // zero-fill the tail so ksize iterations are safe
    for (int x = xmax - xmin; x < w.ksize; ++x) k[x] = 0.0;
  }
  return w;
}

inline uint8_t clamp8(double v) {
  return static_cast<uint8_t>(v < 0.0 ? 0.0 : (v > 255.0 ? 255.0 : v + 0.5));
}

// Separable bicubic resize uint8 HWC -> uint8 HWC.
void resize_bicubic(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
                    int dw) {
  const Weights wx = compute_weights(sw, dw);
  const Weights wy = compute_weights(sh, dh);
  // horizontal pass into a float intermediate [sh, dw, 3]
  std::vector<float> tmp(static_cast<size_t>(sh) * dw * 3);
#pragma omp parallel for schedule(static)
  for (int y = 0; y < sh; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * sw * 3;
    float* out = &tmp[static_cast<size_t>(y) * dw * 3];
    for (int x = 0; x < dw; ++x) {
      const double* k = &wx.coeffs[static_cast<size_t>(x) * wx.ksize];
      const int x0 = wx.first[x];
      double acc[3] = {0, 0, 0};
      const int kn = std::min(wx.ksize, sw - x0);
      for (int i = 0; i < kn; ++i) {
        const uint8_t* px = row + static_cast<size_t>(x0 + i) * 3;
        acc[0] += k[i] * px[0];
        acc[1] += k[i] * px[1];
        acc[2] += k[i] * px[2];
      }
      // PIL quantizes the horizontal pass to uint8 before the vertical pass;
      // match that so edge pixels agree.
      out[x * 3 + 0] = static_cast<float>(clamp8(acc[0]));
      out[x * 3 + 1] = static_cast<float>(clamp8(acc[1]));
      out[x * 3 + 2] = static_cast<float>(clamp8(acc[2]));
    }
  }
  // vertical pass
#pragma omp parallel for schedule(static)
  for (int y = 0; y < dh; ++y) {
    const double* k = &wy.coeffs[static_cast<size_t>(y) * wy.ksize];
    const int y0 = wy.first[y];
    uint8_t* out = dst + static_cast<size_t>(y) * dw * 3;
    const int kn = std::min(wy.ksize, sh - y0);
    for (int x = 0; x < dw; ++x) {
      double acc[3] = {0, 0, 0};
      for (int i = 0; i < kn; ++i) {
        const float* px = &tmp[(static_cast<size_t>(y0 + i) * dw + x) * 3];
        acc[0] += k[i] * px[0];
        acc[1] += k[i] * px[1];
        acc[2] += k[i] * px[2];
      }
      out[x * 3 + 0] = clamp8(acc[0]);
      out[x * 3 + 1] = clamp8(acc[1]);
      out[x * 3 + 2] = clamp8(acc[2]);
    }
  }
}

}  // namespace

extern "C" {

// Produce the anyres tile stack for one image.
//   img:    uint8 [h, w, 3]
//   tiles:  out uint8 [1 + (best_h/ts)*(best_w/ts), ts, ts, 3]
//   ts:     tile size; best_w/best_h: selected grid resolution;
//   new_w/new_h: aspect-preserving resize target inside the padded canvas.
// Returns the number of tiles written.
int anyres_tiles(const uint8_t* img, int h, int w, uint8_t* tiles, int ts,
                 int best_w, int best_h, int new_w, int new_h) {
  const size_t tile_bytes = static_cast<size_t>(ts) * ts * 3;
  // base tile: square resize of the full image
  resize_bicubic(img, h, w, tiles, ts, ts);

  // padded canvas with the aspect-preserving resize centered
  std::vector<uint8_t> canvas(static_cast<size_t>(best_h) * best_w * 3, 0);
  std::vector<uint8_t> resized(static_cast<size_t>(new_h) * new_w * 3);
  resize_bicubic(img, h, w, resized.data(), new_h, new_w);
  const int y0 = (best_h - new_h) / 2;
  const int x0 = (best_w - new_w) / 2;
#pragma omp parallel for schedule(static)
  for (int y = 0; y < new_h; ++y) {
    std::memcpy(&canvas[((static_cast<size_t>(y0 + y)) * best_w + x0) * 3],
                &resized[static_cast<size_t>(y) * new_w * 3],
                static_cast<size_t>(new_w) * 3);
  }

  const int gh = best_h / ts, gw = best_w / ts;
  int t = 1;
  for (int gy = 0; gy < gh; ++gy) {
    for (int gx = 0; gx < gw; ++gx, ++t) {
      uint8_t* dst = tiles + static_cast<size_t>(t) * tile_bytes;
      for (int y = 0; y < ts; ++y) {
        std::memcpy(
            dst + static_cast<size_t>(y) * ts * 3,
            &canvas[((static_cast<size_t>(gy) * ts + y) * best_w +
                     static_cast<size_t>(gx) * ts) *
                    3],
            static_cast<size_t>(ts) * 3);
      }
    }
  }
  return t;
}

// Plain resize entry (for the single-tile path and tests).
void resize_rgb(const uint8_t* img, int h, int w, uint8_t* out, int oh,
                int ow) {
  resize_bicubic(img, h, w, out, oh, ow);
}

}  // extern "C"
