// Native host-side image kernels for the data pipeline (a copy of
// mask_yolo_tpu/native/image_ops.cpp; host code, not a device kernel).
//
// The reference's data layer leans on cv2/skimage/scipy C code
// (reference myolo/myolo_utils.py:369-455, example shapes rasterization
// dataset_shapes.py:121-135); this framework's host fallbacks are pure numpy
// (utils/image.py), which profiling shows dominate training
// batch build time (resize_bilinear + polygon rasterization ≈ 2/3 of it).
// These C++ kernels are bit-compatible replacements dispatched from
// utils/image.py when the extension builds; the numpy versions stay as the
// golden reference (tests/test_native.py asserts exact agreement).
//
// Called through ctypes, so every call releases the GIL — a thread-pooled
// loader gets real CPU parallelism out of them.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Bilinear resize with half-pixel centers and edge clamping, float32 I/O.
// Matches utils/image.py:resize_bilinear: coords in double, weights in
// float, lerp order top/bot then vertical.
void resize_bilinear_f32(const float* src, int64_t in_h, int64_t in_w,
                         int64_t c, float* dst, int64_t out_h, int64_t out_w,
                         int align_corners) {
  std::vector<int64_t> x0(out_w), x1(out_w);
  std::vector<float> wx(out_w);
  for (int64_t ox = 0; ox < out_w; ++ox) {
    double x;
    if (align_corners && out_w > 1) {
      x = (double)ox * (double)(in_w - 1) / (double)(out_w - 1);
    } else {
      x = ((double)ox + 0.5) * ((double)in_w / (double)out_w) - 0.5;
    }
    x = std::min(std::max(x, 0.0), (double)(in_w - 1));
    int64_t xf = (int64_t)std::floor(x);
    x0[ox] = xf;
    x1[ox] = std::min(xf + 1, in_w - 1);
    wx[ox] = (float)(x - (double)xf);
  }
  for (int64_t oy = 0; oy < out_h; ++oy) {
    double y;
    if (align_corners && out_h > 1) {
      y = (double)oy * (double)(in_h - 1) / (double)(out_h - 1);
    } else {
      y = ((double)oy + 0.5) * ((double)in_h / (double)out_h) - 0.5;
    }
    y = std::min(std::max(y, 0.0), (double)(in_h - 1));
    int64_t y0 = (int64_t)std::floor(y);
    int64_t y1 = std::min(y0 + 1, in_h - 1);
    float wy = (float)(y - (double)y0);
    const float* row0 = src + y0 * in_w * c;
    const float* row1 = src + y1 * in_w * c;
    float* out_row = dst + oy * out_w * c;
    for (int64_t ox = 0; ox < out_w; ++ox) {
      const float* p00 = row0 + x0[ox] * c;
      const float* p01 = row0 + x1[ox] * c;
      const float* p10 = row1 + x0[ox] * c;
      const float* p11 = row1 + x1[ox] * c;
      float fx = wx[ox];
      float* o = out_row + ox * c;
      for (int64_t ch = 0; ch < c; ++ch) {
        float top = p00[ch] * (1.0f - fx) + p01[ch] * fx;
        float bot = p10[ch] * (1.0f - fx) + p11[ch] * fx;
        o[ch] = top * (1.0f - wy) + bot * wy;
      }
    }
  }
}

// Nearest-neighbour resize, byte-wise over the trailing axis (works for any
// dtype: c = channels * itemsize). Index mapping matches
// scipy.ndimage.zoom(order=0) as implemented in utils/image.py:
// round(out_idx * in/out), clipped.
void resize_nearest_bytes(const uint8_t* src, int64_t in_h, int64_t in_w,
                          int64_t c, uint8_t* dst, int64_t out_h,
                          int64_t out_w) {
  std::vector<int64_t> xs(out_w);
  double sx = (double)in_w / (double)out_w;
  double sy = (double)in_h / (double)out_h;
  for (int64_t ox = 0; ox < out_w; ++ox) {
    // numpy round = round-half-even; match it exactly
    int64_t xi = (int64_t)std::nearbyint((double)ox * sx);
    xs[ox] = std::min(std::max(xi, (int64_t)0), in_w - 1);
  }
  for (int64_t oy = 0; oy < out_h; ++oy) {
    int64_t yi = (int64_t)std::nearbyint((double)oy * sy);
    yi = std::min(std::max(yi, (int64_t)0), in_h - 1);
    const uint8_t* row = src + yi * in_w * c;
    uint8_t* out_row = dst + oy * out_w * c;
    for (int64_t ox = 0; ox < out_w; ++ox) {
      std::memcpy(out_row + ox * c, row + xs[ox] * c, (size_t)c);
    }
  }
}

// Even-odd polygon rasterization at pixel centers; out is a [h, w] uint8
// mask (1 = inside). Matches utils/image.py:polygon_mask: a pixel px is
// inside iff the number of edge crossings with x_intersection > px is odd.
void polygon_mask_u8(const double* xs, const double* ys, int64_t n,
                     uint8_t* out, int64_t h, int64_t w) {
  std::memset(out, 0, (size_t)(h * w));
  if (n < 3) return;
  std::vector<double> cross;
  cross.reserve((size_t)n);
  for (int64_t row = 0; row < h; ++row) {
    double py = (double)row;
    cross.clear();
    int64_t j = n - 1;
    for (int64_t i = 0; i < n; ++i) {
      double yi = ys[i], yj = ys[j];
      if ((yi > py) != (yj > py)) {
        cross.push_back((xs[j] - xs[i]) * (py - yi) / (yj - yi) + xs[i]);
      }
      j = i;
    }
    if (cross.empty()) continue;
    std::sort(cross.begin(), cross.end());
    uint8_t* out_row = out + row * w;
    size_t k = cross.size(), idx = 0;
    for (int64_t px = 0; px < w; ++px) {
      while (idx < k && cross[idx] <= (double)px) ++idx;
      out_row[px] = (uint8_t)((k - idx) & 1);
    }
  }
}

// Filled circle: pixels whose centers satisfy (x-cx)² + (y-cy)² <= r²
// (integer arithmetic — matches utils/image.py:fill_circle). Writes 1s into
// the [h, w] uint8 mask without clearing it first.
void circle_mask_u8(uint8_t* out, int64_t h, int64_t w, int64_t cx,
                    int64_t cy, int64_t r) {
  int64_t r2 = r * r;
  int64_t y_lo = std::max((int64_t)0, cy - r);
  int64_t y_hi = std::min(h - 1, cy + r);
  for (int64_t y = y_lo; y <= y_hi; ++y) {
    int64_t dy2 = (y - cy) * (y - cy);
    uint8_t* out_row = out + y * w;
    int64_t x_lo = std::max((int64_t)0, cx - r);
    int64_t x_hi = std::min(w - 1, cx + r);
    for (int64_t x = x_lo; x <= x_hi; ++x) {
      if ((x - cx) * (x - cx) + dy2 <= r2) out_row[x] = 1;
    }
  }
}

}  // extern "C"
