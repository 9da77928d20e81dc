// Bilinear uint8 HWC resize (half-pixel centers, clamped edges) — the
// native analog of the reference's OpenCV ResizeImage stage
// (ImageTransformer.scala:34-64); used by the batch loader to produce
// fixed-shape batches.

#include "mmltpu.h"

#include <algorithm>
#include <cmath>

extern "C" void mmltpu_resize_bilinear(const uint8_t *src, int h, int w,
                                       int c, uint8_t *dst, int out_h,
                                       int out_w) {
  const float sy = static_cast<float>(h) / out_h;
  const float sx = static_cast<float>(w) / out_w;
  for (int oy = 0; oy < out_h; ++oy) {
    float fy = (oy + 0.5f) * sy - 0.5f;
    fy = std::max(0.0f, std::min(fy, static_cast<float>(h - 1)));
    const int y0 = static_cast<int>(fy);
    const int y1 = std::min(y0 + 1, h - 1);
    const float wy = fy - y0;
    for (int ox = 0; ox < out_w; ++ox) {
      float fx = (ox + 0.5f) * sx - 0.5f;
      fx = std::max(0.0f, std::min(fx, static_cast<float>(w - 1)));
      const int x0 = static_cast<int>(fx);
      const int x1 = std::min(x0 + 1, w - 1);
      const float wx = fx - x0;
      const uint8_t *p00 = src + (static_cast<size_t>(y0) * w + x0) * c;
      const uint8_t *p01 = src + (static_cast<size_t>(y0) * w + x1) * c;
      const uint8_t *p10 = src + (static_cast<size_t>(y1) * w + x0) * c;
      const uint8_t *p11 = src + (static_cast<size_t>(y1) * w + x1) * c;
      uint8_t *o = dst + (static_cast<size_t>(oy) * out_w + ox) * c;
      for (int ch = 0; ch < c; ++ch) {
        const float top = p00[ch] + (p01[ch] - p00[ch]) * wx;
        const float bot = p10[ch] + (p11[ch] - p10[ch]) * wx;
        o[ch] = static_cast<uint8_t>(top + (bot - top) * wy + 0.5f);
      }
    }
  }
}
