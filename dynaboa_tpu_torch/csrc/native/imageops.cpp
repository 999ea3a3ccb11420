// Host-side image preprocessing ops (C++).
//
// Native replacement for the reference's cv2/skimage host path
// (utils/dataprocess.py crop:48-96 + torchvision Normalize): zero-padded
// bounding-box crop, bilinear resize with half-pixel centers and optional
// 2x supersampled box filtering (anti-aliasing), scale to [0,1] and
// ImageNet-normalize — one pass, OpenMP-parallel over output rows.
//
// Exposed as a C ABI for ctypes binding.

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

inline float sample_zero_pad(const float* img, int H, int W, int C, float y,
                             float x, int c) {
  // bilinear tap with zero padding outside the image
  int x0 = static_cast<int>(std::floor(x));
  int y0 = static_cast<int>(std::floor(y));
  float wx = x - x0, wy = y - y0;
  float acc = 0.f;
  for (int dy = 0; dy < 2; ++dy) {
    int yy = y0 + dy;
    if (yy < 0 || yy >= H) continue;
    float fy = dy ? wy : 1.f - wy;
    for (int dx = 0; dx < 2; ++dx) {
      int xx = x0 + dx;
      if (xx < 0 || xx >= W) continue;
      float fx = dx ? wx : 1.f - wx;
      acc += fy * fx * img[(static_cast<size_t>(yy) * W + xx) * C + c];
    }
  }
  return acc;
}

}  // namespace

extern "C" {

// img: (H, W, 3) float32 RGB in [0, 255]
// out: (out_res, out_res, 3) float32, ImageNet-normalized
// The integer crop box (ulx, uly, brx, bry) is computed host-side by the
// authoritative python implementation (ops/image.crop_bounds) — its exact
// integer-truncation convention depends on np.linalg.inv float rounding
// (dataprocess.py:39-54), so it is NOT re-derived here.
int crop_resize_normalize(const float* img, int H, int W, int iulx, int iuly,
                          int ibrx, int ibry, int out_res, int supersample,
                          const float* mean, const float* std_,
                          float* out) {
  const float ulx = static_cast<float>(iulx);
  const float uly = static_cast<float>(iuly);
  const float bw = static_cast<float>(ibrx - iulx);
  const float bh = static_cast<float>(ibry - iuly);
  const int ss = std::max(1, supersample);
  const int res = out_res * ss;
  const float inv255 = 1.f / 255.f;

#pragma omp parallel for schedule(static)
  for (int oy = 0; oy < out_res; ++oy) {
    for (int ox = 0; ox < out_res; ++ox) {
      float acc[3] = {0.f, 0.f, 0.f};
      for (int sy = 0; sy < ss; ++sy) {
        int ry = oy * ss + sy;
        // half-pixel convention, clamped at the patch border (the zero
        // padding lives at the *patch* border in the reference)
        float yp = (ry + 0.5f) * bh / res - 0.5f;
        yp = std::min(std::max(yp, 0.f), bh - 1.f);
        float ysrc = yp + uly;
        for (int sx = 0; sx < ss; ++sx) {
          int rx = ox * ss + sx;
          float xp = (rx + 0.5f) * bw / res - 0.5f;
          xp = std::min(std::max(xp, 0.f), bw - 1.f);
          float xsrc = xp + ulx;
          for (int c = 0; c < 3; ++c)
            acc[c] += sample_zero_pad(img, H, W, 3, ysrc, xsrc, c);
        }
      }
      float norm = 1.f / (ss * ss);
      float* o = out + (static_cast<size_t>(oy) * out_res + ox) * 3;
      for (int c = 0; c < 3; ++c)
        o[c] = (acc[c] * norm * inv255 - mean[c]) / std_[c];
    }
  }
  return 0;
}

// uint8 variant (decodes typical image buffers without a float copy)
int crop_resize_normalize_u8(const uint8_t* img, int H, int W, int iulx,
                             int iuly, int ibrx, int ibry, int out_res,
                             int supersample, const float* mean,
                             const float* std_, float* out) {
  // convert lazily into a thread-local row cache would be fancier; for the
  // streaming use case a one-shot buffer conversion is fast enough
  const size_t n = static_cast<size_t>(H) * W * 3;
  float* tmp = new float[n];
#pragma omp parallel for schedule(static)
  for (long long i = 0; i < static_cast<long long>(n); ++i)
    tmp[i] = static_cast<float>(img[i]);
  int rc = crop_resize_normalize(tmp, H, W, iulx, iuly, ibrx, ibry, out_res,
                                 supersample, mean, std_, out);
  delete[] tmp;
  return rc;
}

}  // extern "C"
