// Weak-perspective mesh rasterizer (C++, no GPU/GL dependency).
//
// Replaces the reference's pyrender/EGL offscreen renderer
// (render_demo.py:33-134): same camera model (WeakPerspectiveCamera with
// projection x_ndc = sx * (x + tx), y_ndc = sy * (y - ty)), same 180-degree
// flip about the x axis applied to the mesh, Lambertian shading with an
// ambient term approximating the reference's three point lights, and an
// RGBA output whose alpha is the coverage mask used for compositing.
//
// Exposed as a C ABI for ctypes binding (no pybind11 dependency).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

inline Vec3 cross(const Vec3& a, const Vec3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

inline float dot(const Vec3& a, const Vec3& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

inline Vec3 normalize(const Vec3& v) {
  float n = std::sqrt(dot(v, v));
  if (n < 1e-12f) return {0.f, 0.f, 1.f};
  return {v.x / n, v.y / n, v.z / n};
}

}  // namespace

extern "C" {

// Render a triangle mesh over an image buffer.
//
//   verts:  (nv, 3) float32, SMPL camera-frame vertices (pre-flip)
//   faces:  (nf, 3) int32
//   cam:    [sx, sy, tx, ty] weak-perspective camera
//   color:  [r, g, b] in [0, 1]
//   rgba:   (H, W, 4) uint8 output, alpha = coverage
//   cull:   nonzero = skip camera-averted faces (closed outward-CCW meshes
//           like SMPL: halves raster work, matches pyrender's default
//           culling); zero = two-sided (arbitrary open meshes)
//
// Returns 0 on success.
int render_mesh(const float* verts, int nv, const int* faces, int nf,
                const float* cam, int width, int height, const float* color,
                uint8_t* rgba, int cull) {
  const float sx = cam[0], sy = cam[1], tx = cam[2], ty = cam[3];

  // 180-degree rotation about x (render_demo.py:90-91): (x, -y, -z).
  std::vector<Vec3> v(nv);
  for (int i = 0; i < nv; ++i) {
    v[i] = {verts[3 * i], -verts[3 * i + 1], -verts[3 * i + 2]};
  }

  // Project to pixel coordinates. NDC -> screen with y down.
  std::vector<float> px(nv), py(nv), pz(nv);
  for (int i = 0; i < nv; ++i) {
    float xn = sx * (v[i].x + tx);
    float yn = sy * (v[i].y - ty);
    px[i] = (xn + 1.f) * 0.5f * width;
    py[i] = (1.f - yn) * 0.5f * height;
    pz[i] = v[i].z;  // camera looks down -z: larger z == closer
  }

  std::vector<float> zbuf(static_cast<size_t>(width) * height,
                          -std::numeric_limits<float>::infinity());
  std::memset(rgba, 0, static_cast<size_t>(width) * height * 4);

  // Lights approximating the reference scene: ambient 0.3 + headlight-ish
  // point lights (render_demo.py:71-84), treated as directionals.
  const Vec3 lights[3] = {normalize({0.f, -1.f, 1.f}),
                          normalize({0.f, 1.f, 1.f}),
                          normalize({1.f, 1.f, 2.f})};
  const float light_I = 0.45f;
  const float ambient = 0.3f;

  for (int f = 0; f < nf; ++f) {
    int i0 = faces[3 * f], i1 = faces[3 * f + 1], i2 = faces[3 * f + 2];
    if (i0 < 0 || i0 >= nv || i1 < 0 || i1 >= nv || i2 < 0 || i2 >= nv)
      continue;

    // flat shading from the face normal (counter-clockwise winding)
    Vec3 e1 = {v[i1].x - v[i0].x, v[i1].y - v[i0].y, v[i1].z - v[i0].z};
    Vec3 e2 = {v[i2].x - v[i0].x, v[i2].y - v[i0].y, v[i2].z - v[i0].z};
    Vec3 n = normalize(cross(e1, e2));
    // Backface handling.  Culling is sound for closed meshes (camera-
    // averted faces are always occluded) and the weak-perspective
    // projection has positive scales, so world-space facing survives
    // projection.  Two-sided mode flips averted normals instead.
    if (n.z <= 0.f) {
      if (cull) continue;
      n = {-n.x, -n.y, -n.z};
    }
    float intensity = ambient;
    for (const auto& L : lights)
      intensity += light_I * std::max(0.f, dot(n, L));
    intensity = std::min(intensity, 1.f);

    float x0 = px[i0], y0 = py[i0], x1 = px[i1], y1 = py[i1];
    float x2 = px[i2], y2 = py[i2];
    float minx = std::max(0.f, std::floor(std::min({x0, x1, x2})));
    float maxx = std::min(static_cast<float>(width - 1),
                          std::ceil(std::max({x0, x1, x2})));
    float miny = std::max(0.f, std::floor(std::min({y0, y1, y2})));
    float maxy = std::min(static_cast<float>(height - 1),
                          std::ceil(std::max({y0, y1, y2})));
    // NaN-robust validity check: with NaN coordinates `minx > maxx` is
    // FALSE (all NaN comparisons are), so the negated form is required —
    // otherwise int(NaN) loop bounds walk billions of pixels per triangle.
    if (!(minx <= maxx && miny <= maxy)) continue;
    // Pathology guard: no legitimate body-mesh triangle covers a large
    // fraction of the screen at these resolutions.  When the model
    // diverges (e.g. garbage input before a reset), vertices explode and
    // each of the ~13k triangles otherwise rasterizes the whole frame —
    // seconds per frame on a 1-core host.
    if ((maxx - minx) * (maxy - miny) >
        0.25f * static_cast<float>(width) * static_cast<float>(height))
      continue;

    float denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2);
    if (std::fabs(denom) < 1e-12f) continue;
    float inv = 1.f / denom;

    uint8_t r8 = static_cast<uint8_t>(std::min(255.f, color[0] * intensity * 255.f));
    uint8_t g8 = static_cast<uint8_t>(std::min(255.f, color[1] * intensity * 255.f));
    uint8_t b8 = static_cast<uint8_t>(std::min(255.f, color[2] * intensity * 255.f));

    // Incremental barycentric evaluation: the edge functions are affine in
    // pixel coordinates, so step them by constants across the row instead
    // of re-evaluating 2 muls/edge per pixel.
    const float a0 = (y1 - y2) * inv, b0 = (x2 - x1) * inv;
    const float a1 = (y2 - y0) * inv, b1 = (x0 - x2) * inv;
    const float z0 = pz[i0], dz1 = pz[i1] - pz[i0], dz2 = pz[i2] - pz[i0];
    const int x_lo = static_cast<int>(minx), x_hi = static_cast<int>(maxx);
    const int y_lo = static_cast<int>(miny), y_hi = static_cast<int>(maxy);
    float w0_row = a0 * (x_lo + 0.5f - x2) + b0 * (y_lo + 0.5f - y2);
    float w1_row = a1 * (x_lo + 0.5f - x2) + b1 * (y_lo + 0.5f - y2);
    for (int yi = y_lo; yi <= y_hi; ++yi, w0_row += b0, w1_row += b1) {
      float w0 = w0_row, w1 = w1_row;
      size_t row = static_cast<size_t>(yi) * width;
      for (int xi = x_lo; xi <= x_hi; ++xi, w0 += a0, w1 += a1) {
        float w2 = 1.f - w0 - w1;
        if (w0 < 0.f || w1 < 0.f || w2 < 0.f) continue;
        float z = z0 + w1 * dz1 + w2 * dz2;
        size_t idx = row + xi;
        if (z <= zbuf[idx]) continue;
        zbuf[idx] = z;
        uint8_t* p = rgba + 4 * idx;
        p[0] = r8;
        p[1] = g8;
        p[2] = b8;
        p[3] = 255;
      }
    }
  }
  return 0;
}

// Alpha-composite an RGBA overlay onto an RGB image in place
// (render_demo.py:127-129 semantics: hard mask, not blended).
int composite_over(const uint8_t* rgba, uint8_t* img, int width, int height) {
  size_t n = static_cast<size_t>(width) * height;
  for (size_t i = 0; i < n; ++i) {
    if (rgba[4 * i + 3] > 0) {
      img[3 * i] = rgba[4 * i];
      img[3 * i + 1] = rgba[4 * i + 1];
      img[3 * i + 2] = rgba[4 * i + 2];
    }
  }
  return 0;
}

}  // extern "C"
