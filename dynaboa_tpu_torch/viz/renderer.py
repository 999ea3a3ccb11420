"""Mesh-overlay rendering (counterpart of ``dynaboa_tpu/viz/renderer.py``).

Capability parity with reference ``render_demo.py`` (Renderer:57-134,
WeakPerspectiveCamera:33-55, convert_crop_cam_to_orig_img:136-153), with the
pyrender/EGL dependency replaced by the C++ rasterizer of ``native_lib``.
``_render_numpy`` is the plain numpy version of the same rasterizer; a
``Renderer`` uses it only when asked for it by name (``backend="numpy"``).
"""

from __future__ import annotations

import numpy as np

from dynaboa_tpu_torch import native_lib

BACKENDS = ("native", "numpy")


def convert_crop_cam_to_orig_img(cam: np.ndarray, bbox: np.ndarray,
                                 img_width: int, img_height: int) -> np.ndarray:
    """Map the crop-space weak-perspective camera (s, tx, ty) into full-image
    coordinates (sx, sy, tx, ty) (reference render_demo.py:136-153).

    Args:
      cam: (N, 3), bbox: (N, 3) as (cx, cy, h).
    """
    cx, cy, h = bbox[:, 0], bbox[:, 1], bbox[:, 2]
    hw, hh = img_width / 2.0, img_height / 2.0
    sx = cam[:, 0] * (1.0 / (img_width / h))
    sy = cam[:, 0] * (1.0 / (img_height / h))
    tx = ((cx - hw) / hw / sx) + cam[:, 1]
    ty = ((cy - hh) / hh / sy) + cam[:, 2]
    return np.stack([sx, sy, tx, ty]).T


def _render_numpy(verts, faces, cam, width, height, color):
    """Plain numpy rasterizer (slow): the same projection, culling guard,
    shading and depth test as ``csrc/native/rasterizer.cpp``, two-sided."""
    v = verts * np.array([1.0, -1.0, -1.0])  # 180-degree flip about x
    sx, sy, tx, ty = cam
    px = (sx * (v[:, 0] + tx) + 1) * 0.5 * width
    py = (1 - sy * (v[:, 1] - ty)) * 0.5 * height
    pz = v[:, 2]

    rgba = np.zeros((height, width, 4), np.uint8)
    zbuf = np.full((height, width), -np.inf, np.float32)
    lights = [np.array(d) / np.linalg.norm(d)
              for d in ([0, -1, 1], [0, 1, 1], [1, 1, 2])]
    for f in faces:
        tri = np.stack([px[f], py[f]], 1)
        if not np.isfinite(tri).all():
            continue
        lo = np.maximum(np.floor(tri.min(0)).astype(int), 0)
        hi = np.minimum(np.ceil(tri.max(0)).astype(int),
                        [width - 1, height - 1])
        if (lo > hi).any():
            continue
        # pathology guard (same as the C rasterizer): a diverged model's
        # exploded triangles would each rasterize the whole frame
        if (hi[0] - lo[0]) * (hi[1] - lo[1]) > 0.25 * width * height:
            continue
        e1 = v[f[1]] - v[f[0]]
        e2 = v[f[2]] - v[f[0]]
        n = np.cross(e1, e2)
        nn = np.linalg.norm(n)
        if nn < 1e-12:
            continue
        n = n / nn
        if n[2] < 0:
            n = -n
        inten = min(1.0, 0.3 + 0.45 * sum(max(0.0, float(n @ L))
                                          for L in lights))
        col = (np.asarray(color) * inten * 255).astype(np.uint8)

        xs = np.arange(lo[0], hi[0] + 1) + 0.5
        ys = np.arange(lo[1], hi[1] + 1) + 0.5
        X, Y = np.meshgrid(xs, ys)
        x0, y0 = tri[0]
        x1, y1 = tri[1]
        x2, y2 = tri[2]
        den = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
        if abs(den) < 1e-12:
            continue
        w0 = ((y1 - y2) * (X - x2) + (x2 - x1) * (Y - y2)) / den
        w1 = ((y2 - y0) * (X - x2) + (x0 - x2) * (Y - y2)) / den
        w2 = 1 - w0 - w1
        mask = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not mask.any():
            continue
        z = w0 * pz[f[0]] + w1 * pz[f[1]] + w2 * pz[f[2]]
        sub_z = zbuf[lo[1]:hi[1] + 1, lo[0]:hi[0] + 1]
        upd = mask & (z > sub_z)
        sub_z[upd] = z[upd]
        sub = rgba[lo[1]:hi[1] + 1, lo[0]:hi[0] + 1]
        sub[upd] = np.array([*col, 255], np.uint8)
    return rgba


class Renderer:
    """Weak-perspective mesh renderer with frame compositing.

    Unlike the reference (which rebuilds the EGL renderer every webcam frame,
    dynaboa_webcam.py:77), construction is cheap and reusable.  ``backend``
    is ``"native"`` (the C++ rasterizer, built at first use; a failed build
    raises) or ``"numpy"`` (``_render_numpy``).
    """

    def __init__(self, resolution=(224, 224), faces: np.ndarray | None = None,
                 backend: str = "native"):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r}; expected one of "
                             f"{BACKENDS}")
        self.resolution = resolution
        self.faces = np.asarray(faces, np.int32) if faces is not None else None
        self.backend = backend

    def render(self, img: np.ndarray, verts: np.ndarray, cam,
               color=(1.0, 1.0, 0.9), faces: np.ndarray | None = None,
               mesh_filename: str | None = None) -> np.ndarray:
        """Overlay the mesh on img (H, W, 3 uint8); cam = (sx, sy, tx, ty)."""
        # cull only for the renderer's own closed SMPL body mesh; caller-
        # supplied faces may be open/arbitrarily wound -> two-sided
        cull = faces is None
        faces = self.faces if faces is None else np.asarray(faces, np.int32)
        h, w = img.shape[:2]
        if mesh_filename:
            save_obj(mesh_filename, verts, faces)
        if self.backend == "native":
            rgba = native_lib.render_mesh(verts, faces, np.asarray(cam),
                                          w, h, color, cull=cull)
            # in-place compositing in C, without np.where's temporaries
            return native_lib.composite_over(
                rgba, np.ascontiguousarray(img, np.uint8).copy())
        rgba = _render_numpy(np.asarray(verts, np.float32), faces,
                             np.asarray(cam, np.float32), w, h, color)
        out = np.ascontiguousarray(img, np.uint8).copy()
        mask = rgba[:, :, 3:] > 0
        return np.where(mask, rgba[:, :, :3], out)


def render_overlay(img, verts, cam3, bbox, faces, color=(0.8, 0.51, 0.38),
                   backend: str = "native"):
    """Full-image overlay from a crop-space (s, tx, ty) camera + bbox
    (the reference save_results path, base_adaptor.py:429-443)."""
    h, w = img.shape[:2]
    orig_cam = convert_crop_cam_to_orig_img(
        np.asarray(cam3, np.float32).reshape(1, 3),
        np.asarray(bbox, np.float32).reshape(1, 3), w, h)[0]
    return Renderer(resolution=(w, h), faces=faces, backend=backend).render(
        img, verts, orig_cam, color=color)


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray):
    """Minimal OBJ export (replaces trimesh mesh.export,
    render_demo.py:93-94)."""
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in faces + 1:
            f.write(f"f {t[0]} {t[1]} {t[2]}\n")


def revert_to_bbox(center, scale, height: float = 200.0,
                   scale_factor: float = 1.0):
    """(center, scale) -> (cx, cy, h) bbox (reference render_demo.py:155-160)."""
    h = scale * height / scale_factor
    return [center[0], center[1], h]


def parse_cam(cam_t: np.ndarray) -> np.ndarray:
    """Invert the weak-perspective translation back to (s, tx, ty)
    (reference render_demo.py:162-165): cam_t = [tx, ty, 2f/(res*s)]."""
    s = (2.0 * 5000.0 / cam_t[:, 2] - 1e-9) / 224.0
    return np.stack([s, cam_t[:, 0], cam_t[:, 1]], axis=1)
