"""Plain image side of the webcam path: the keypoint bounding box and
keypoint normalisation, the crop to 224 (bilinear at twice the resolution,
box-filtered down), the crop camera taken to the full frame, and a
z-buffered, flat-shaded rasterizer with hard compositing.

The conventions are the reference webcam demo's (DynaBOA
``dynaboa_webcam.py``, ``render_demo.py``): a box 1.2 times the keypoints'
extent, confidences binarised at 0.3, SPIN's one-indexed keypoint transform,
a weak-perspective camera over the mesh turned 180 degrees about x, three
directional lights over an ambient term of 0.3, and back faces culled.
The rasterizer enumerates every fragment at once and keeps, per pixel, the
nearest one (the first face among equals)."""

from __future__ import annotations

import numpy as np
import torch

IMG_RES = 224
IMG_MEAN = (0.485, 0.456, 0.406)
IMG_STD = (0.229, 0.224, 0.225)


def bbox_from_keypoints(kp, scale_factor=1.2):
    """kp (25, 3) pixels -> (center (2,), scale in 200 px, bbox (cx, cy, h),
    keypoints with binarised confidence)."""
    lo, hi = kp[:, :2].min(0), kp[:, :2].max(0)
    center = np.array([(hi[0] + lo[0]) / 2, (hi[1] + lo[1]) / 2], np.float32)
    scale = float(scale_factor * max(hi[0] - lo[0], hi[1] - lo[1]) / 200.0)
    kp = kp.copy()
    kp[:, 2] = kp[:, 2] > 0.3
    bbox = np.array([center[0], center[1], scale * 200.0], np.float32)
    return center, scale, bbox, kp


def normalize_keypoints(kp, center, scale, res=IMG_RES):
    """Pixels -> the crop's integer pixel grid (one-indexed, truncated) ->
    [-1, 1]."""
    h = 200.0 * scale
    t = np.array([[res / h, 0.0, res * (-center[0] / h + 0.5)],
                  [0.0, res / h, res * (-center[1] / h + 0.5)]])
    pts = kp[:, :2].astype(np.float32) + 1.0 - 1.0
    xy = (np.concatenate([pts, np.ones((len(kp), 1))], 1) @ t.T).astype(int) + 1
    out = kp.astype(np.float32).copy()
    out[:, :2] = xy
    out[:, :2] = 2.0 * out[:, :2] / res - 1.0
    return out


def crop(image, center, scale, res=IMG_RES, supersample=2):
    """(H, W, 3) RGB in [0, 255] -> (res, res, 3) normalised, float32."""
    image = image.to(torch.float32)
    dev = image.device
    H, W = image.shape[:2]
    n = res * supersample
    c = torch.as_tensor(center, dtype=torch.float32, device=dev)
    h = 200.0 * torch.as_tensor(scale, dtype=torch.float32, device=dev)
    ul_x, ul_y = torch.trunc(c[0] - h / 2.0), torch.trunc(c[1] - h / 2.0)
    bw = torch.trunc(c[0] + h / 2.0) - ul_x
    bh = torch.trunc(c[1] + h / 2.0) - ul_y
    g = torch.arange(n, dtype=torch.float32, device=dev) + 0.5
    sy = torch.minimum(torch.clamp(g * bh / n - 0.5, min=0.0), bh - 1.0) + ul_y
    sx = torch.minimum(torch.clamp(g * bw / n - 0.5, min=0.0), bw - 1.0) + ul_x
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy, wx = (sy - y0)[:, None, None], (sx - x0)[None, :, None]
    y0, x0 = y0.long(), x0.long()

    def tap(yi, xi):
        ok = ((yi[:, None] >= 0) & (yi[:, None] < H) & (xi[None] >= 0)
              & (xi[None] < W))[..., None]
        v = image[yi.clamp(0, H - 1)][:, xi.clamp(0, W - 1)]
        return torch.where(ok, v, 0.0)

    top = tap(y0, x0) * (1 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1 - wx) + tap(y0 + 1, x0 + 1) * wx
    out = (top * (1 - wy) + bot * wy).reshape(
        res, supersample, res, supersample, 3).mean(dim=(1, 3)) / 255.0
    mean = torch.tensor(IMG_MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(IMG_STD, dtype=torch.float32, device=dev)
    return (out - mean) / std


def crop_cam_to_frame(cam, bbox, width, height):
    """Crop camera (s, tx, ty) -> full-frame (sx, sy, tx, ty)."""
    cx, cy, h = bbox
    sx = cam[0] * (1.0 / (width / h))
    sy = cam[0] * (1.0 / (height / h))
    tx = ((cx - width / 2.0) / (width / 2.0) / sx) + cam[1]
    ty = ((cy - height / 2.0) / (height / 2.0) / sy) + cam[2]
    return np.array([sx, sy, tx, ty], np.float32)


_LIGHTS = ((0.0, -1.0, 1.0), (0.0, 1.0, 1.0), (1.0, 1.0, 2.0))


def rasterize(verts, faces, cam, width, height, color):
    """(V, 3) float32 vertices, (F, 3) faces, (sx, sy, tx, ty) -> (H, W, 4)
    uint8 RGBA whose alpha marks coverage."""
    dev = verts.device
    v = verts.to(torch.float32) * torch.tensor([1.0, -1.0, -1.0], device=dev)
    sx, sy, tx, ty = (float(c) for c in cam)
    px = (sx * (v[:, 0] + tx) + 1.0) * 0.5 * width
    py = (1.0 - sy * (v[:, 1] - ty)) * 0.5 * height
    pz = v[:, 2]
    f = torch.as_tensor(np.asarray(faces, np.int64), device=dev)
    i0, i1, i2 = f.unbind(1)
    nrm = torch.linalg.cross(v[i1] - v[i0], v[i2] - v[i0], dim=-1)
    nn = torch.linalg.vector_norm(nrm, dim=-1, keepdim=True)
    nrm = torch.where(nn < 1e-12, torch.tensor([0.0, 0.0, 1.0], device=dev),
                      nrm / nn)
    lights = torch.tensor(_LIGHTS, device=dev)
    lights = lights / torch.linalg.vector_norm(lights, dim=-1, keepdim=True)
    lit = torch.clamp(nrm @ lights.T, min=0.0)
    inten = 0.3 + 0.45 * lit[:, 0]
    inten = inten + 0.45 * lit[:, 1]
    inten = torch.clamp(inten + 0.45 * lit[:, 2], max=1.0)
    rgb = torch.clamp(torch.tensor(color, dtype=torch.float32, device=dev)
                      * inten[:, None] * 255.0, max=255.0).to(torch.uint8)

    x = torch.stack([px[i0], px[i1], px[i2]], 1)
    y = torch.stack([py[i0], py[i1], py[i2]], 1)
    minx = torch.clamp(torch.floor(x.min(1).values), min=0.0)
    maxx = torch.clamp(torch.ceil(x.max(1).values), max=float(width - 1))
    miny = torch.clamp(torch.floor(y.min(1).values), min=0.0)
    maxy = torch.clamp(torch.ceil(y.max(1).values), max=float(height - 1))
    den = (y[:, 1] - y[:, 2]) * (x[:, 0] - x[:, 2]) + \
        (x[:, 2] - x[:, 1]) * (y[:, 0] - y[:, 2])
    keep = ((nrm[:, 2] > 0) & (minx <= maxx) & (miny <= maxy)
            & ((maxx - minx) * (maxy - miny) <= 0.25 * width * height)
            & (den.abs() >= 1e-12))
    ids = torch.nonzero(keep)[:, 0]
    bw = (maxx - minx + 1)[ids].long()
    bh = (maxy - miny + 1)[ids].long()
    size = torch.maximum(bw, bh)
    pix, zs, fs = [], [], []
    # faces grouped by box size, so each group is one dense (n, s, s) grid
    for s in torch.unique(size).tolist():
        sel = ids[size == s]
        d = torch.arange(s, device=dev)
        gx = minx[sel][:, None, None] + d[None, None, :]
        gy = miny[sel][:, None, None] + d[None, :, None]
        inbox = (gx <= maxx[sel][:, None, None]) & (gy <= maxy[sel][:, None, None])
        xs, ys = x[sel][:, :, None, None], y[sel][:, :, None, None]
        dn = den[sel][:, None, None]
        w0 = ((ys[:, 1] - ys[:, 2]) * (gx + 0.5 - xs[:, 2])
              + (xs[:, 2] - xs[:, 1]) * (gy + 0.5 - ys[:, 2])) / dn
        w1 = ((ys[:, 2] - ys[:, 0]) * (gx + 0.5 - xs[:, 2])
              + (xs[:, 0] - xs[:, 2]) * (gy + 0.5 - ys[:, 2])) / dn
        w2 = 1.0 - w0 - w1
        zf = pz[i0[sel]][:, None, None]
        z = zf + w1 * (pz[i1[sel]] - pz[i0[sel]])[:, None, None] + \
            w2 * (pz[i2[sel]] - pz[i0[sel]])[:, None, None]
        m = inbox & (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & torch.isfinite(z)
        k = torch.nonzero(m, as_tuple=True)
        pix.append(gy.expand_as(m)[k].long() * width
                   + gx.expand_as(m)[k].long())
        zs.append(z[k])
        fs.append(sel[k[0]])
    out = torch.zeros((height * width, 4), dtype=torch.uint8, device=dev)
    if pix:
        pix, zs, fs = torch.cat(pix), torch.cat(zs), torch.cat(fs)
        zmax = torch.full((height * width,), -torch.inf, device=dev)
        zmax = zmax.scatter_reduce(0, pix, zs, "amax")
        top = zs == zmax[pix]
        first = torch.full((height * width,), f.shape[0], device=dev)
        first = first.scatter_reduce(0, pix[top], fs[top], "amin")
        hit = first < f.shape[0]
        out[hit, :3] = rgb[first[hit]]
        out[hit, 3] = 255
    return out.reshape(height, width, 4)


def overlay(frame_bgr, verts, faces, cam, width, height, color):
    """The frame with the mesh composited over it, (H, W, 3) uint8."""
    rgba = rasterize(verts, faces, cam, width, height, color).cpu().numpy()
    img = np.array(frame_bgr, np.uint8, copy=True)
    mask = rgba[..., 3] > 0
    img[mask] = rgba[mask][:, :3]
    return img
