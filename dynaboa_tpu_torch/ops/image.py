"""Bounding-box crop geometry and the fused on-device preprocessing (the
counterpart of ``dynaboa_tpu/ops/image.py``, which cannot be imported
without jax).

Two forms of the reference crop (affine box with "scale" in units of 200 px,
one-indexed point transform with truncation, zero padding outside the
image, bilinear resize with a gaussian anti-aliasing prefilter):

* the host path in numpy (``crop_numpy`` and the geometry below it), the
  same code as the JAX package's, for streams that preprocess on the host;
* ``fused_crop_resize_normalize``: crop, resize and ImageNet normalization
  of a raw frame as torch indexing on the engine's device.  It is the same
  gather graph as the JAX function (plain indexing, no hand-written kernel:
  the JAX side is an XLA gather, not a Pallas kernel).
"""

from __future__ import annotations

import numpy as np
import torch

from dynaboa_tpu_torch import constants


# -- affine transform bookkeeping (host) -------------------------------------

def get_transform(center, scale, res, rot: float = 0.0) -> np.ndarray:
    """3x3 matrix mapping original-image points into the res x res crop."""
    h = 200.0 * scale
    t = np.zeros((3, 3))
    t[0, 0] = res[1] / h
    t[1, 1] = res[0] / h
    t[0, 2] = res[1] * (-center[0] / h + 0.5)
    t[1, 2] = res[0] * (-center[1] / h + 0.5)
    t[2, 2] = 1.0
    if rot != 0:
        rot = -rot
        rot_mat = np.zeros((3, 3))
        rot_rad = rot * np.pi / 180
        sn, cs = np.sin(rot_rad), np.cos(rot_rad)
        rot_mat[0, :2] = [cs, -sn]
        rot_mat[1, :2] = [sn, cs]
        rot_mat[2, 2] = 1
        t_mat = np.eye(3)
        t_mat[0, 2] = -res[1] / 2
        t_mat[1, 2] = -res[0] / 2
        t_inv = t_mat.copy()
        t_inv[:2, 2] *= -1
        t = t_inv @ rot_mat @ t_mat @ t
    return t


def transform_point(pt, center, scale, res, invert: int = 0, rot: float = 0.0):
    """One-indexed point transform with integer truncation (the +/-1 and
    ``astype(int) + 1`` conventions leak into keypoint normalization)."""
    t = get_transform(center, scale, res, rot=rot)
    if invert:
        t = np.linalg.inv(t)
    new_pt = np.array([pt[0] - 1, pt[1] - 1, 1.0])
    new_pt = t @ new_pt
    return new_pt[:2].astype(int) + 1


def transform_points_batch(pts: np.ndarray, center, scale, res) -> np.ndarray:
    """``transform_point`` over (N, 2) points as one matmul (rot = 0)."""
    t = get_transform(center, scale, res)
    homo = np.concatenate([pts - 1.0, np.ones((pts.shape[0], 1))], axis=1)
    out = homo @ t.T
    return out[:, :2].astype(int) + 1


def crop_bounds(center, scale, res):
    """Upper-left / bottom-right source-image corners of the crop box."""
    ul = np.array(transform_point([1, 1], center, scale, res, invert=1)) - 1
    br = np.array(
        transform_point([res[0] + 1, res[1] + 1], center, scale, res,
                        invert=1)) - 1
    return ul, br


# -- host crop ---------------------------------------------------------------

def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _gaussian_blur(img: np.ndarray, sigmas) -> np.ndarray:
    """Separable gaussian blur with reflect padding (skimage-compatible)."""
    out = img.astype(np.float64)
    for axis, sigma in enumerate(sigmas):
        if sigma <= 0:
            continue
        radius = int(4.0 * sigma + 0.5)
        k = _gaussian_kernel1d(sigma, radius)
        out = np.apply_along_axis(
            lambda m: np.convolve(np.pad(m, radius, mode="reflect"), k,
                                  "valid"),
            axis, out)
    return out


def resize_bilinear_np(img: np.ndarray, out_shape,
                       anti_aliasing: bool = True) -> np.ndarray:
    """Bilinear resize with skimage semantics (half-pixel centres, edge
    clamp, gaussian prefilter when downsampling)."""
    in_h, in_w = img.shape[:2]
    out_h, out_w = out_shape
    src = img.astype(np.float64)
    if anti_aliasing:
        fy, fx = in_h / out_h, in_w / out_w
        sig = (max(0.0, (fy - 1) / 2), max(0.0, (fx - 1) / 2))
        if sig[0] > 0 or sig[1] > 0:
            src = _gaussian_blur(src, list(sig) + [0.0] * (img.ndim - 2))

    ys = (np.arange(out_h) + 0.5) * in_h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * in_w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, in_h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, in_w - 1)
    y1 = np.clip(y0 + 1, 0, in_h - 1)
    x1 = np.clip(x0 + 1, 0, in_w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    if img.ndim == 3:
        wy = wy[..., None]
        wx = wx[..., None]
    top = src[y0][:, x0] * (1 - wx) + src[y0][:, x1] * wx
    bot = src[y1][:, x0] * (1 - wx) + src[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def crop_numpy(img: np.ndarray, center, scale, res,
               anti_aliasing: bool = True) -> np.ndarray:
    """Zero-padded box crop + bilinear resize (rot = 0)."""
    ul, br = crop_bounds(center, scale, res)
    new_shape = [br[1] - ul[1], br[0] - ul[0]]
    if img.ndim > 2:
        new_shape += [img.shape[2]]
    new_img = np.zeros(new_shape, dtype=np.float64)

    new_x = max(0, -ul[0]), min(br[0], img.shape[1]) - ul[0]
    new_y = max(0, -ul[1]), min(br[1], img.shape[0]) - ul[1]
    old_x = max(0, ul[0]), min(img.shape[1], br[0])
    old_y = max(0, ul[1]), min(img.shape[0], br[1])
    new_img[new_y[0]:new_y[1], new_x[0]:new_x[1]] = img[
        old_y[0]:old_y[1], old_x[0]:old_x[1]]
    return resize_bilinear_np(new_img, res, anti_aliasing=anti_aliasing)


def normalize_j2d(kp: np.ndarray, center, scale) -> np.ndarray:
    """Keypoints -> crop frame -> [-1, 1]."""
    kp = kp.copy()
    res = [constants.IMG_RES, constants.IMG_RES]
    kp[:, :2] = transform_points_batch(kp[:, :2] + 1, center, scale, res)
    kp[:, :-1] = 2.0 * kp[:, :-1] / constants.IMG_RES - 1.0
    return kp.astype(np.float32)


# -- device path ---------------------------------------------------------------

def fused_crop_resize_normalize(image: torch.Tensor, center: torch.Tensor,
                                scale: torch.Tensor,
                                out_res: int = constants.IMG_RES,
                                supersample: int = 2) -> torch.Tensor:
    """Crop by (center, scale), resize to ``out_res`` and ImageNet-normalize,
    on the device of ``image``.

    The crop box is ``trunc(center -/+ 100 * scale)``.  Output pixels map to
    box coordinates with skimage's half-pixel convention, clamped at the box
    edge; a bilinear gather reads the source, with zero for taps outside it
    (the host crop's zero padding).  The gather runs at ``supersample`` times
    the output resolution and is box-filtered down, which stands in for the
    host path's gaussian prefilter.

    Args:
      image: (H, W, 3) RGB in [0, 255], uint8 or float.
      center: (2,) crop centre in source pixels.
      scale: () person scale in 200 px units.
    Returns:
      (out_res, out_res, 3) float32, ImageNet-normalized.
    """
    image = image.to(torch.float32)
    dev = image.device
    center = torch.as_tensor(center, dtype=torch.float32, device=dev)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=dev)
    h_img, w_img = image.shape[0], image.shape[1]
    res = out_res * supersample

    h = 200.0 * scale
    ul_x = torch.trunc(center[0] - h / 2.0)
    ul_y = torch.trunc(center[1] - h / 2.0)
    box_w = torch.trunc(center[0] + h / 2.0) - ul_x
    box_h = torch.trunc(center[1] + h / 2.0) - ul_y

    grid = torch.arange(res, dtype=torch.float32, device=dev) + 0.5
    ys = grid * box_h / res - 0.5
    xs = grid * box_w / res - 0.5
    src_y = torch.minimum(torch.clamp(ys, min=0.0), box_h - 1.0) + ul_y
    src_x = torch.minimum(torch.clamp(xs, min=0.0), box_w - 1.0) + ul_x

    y0 = torch.floor(src_y)
    x0 = torch.floor(src_x)
    wy = (src_y - y0)[:, None, None]
    wx = (src_x - x0)[None, :, None]
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)

    def sample(yi, xi):
        valid = ((yi[:, None] >= 0) & (yi[:, None] < h_img)
                 & (xi[None, :] >= 0) & (xi[None, :] < w_img))[..., None]
        vals = image[yi.clamp(0, h_img - 1)][:, xi.clamp(0, w_img - 1)]
        return torch.where(valid, vals, 0.0)

    top = sample(y0i, x0i) * (1 - wx) + sample(y0i, x0i + 1) * wx
    bot = sample(y0i + 1, x0i) * (1 - wx) + sample(y0i + 1, x0i + 1) * wx
    out = top * (1 - wy) + bot * wy
    if supersample > 1:
        out = out.reshape(out_res, supersample, out_res, supersample,
                          3).mean(dim=(1, 3))
    out = out / 255.0
    mean = torch.as_tensor(constants.IMG_NORM_MEAN, dtype=torch.float32,
                           device=dev)
    std = torch.as_tensor(constants.IMG_NORM_STD, dtype=torch.float32,
                          device=dev)
    return (out - mean) / std


def uncrop_bounds(center, scale, crop_res, orig_shape):
    """Source-image placement of a crop (for overlay rendering)."""
    ul, br = crop_bounds(center, scale, crop_res)
    return ul, br, orig_shape


# -- augmentation helpers (host) ---------------------------------------------

def rot_aa(aa: np.ndarray, rot: float) -> np.ndarray:
    """Rotate an axis-angle global orientation by an in-plane image rotation
    of ``rot`` degrees, through the port's rotation ops on the CPU."""
    from dynaboa_tpu_torch.ops.rotations import batch_rodrigues, rotmat_to_aa

    R = np.array([
        [np.cos(np.deg2rad(-rot)), -np.sin(np.deg2rad(-rot)), 0],
        [np.sin(np.deg2rad(-rot)), np.cos(np.deg2rad(-rot)), 0],
        [0, 0, 1],
    ])
    per = batch_rodrigues(torch.as_tensor(aa, dtype=torch.float32)[None])
    res = rotmat_to_aa(torch.as_tensor((R @ per[0].numpy())[None],
                                       dtype=torch.float32))
    return res[0].numpy().astype(aa.dtype)


def flip_img(img: np.ndarray) -> np.ndarray:
    """Horizontal image flip."""
    return np.fliplr(img)


def flip_kp(kp: np.ndarray) -> np.ndarray:
    """Flip keypoints with the left/right permutation of the 24- or
    49-joint layout."""
    if len(kp) == 24:
        perm = constants.J24_FLIP_PERM
    elif len(kp) == 49:
        perm = constants.J49_FLIP_PERM
    else:
        raise ValueError(f"no flip permutation for {len(kp)} joints")
    kp = kp[perm].copy()
    kp[:, 0] = -kp[:, 0]
    return kp


def flip_pose(pose: np.ndarray) -> np.ndarray:
    """Flip SMPL axis-angle parameters."""
    pose = pose[constants.SMPL_POSE_FLIP_PERM].copy()
    pose[1::3] = -pose[1::3]
    pose[2::3] = -pose[2::3]
    return pose


def uncrop(img: np.ndarray, center, scale, orig_shape) -> np.ndarray:
    """Place a crop back into original-image coordinates."""
    res = img.shape[:2]
    ul, br = crop_bounds(center, scale, res)
    crop_shape = [br[1] - ul[1], br[0] - ul[0]]
    new_img = np.zeros(orig_shape, dtype=np.uint8)
    new_x = max(0, -ul[0]), min(br[0], orig_shape[1]) - ul[0]
    new_y = max(0, -ul[1]), min(br[1], orig_shape[0]) - ul[1]
    old_x = max(0, ul[0]), min(orig_shape[1], br[0])
    old_y = max(0, ul[1]), min(orig_shape[0], br[1])
    resized = resize_bilinear_np(img, crop_shape, anti_aliasing=False)
    new_img[old_y[0]:old_y[1], old_x[0]:old_x[1]] = resized[
        new_y[0]:new_y[1], new_x[0]:new_x[1]]
    return new_img
