"""Camera models on torch tensors: pinhole projection, the HMR
weak-perspective camera and the batched weighted-least-squares translation
fit (counterpart of ``dynaboa_tpu/ops/camera.py``)."""

from __future__ import annotations

import torch

from dynaboa_tpu_torch import constants


def perspective_projection(
    points: torch.Tensor,
    rotation: torch.Tensor,
    translation: torch.Tensor,
    focal_length,
    camera_center: torch.Tensor,
) -> torch.Tensor:
    """Project 3D points with a pinhole camera.

    Args:
      points: (B, N, 3)
      rotation: (B, 3, 3)
      translation: (B, 3)
      focal_length: scalar or (B,)
      camera_center: (B, 2)
    Returns:
      (B, N, 2) pixel coordinates.
    """
    pts = torch.einsum("bij,bkj->bki", rotation, points) + translation[:, None, :]
    projected = pts / pts[..., 2:3]
    f = torch.as_tensor(focal_length, dtype=points.dtype,
                        device=points.device).expand(pts.shape[:1])
    return projected[..., :2] * f[:, None, None] + camera_center[:, None, :]


def weak_perspective_to_translation(cam: torch.Tensor,
                                    eps: float = 1e-9) -> torch.Tensor:
    """(s, tx, ty) -> [tx, ty, 2 * FOCAL_LENGTH / (IMG_RES * s + eps)]."""
    tz = 2.0 * constants.FOCAL_LENGTH / (constants.IMG_RES * cam[:, 0] + eps)
    return torch.stack([cam[:, 1], cam[:, 2], tz], dim=-1)


def project_to_crop(cam: torch.Tensor, s3d: torch.Tensor, eps: float = 1e-9):
    """Weak-perspective projection of 3D joints into the 224x224 crop.

    Args:
      cam: (B, 3) as (s, tx, ty).
      s3d: (B, N, 3)
    Returns:
      dict with 'ori' (B, N, 2) pixels about the crop centre and 'normed'
      (B, N, 2) in [-1, 1].
    """
    batch = s3d.shape[0]
    cam_t = weak_perspective_to_translation(cam, eps)
    eye = torch.eye(3, dtype=s3d.dtype, device=s3d.device).expand(batch, 3, 3)
    center = torch.zeros((batch, 2), dtype=s3d.dtype, device=s3d.device)
    s2d = perspective_projection(s3d, eye, cam_t, constants.FOCAL_LENGTH,
                                 center)
    return {"ori": s2d, "normed": s2d / (constants.IMG_RES / 2.0)}


def estimate_translation(S: torch.Tensor, joints_2d: torch.Tensor,
                         focal_length: float = 5000.0,
                         img_size: float = 224.0) -> torch.Tensor:
    """Weighted least-squares camera translation from 2D/3D
    correspondences, the whole batch in one solve of stacked 3x3 normal
    equations.  For each joint two rows, weighted by sqrt(conf):

      f * t_x + (c - x) * t_z = (x - c) * Z - f * X
      f * t_y + (c - y) * t_z = (y - c) * Z - f * Y

    Args:
      S: (B, N, 3) 3D joints.
      joints_2d: (B, N, 3) pixel-space 2D joints with confidence last.
    Returns:
      (B, 3) camera translations.
    """
    conf = joints_2d[..., 2]
    xy = joints_2d[..., :2]
    f = float(focal_length)
    center = img_size / 2.0

    w = torch.sqrt(torch.clamp(conf, min=0.0))[..., None]     # (B, N, 1)
    Z = S[..., 2]
    zeros = torch.zeros_like(conf)
    fs = torch.full_like(conf, f)
    rows_x = torch.stack([fs, zeros, center - xy[..., 0]], dim=-1)
    rows_y = torch.stack([zeros, fs, center - xy[..., 1]], dim=-1)
    Q = torch.cat([rows_x * w, rows_y * w], dim=1)           # (B, 2N, 3)
    cx = ((xy[..., 0] - center) * Z - f * S[..., 0])[..., None]
    cy = ((xy[..., 1] - center) * Z - f * S[..., 1])[..., None]
    c = torch.cat([cx * w, cy * w], dim=1)[..., 0]           # (B, 2N)

    A = torch.einsum("bri,brj->bij", Q, Q)                   # (B, 3, 3)
    b = torch.einsum("bri,br->bi", Q, c)                     # (B, 3)
    return torch.linalg.solve(A, b[..., None])[..., 0]


def estimate_translation_hmmr(S: torch.Tensor, joints_2d: torch.Tensor,
                              focal_length: float = 5000.0,
                              img_size: float = 256.0) -> torch.Tensor:
    """The HMMR convention: the same solve over the first 14 joints only.

    Args:
      S: (B, >=14, 3) 3D joints.
      joints_2d: (B, >=14, 3) pixel-space 2D joints with confidence last.
    Returns:
      (B, 3) camera translations.
    """
    return estimate_translation(S[:, :14], joints_2d[:, :14],
                                focal_length=focal_length, img_size=img_size)
