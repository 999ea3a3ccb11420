"""Camera models on torch tensors: pinhole projection and the HMR
weak-perspective camera (counterpart of ``dynaboa_tpu/ops/camera.py``)."""

from __future__ import annotations

import torch

from dynaboa_tpu import constants


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
