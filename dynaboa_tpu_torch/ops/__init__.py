"""Numerics and geometry on torch tensors (counterpart of
``dynaboa_tpu.ops``)."""

from dynaboa_tpu_torch.ops import image, keypoints
from dynaboa_tpu_torch.ops.camera import (
    estimate_translation,
    estimate_translation_hmmr,
    perspective_projection,
    project_to_crop,
    weak_perspective_to_translation,
)
from dynaboa_tpu_torch.ops.procrustes import (
    compute_error_accel,
    compute_pck,
    reconstruction_error,
    similarity_transform,
)
from dynaboa_tpu_torch.ops.rotations import (
    batch_rodrigues,
    quat_to_aa,
    quat_to_rotmat,
    rot6d_to_rotmat,
    rotmat_to_aa,
    rotmat_to_quat,
)

__all__ = [
    "rot6d_to_rotmat", "quat_to_rotmat", "batch_rodrigues", "rotmat_to_quat",
    "quat_to_aa", "rotmat_to_aa", "perspective_projection",
    "weak_perspective_to_translation", "project_to_crop",
    "estimate_translation", "estimate_translation_hmmr",
    "similarity_transform", "reconstruction_error",
    "compute_error_accel", "compute_pck", "image", "keypoints",
]
