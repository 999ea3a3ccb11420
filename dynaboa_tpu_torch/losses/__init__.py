"""Losses and priors (counterpart of ``dynaboa_tpu.losses``)."""

from dynaboa_tpu_torch.losses.adaptation import (
    aligned_s3d_loss,
    feature_cosine_similarities,
    frame_loss,
    keypoint_2d_loss,
    keypoint_2d_loss_openpose,
    labeled_loss,
    motion_loss,
    pose_prior_loss,
    teacher_loss,
)
from dynaboa_tpu_torch.losses.priors import (
    GMMPrior,
    angle_prior,
    create_prior,
    default_gmm_path,
    gmm_mean_pose,
    gmm_prior_nll,
    gmm_prior_nll_full,
    l2_prior,
    load_gmm_prior,
    shape_prior,
    synthetic_gmm_prior,
)

__all__ = [
    "GMMPrior", "load_gmm_prior", "default_gmm_path", "synthetic_gmm_prior",
    "gmm_prior_nll", "gmm_prior_nll_full", "gmm_mean_pose", "create_prior",
    "shape_prior", "angle_prior", "l2_prior",
    "keypoint_2d_loss", "keypoint_2d_loss_openpose", "pose_prior_loss",
    "frame_loss", "teacher_loss", "aligned_s3d_loss", "labeled_loss",
    "motion_loss", "feature_cosine_similarities",
]
