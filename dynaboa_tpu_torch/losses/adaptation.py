"""Adaptation losses on torch tensors (counterpart of
``dynaboa_tpu/losses/adaptation.py``): conf-weighted 2D reprojection,
mean-teacher distillation, the labeled mixed-training loss, the temporal
motion loss, the hip-aligned 3D loss and the per-tap feature cosine
similarity.  Each loss returns its scalar plus a dict of sub-terms under the
reference's logging names."""

from __future__ import annotations

import torch

from dynaboa_tpu_torch.losses.priors import GMMPrior, gmm_prior_nll, shape_prior
from dynaboa_tpu_torch.ops.rotations import batch_rodrigues, rotmat_to_aa


def row_weighted_mean(x: torch.Tensor, w: torch.Tensor | None) -> torch.Tensor:
    """Mean over all elements with optional per-row (batch) weights;
    zero-weight rows contribute neither numerator nor denominator."""
    if w is None:
        return x.mean()
    wb = w.reshape(w.shape[0], *([1] * (x.dim() - 1)))
    per_row = float(x.numel() // x.shape[0])
    return (x * wb).sum() / (w.sum() * per_row)


def keypoint_2d_loss(pred_s2d_normed, gt_j2d, row_w=None):
    """Confidence-weighted MSE on the 24 GT joints (indices 25:)."""
    conf = gt_j2d[:, 25:, 2:3]
    err = (pred_s2d_normed[:, 25:] - gt_j2d[:, 25:, :2]) ** 2
    return row_weighted_mean(err * conf, row_w)


def keypoint_2d_loss_openpose(pred_s2d_normed, kp2d, row_w=None):
    """Webcam-path variant over the 25 OpenPose joints (indices :25)."""
    conf = kp2d[:, :25, 2:3]
    err = (pred_s2d_normed[:, :25] - kp2d[:, :25, :2]) ** 2
    return row_weighted_mean(err * conf, row_w)


def pose_prior_loss(prior: GMMPrior, pred_rotmat, betas, row_w=None):
    """GMM NLL of the 23 body rotations as axis-angle (betas unused)."""
    body = pred_rotmat[:, 1:].reshape(-1, 3, 3)
    aa = rotmat_to_aa(body).reshape(pred_rotmat.shape[0], 69)
    del betas
    return row_weighted_mean(gmm_prior_nll(prior, aa), row_w)


def frame_loss(prior, pred_s2d_normed, pred_rotmat, pred_shape, gt_j2d,
               s2d_weight, shape_prior_weight, pose_prior_weight,
               row_w=None, kp_loss_fn=None):
    """The per-frame unsupervised loss mix used at both levels."""
    s2d = (kp_loss_fn or keypoint_2d_loss)(pred_s2d_normed, gt_j2d, row_w)
    sp = shape_prior(pred_shape, row_w)
    pp = pose_prior_loss(prior, pred_rotmat, pred_shape, row_w)
    total = s2d * s2d_weight + sp * shape_prior_weight + pp * pose_prior_weight
    return total, {"s2dloss": s2d, "shape_prior": sp, "pose_prior": pp}


def teacher_loss(pred_rotmat, pred_shape, pred_s2d, pred_s3d,
                 ema_rotmat, ema_shape, ema_s2d, ema_s3d, row_w=None):
    """Distillation against the mean teacher: fixed 5/5/0.001/1 mix."""
    s2d = row_weighted_mean((pred_s2d - ema_s2d) ** 2, row_w)
    s3d = row_weighted_mean((ema_s3d - pred_s3d) ** 2, row_w)
    shape = row_weighted_mean((pred_shape - ema_shape) ** 2, row_w)
    pose = row_weighted_mean((pred_rotmat - ema_rotmat) ** 2, row_w)
    total = s2d * 5 + s3d * 5 + shape * 0.001 + pose * 1
    return total, {"s2dloss": s2d, "s3dloss": s3d, "shape_loss": shape,
                   "pose_loss": pose, "loss": total}


def aligned_s3d_loss(pred_s3d, gt_s3d, conf):
    """Hip-midpoint-aligned (joints 2, 3) conf-weighted MSE."""
    gt_hip = (gt_s3d[:, 2] + gt_s3d[:, 3]) / 2
    pred_hip = (pred_s3d[:, 2] + pred_s3d[:, 3]) / 2
    gt = gt_s3d - gt_hip[:, None]
    pred = pred_s3d - pred_hip[:, None]
    return (conf * (pred - gt) ** 2).mean()


def labeled_loss(pred_rotmat, pred_shape, pred_s2d_normed, pred_s3d,
                 gt_pose_aa, gt_shape, gt_j2d, gt_s3d):
    """Fully-supervised loss on retrieved exemplars: 5/5/0.001/1 mix.

    Args:
      gt_pose_aa: (B, 72) axis-angle pose.
      gt_j2d: (B, 49, 3) normalized keypoints with conf.
      gt_s3d: (B, 24, 4) 3D joints with visibility last.
    """
    gt_rotmat = batch_rodrigues(gt_pose_aa.reshape(-1, 3)).reshape(-1, 24, 3, 3)
    pose = ((pred_rotmat - gt_rotmat) ** 2).mean()
    shape = ((pred_shape - gt_shape) ** 2).mean()
    conf = gt_j2d[:, 25:, 2:3]
    s2d = (((pred_s2d_normed[:, 25:] - gt_j2d[:, 25:, :2]) ** 2) * conf).mean()
    s3d = aligned_s3d_loss(pred_s3d[:, 25:], gt_s3d[..., :3], conf)
    total = s2d * 5 + s3d * 5 + shape * 0.001 + pose * 1
    return total, {"labled_s2dloss": s2d, "labled_s3dloss": s3d,
                   "labled_shape_loss": shape, "labled_pose_loss": pose,
                   "labled_loss": total}


def motion_loss(pred_s2d, gt_s2d, hist_pred_s2d, hist_s2d, row_w=None):
    """Predicted vs GT 2D displacement over the history interval, on joints
    confident in both frames."""
    pred_motion = pred_s2d - hist_pred_s2d
    gt_motion = gt_s2d[..., :2] - hist_s2d[..., :2]
    conf = ((hist_s2d[..., 2:3] + gt_s2d[..., 2:3]) == 2.0).to(pred_s2d.dtype)
    return row_weighted_mean(((pred_motion - gt_motion) ** 2) * conf, row_w)


def feature_cosine_similarities(features_i, features_j, eps: float = 1e-12):
    """(len,) cosine similarity per tap pair; entry 12 is the dynamic-BOA
    convergence signal."""
    sims = []
    for fi, fj in zip(features_i, features_j):
        a = fi.reshape(-1)
        b = fj.reshape(-1)
        denom = torch.clamp(torch.linalg.vector_norm(a)
                            * torch.linalg.vector_norm(b), min=eps)
        sims.append(torch.dot(a, b) / denom)
    return torch.stack(sims)
