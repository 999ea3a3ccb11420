"""Plain adaptation losses of DynaBOA (arXiv 2111.04017, section 3): the
confidence-weighted 2D keypoint loss, the GMM pose prior of SMPLify (Bogo
et al. 2016, the max-mixture form), the shape prior, the mean-teacher loss,
the labeled loss on retrieved exemplars, the temporal motion loss and the
per-tap feature cosine similarity that gates the dynamic updates."""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference.body import rodrigues, rotmat_to_aa


def gmm_prior(means, covars, weights, device):
    """The max-mixture GMM's terms from its raw arrays: precisions and
    the log of the normalised weights, worked out in float64."""
    means = np.asarray(means, np.float64)
    covars = np.asarray(covars, np.float64)
    weights = np.asarray(weights, np.float64)
    prec = np.linalg.inv(covars)
    sqrdets = np.sqrt(np.linalg.det(covars))
    nll_w = weights / ((2 * math.pi) ** (means.shape[1] / 2.0)
                       * (sqrdets / sqrdets.min()))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return {"means": t(means), "precisions": t(prec),
            "log_w": torch.log(t(nll_w))}


def gmm_nll(prior, aa):
    """(B, 69) body axis-angle -> (B,) min over components of half the
    Mahalanobis term minus the log weight."""
    d = aa[:, None, :] - prior["means"][None]
    quad = (torch.einsum("mij,bmj->bmi", prior["precisions"], d) * d).sum(-1)
    return torch.min(0.5 * quad - prior["log_w"][None], dim=1).values


def kp2d_loss(pred, gt, joints):
    conf = gt[:, joints, 2:3]
    return (((pred[:, joints] - gt[:, joints, :2]) ** 2) * conf).mean()


def frame_loss(prior, s2d, rotmat, shape, j2d, w, joints):
    """The unsupervised per-frame mix of both levels."""
    kp = kp2d_loss(s2d, j2d, joints)
    sp = (shape ** 2).sum(-1).mean()
    aa = rotmat_to_aa(rotmat[:, 1:].reshape(-1, 3, 3)).reshape(
        rotmat.shape[0], 69)
    pp = gmm_nll(prior, aa).mean()
    total = (kp * w["s2dloss_weight"] + sp * w["shape_prior_weight"]
             + pp * w["pose_prior_weight"])
    return total, {"s2dloss": kp, "shape_prior": sp, "pose_prior": pp}


def teacher_loss(rotmat, shape, s2d, s3d, t_rotmat, t_shape, t_s2d, t_s3d):
    total = (((s2d - t_s2d) ** 2).mean() * 5 + ((t_s3d - s3d) ** 2).mean() * 5
             + ((shape - t_shape) ** 2).mean() * 0.001
             + ((rotmat - t_rotmat) ** 2).mean())
    return total


def labeled_loss(rotmat, shape, s2d, s3d, pose_aa, betas, j2d, pose_3d):
    """The supervised 5 / 5 / 0.001 / 1 mix on the retrieved exemplars,
    over the 24 GT joints; the 3D term hip-aligned."""
    gt_rot = rodrigues(pose_aa.reshape(-1, 3)).reshape(-1, 24, 3, 3)
    pose = ((rotmat - gt_rot) ** 2).mean()
    shp = ((shape - betas) ** 2).mean()
    conf = j2d[:, 25:, 2:3]
    kp = (((s2d[:, 25:] - j2d[:, 25:, :2]) ** 2) * conf).mean()
    gt = pose_3d[..., :3]
    p3 = s3d[:, 25:]
    gt = gt - ((gt[:, 2] + gt[:, 3]) / 2)[:, None]
    p3 = p3 - ((p3[:, 2] + p3[:, 3]) / 2)[:, None]
    s3 = (conf * (p3 - gt) ** 2).mean()
    return kp * 5 + s3 * 5 + shp * 0.001 + pose


def motion_loss(s2d, j2d, hist_s2d, hist_j2d):
    conf = ((hist_j2d[..., 2:3] + j2d[..., 2:3]) == 2.0).to(s2d.dtype)
    pm = s2d - hist_s2d
    gm = j2d[..., :2] - hist_j2d[..., :2]
    return (((pm - gm) ** 2) * conf).mean()


def cosine(a, b, eps=1e-12):
    a, b = a.reshape(-1), b.reshape(-1)
    den = torch.clamp(torch.linalg.vector_norm(a) * torch.linalg.vector_norm(b),
                      min=eps)
    return torch.dot(a, b) / den
