"""Pose and shape priors on torch tensors (counterpart of
``dynaboa_tpu/losses/priors.py``): the GMM max-mixture negative
log-likelihood (merged and full forms), the SMPLify angle prior, the L2
priors and the ``create_prior`` factory.  Precisions and mixture weights
are precomputed in float64 at load, exactly as the JAX package does, then
stored as float32 on the device."""

from __future__ import annotations

import math
import os
import pickle
from typing import NamedTuple

import numpy as np
import torch

from dynaboa_tpu_torch.ops.device_const import device_const

POSE_DIM = 69
_GMM_EPSILON = 1e-16


class GMMPrior(NamedTuple):
    means: torch.Tensor        # (M, 69)
    precisions: torch.Tensor   # (M, 69, 69)
    nll_weights: torch.Tensor  # (M,)
    weights: torch.Tensor      # (M,) raw mixture weights
    logdets: torch.Tensor      # (M,) log(det(cov) + eps)


def _build_gmm(means, covs, weights, device) -> GMMPrior:
    means = np.asarray(means, np.float64)
    covs = np.asarray(covs, np.float64)
    weights = np.asarray(weights, np.float64)
    precisions = np.stack([np.linalg.inv(c) for c in covs])
    dets = np.array([np.linalg.det(c) for c in covs])
    sqrdets = np.sqrt(dets)
    const = (2 * np.pi) ** (POSE_DIM / 2.0)
    nll_weights = weights / (const * (sqrdets / sqrdets.min()))

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return GMMPrior(means=f32(means), precisions=f32(precisions),
                    nll_weights=f32(nll_weights), weights=f32(weights),
                    logdets=f32(np.log(dets + _GMM_EPSILON)))


def load_gmm_prior(path: str, device) -> GMMPrior:
    """Load from gmm_XX.pkl (dict of means/covars/weights) or converted npz."""
    if path.endswith(".npz"):
        d = np.load(path)
        return _build_gmm(d["means"], d["covars"], d["weights"], device)
    with open(path, "rb") as f:
        g = pickle.load(f, encoding="latin1")
    if not isinstance(g, dict):  # sklearn GMM object
        g = {"means": g.means_, "covars": g.covars_, "weights": g.weights_}
    return _build_gmm(g["means"], g["covars"], g["weights"], device)


def default_gmm_path() -> str | None:
    """The GMM shipped with the port (``dynaboa_tpu_torch/assets``), then
    the conventional data dirs."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    candidates = [
        os.path.join(pkg, "assets", "gmm_08.npz"),
        os.path.join(os.path.dirname(pkg), "data", "gmm_08.pkl"),
        "data/gmm_08.pkl",
        "data/spin_data/gmm_08.pkl",
    ]
    for c in candidates:
        if os.path.exists(c):
            return c
    return None


def synthetic_gmm_prior(seed: int, device, num_gaussians: int = 8) -> GMMPrior:
    """Deterministic stand-in prior (the JAX package's numpy recipe)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(scale=0.2, size=(num_gaussians, POSE_DIM))
    A = rng.normal(scale=0.05, size=(num_gaussians, POSE_DIM, POSE_DIM))
    covs = np.einsum("mij,mkj->mik", A, A) + np.eye(POSE_DIM) * 0.5
    weights = rng.dirichlet(np.ones(num_gaussians))
    return _build_gmm(means, covs, weights, device)


def gmm_prior_nll(prior: GMMPrior, pose: torch.Tensor) -> torch.Tensor:
    """Max-mixture NLL: min over components of half the Mahalanobis term
    minus the log mixture weight.

    Args:
      pose: (B, 69) body pose as axis-angle (no global orient).
    Returns:
      (B,)
    """
    diff = pose[:, None, :] - prior.means[None]                # (B, M, 69)
    prec_diff = torch.einsum("mij,bmj->bmi", prior.precisions, diff)
    quad = torch.sum(prec_diff * diff, dim=-1)                 # (B, M)
    loglik = 0.5 * quad - torch.log(prior.nll_weights)[None]
    return torch.min(loglik, dim=1).values


def gmm_prior_nll_full(prior: GMMPrior, pose: torch.Tensor) -> torch.Tensor:
    """Full (non-'merged') max-mixture NLL: per component the quadratic
    term (deliberately not halved, as in the reference formula) plus
    0.5 * (log det cov + 69 log 2pi), minimized over components, minus the
    log nll-weight of each sample's argmin component.  The gather is per
    sample, as the JAX package's; the reference's only works at batch 1.

    Args:
      pose: (B, 69) body pose as axis-angle (no global orient).
    Returns:
      (B,)
    """
    diff = pose[:, None, :] - prior.means[None]                # (B, M, 69)
    prec_diff = torch.einsum("mij,bmj->bmi", prior.precisions, diff)
    quad = torch.sum(prec_diff * diff, dim=-1)                 # (B, M)
    loglik = quad + 0.5 * (prior.logdets
                           + POSE_DIM * math.log(2.0 * math.pi))[None]
    min_ll, min_idx = torch.min(loglik, dim=1)
    return min_ll - torch.log(prior.nll_weights)[min_idx]


def gmm_mean_pose(prior: GMMPrior) -> torch.Tensor:
    """Mean of the mixture: weights @ means, (69,)."""
    return prior.weights @ prior.means


def create_prior(prior_type: str | None, prior: GMMPrior | None = None,
                 use_merged: bool = True):
    """A callable ``f(pose, betas=None)`` for 'gmm' | 'l2' | 'angle' |
    'none' (or None).  Outputs: (B,) for 'gmm' and 'l2', (B, 4) for
    'angle', scalar 0.0 for 'none'.  'gmm' needs ``prior``;
    ``use_merged`` picks the merged or the full NLL."""
    if prior_type == "gmm":
        if prior is None:
            raise ValueError("create_prior('gmm') needs a GMMPrior")
        fn = gmm_prior_nll if use_merged else gmm_prior_nll_full
        return lambda pose, betas=None: fn(prior, pose)
    if prior_type == "l2":
        return lambda pose, betas=None: torch.sum(pose ** 2, dim=-1)
    if prior_type == "angle":
        return lambda pose, betas=None: angle_prior(pose)
    if prior_type in ("none", None):
        return lambda pose, betas=None: 0.0
    raise ValueError(f"Prior {prior_type!r} is not implemented")


def shape_prior(betas: torch.Tensor, row_w=None) -> torch.Tensor:
    """Mean over the batch of sum(betas^2); optional per-row weights."""
    per = torch.sum(betas ** 2, dim=-1)
    if row_w is None:
        return per.mean()
    return (per * row_w).sum() / row_w.sum()


# SMPLify angle prior: indices into the 72-d full pose of the l/r elbow and
# knee bend dimensions, with their bend-direction signs.
_ANGLE_IDXS = (55, 58, 12, 15)
_ANGLE_SIGNS = (1.0, -1.0, -1.0, -1.0)


def angle_prior(pose: torch.Tensor, with_global_pose: bool = False
                ) -> torch.Tensor:
    """Penalty on hyper-extended elbows and knees.

    Args:
      pose: (B, 69) body pose, or (B, 72) with ``with_global_pose``.
    Returns:
      (B, 4) per-joint penalties exp(pose * sign)^2.
    """
    off = 0 if with_global_pose else 3
    idxs = device_const(tuple(i - off for i in _ANGLE_IDXS), torch.long,
                        pose.device)
    signs = device_const(_ANGLE_SIGNS, pose.dtype, pose.device)
    return torch.exp(pose[:, idxs] * signs) ** 2


def l2_prior(x: torch.Tensor) -> torch.Tensor:
    """Plain sum of squares, a scalar."""
    return torch.sum(x ** 2)
