"""Pose and shape priors on torch tensors (counterpart of
``dynaboa_tpu/losses/priors.py``): the GMM max-mixture negative
log-likelihood ('merged' form) and the L2 shape prior.  Precisions and
mixture weights are precomputed in float64 at load, exactly as the JAX
package does, then stored as float32 on the device."""

from __future__ import annotations

import os
import pickle
from typing import NamedTuple

import numpy as np
import torch

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


def shape_prior(betas: torch.Tensor, row_w=None) -> torch.Tensor:
    """Mean over the batch of sum(betas^2); optional per-row weights."""
    per = torch.sum(betas ** 2, dim=-1)
    if row_w is None:
        return per.mean()
    return (per * row_w).sum() / row_w.sum()
