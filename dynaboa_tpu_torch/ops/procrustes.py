"""Batched Procrustes alignment on torch tensors (counterpart of
``dynaboa_tpu/ops/procrustes.py``): one batched SVD over (B, 3, 3)
cross-covariances, so PA-MPJPE stays on the device."""

from __future__ import annotations

import torch


def similarity_transform(S1: torch.Tensor, S2: torch.Tensor) -> torch.Tensor:
    """Align S1 to S2 with the optimal (scale, rotation, translation).

    Args:
      S1, S2: (B, N, 3)
    Returns:
      (B, N, 3): S1 mapped through the optimal similarity transform.
    """
    X1 = S1.transpose(-1, -2)
    X2 = S2.transpose(-1, -2)
    mu1 = X1.mean(dim=-1, keepdim=True)
    mu2 = X2.mean(dim=-1, keepdim=True)
    X1c = X1 - mu1
    X2c = X2 - mu2

    var1 = torch.sum(X1c ** 2, dim=(-1, -2))
    K = X1c @ X2c.transpose(-1, -2)                        # (B, 3, 3)
    # a non-finite sample (a diverged prediction) gives NaN, as in the JAX
    # package, instead of an SVD error
    finite = torch.isfinite(K).all(dim=(-1, -2))
    U, _, Vh = torch.linalg.svd(torch.where(finite[:, None, None], K, 0.0))
    V = Vh.transpose(-1, -2)

    # det correction to ensure a proper rotation
    det = torch.linalg.det(U @ V.transpose(-1, -2))
    Z = torch.eye(3, dtype=S1.dtype, device=S1.device).repeat(K.shape[0], 1, 1)
    Z[:, 2, 2] = torch.sign(det)
    R = V @ Z @ U.transpose(-1, -2)

    trace_RK = torch.diagonal(R @ K, dim1=-2, dim2=-1).sum(-1)
    scale = trace_RK / var1
    t = mu2 - scale[:, None, None] * (R @ mu1)
    S1_hat = scale[:, None, None] * (R @ X1) + t
    S1_hat = torch.where(finite[:, None, None], S1_hat, torch.nan)
    return S1_hat.transpose(-1, -2)


def reconstruction_error(S1: torch.Tensor, S2: torch.Tensor) -> torch.Tensor:
    """(B,) mean joint error after Procrustes alignment."""
    S1_hat = similarity_transform(S1, S2)
    return torch.sqrt(torch.sum((S1_hat - S2) ** 2, dim=-1)).mean(dim=-1)
