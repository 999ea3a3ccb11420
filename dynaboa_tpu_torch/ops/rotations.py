"""Rotation representation conversions on torch tensors, batched and
differentiable.

Counterpart of ``dynaboa_tpu/ops/rotations.py``: the same formulas, the same
normalization epsilon and the same branch structure in ``rotmat_to_quat``, so
the chosen branch (and therefore the rounding) matches per element.
"""

from __future__ import annotations

import torch

_NORM_EPS = 1e-12


def _safe_normalize(v: torch.Tensor, eps: float = _NORM_EPS) -> torch.Tensor:
    """v / max(||v||, eps) along the last axis."""
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(norm, min=eps)


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """6D rotation representation -> rotation matrices via Gram-Schmidt.

    The 6-vector reshapes to (3, 2) row-major: column 0 is elements
    [0, 2, 4] and column 1 is [1, 3, 5].

    Args:
      x: (..., 6) or (..., 24*6) — any trailing size divisible by 6.
    Returns:
      (N, 3, 3) whose columns are b1, b2, b3.
    """
    x = x.reshape(-1, 3, 2)
    a1, a2 = x[..., 0], x[..., 1]
    b1 = _safe_normalize(a1)
    b2 = _safe_normalize(a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """Unit-normalize (w, x, y, z) quaternions and convert to matrices.

    Args:
      quat: (..., 4)
    Returns:
      (..., 3, 3)
    """
    q = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
            2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
            2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
        ],
        dim=-1,
    )
    return m.reshape(*q.shape[:-1], 3, 3)


def batch_rodrigues(theta: torch.Tensor) -> torch.Tensor:
    """Axis-angle -> rotation matrix through the quaternion exponential, with
    the ``||theta + 1e-8||`` regularized norm that makes theta=0 defined.

    Args:
      theta: (..., 3)
    Returns:
      (..., 3, 3)
    """
    angle = torch.linalg.vector_norm(theta + 1e-8, dim=-1, keepdim=True)
    normalized = theta / angle
    half = angle * 0.5
    quat = torch.cat([torch.cos(half), torch.sin(half) * normalized], dim=-1)
    return quat_to_rotmat(quat)


def rotmat_to_quat(R: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Rotation matrices -> (w, x, y, z) quaternions, branchless four-case
    Shepperd extraction with ``torch.where`` selection.

    Args:
      R: (..., 3, 3)
    Returns:
      (..., 4)
    """
    Rt = R.transpose(-1, -2)

    def r(i, j):
        return Rt[..., i, j]

    t0 = 1 + r(0, 0) - r(1, 1) - r(2, 2)
    q0 = torch.stack([r(1, 2) - r(2, 1), t0, r(0, 1) + r(1, 0),
                      r(2, 0) + r(0, 2)], dim=-1)
    t1 = 1 - r(0, 0) + r(1, 1) - r(2, 2)
    q1 = torch.stack([r(2, 0) - r(0, 2), r(0, 1) + r(1, 0), t1,
                      r(1, 2) + r(2, 1)], dim=-1)
    t2 = 1 - r(0, 0) - r(1, 1) + r(2, 2)
    q2 = torch.stack([r(0, 1) - r(1, 0), r(2, 0) + r(0, 2),
                      r(1, 2) + r(2, 1), t2], dim=-1)
    t3 = 1 + r(0, 0) + r(1, 1) + r(2, 2)
    q3 = torch.stack([t3, r(1, 2) - r(2, 1), r(2, 0) - r(0, 2),
                      r(0, 1) - r(1, 0)], dim=-1)

    mask_d2 = r(2, 2) < eps
    mask_d0_d1 = r(0, 0) > r(1, 1)
    mask_d0_nd1 = r(0, 0) < -r(1, 1)

    c0 = mask_d2 & mask_d0_d1
    c1 = mask_d2 & ~mask_d0_d1
    c2 = ~mask_d2 & mask_d0_nd1
    # c3 = ~mask_d2 & ~mask_d0_nd1 (fallthrough)

    def pick(a, b, c, d):
        out = torch.where(c0[..., None], a, d)
        out = torch.where(c1[..., None], b, out)
        return torch.where(c2[..., None], c, out)

    q = pick(q0, q1, q2, q3)
    t = pick(t0[..., None], t1[..., None], t2[..., None], t3[..., None])
    return q * 0.5 / torch.sqrt(torch.clamp(t, min=eps))


def quat_to_aa(quaternion: torch.Tensor) -> torch.Tensor:
    """Quaternions (w, x, y, z) -> axis-angle, safe at theta -> 0.

    Args:
      quaternion: (..., 4)
    Returns:
      (..., 3)
    """
    q1, q2, q3 = quaternion[..., 1], quaternion[..., 2], quaternion[..., 3]
    sin_sq = q1 * q1 + q2 * q2 + q3 * q3
    # guard the sqrt so its gradient is finite at sin_sq == 0; the guarded
    # lane is overwritten by the small-angle branch below
    safe_sin_sq = torch.where(sin_sq > 0.0, sin_sq, torch.ones_like(sin_sq))
    sin_theta = torch.sqrt(safe_sin_sq)
    cos_theta = quaternion[..., 0]
    two_theta = 2.0 * torch.where(
        cos_theta < 0.0,
        torch.atan2(-sin_theta, -cos_theta),
        torch.atan2(sin_theta, cos_theta),
    )
    k = torch.where(sin_sq > 0.0, two_theta / sin_theta,
                    2.0 * torch.ones_like(sin_theta))
    return torch.stack([q1 * k, q2 * k, q3 * k], dim=-1)


def rotmat_to_aa(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices -> axis-angle (NaNs mapped to 0).

    Args:
      R: (..., 3, 3)
    Returns:
      (..., 3)
    """
    aa = quat_to_aa(rotmat_to_quat(R))
    return torch.where(torch.isnan(aa), torch.zeros_like(aa), aa)
