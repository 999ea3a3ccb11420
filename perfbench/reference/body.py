"""Plain SMPL with linear blend skinning, rotations, the weak-perspective
crop camera and the 3D metrics (MPJPE, PA-MPJPE, PVE).

SMPL (Loper et al. 2015) with SPIN's 49-joint output (Kolotouros et al.
2019): 24 posed kinematic joints, 21 selected vertices and 9 regressed
extra joints, gathered into the SPIN order.  A body is a dict of raw arrays:
``v_template (V, 3)``, ``shapedirs (V, 3, 10)``, ``posedirs (207, 3V)``,
``J_regressor (24, V)``, ``lbs_weights (V, 24)``, ``J_regressor_extra
(9, V)``, ``vertex_joint_ids (21,)`` and ``parents`` (24 ints).
"""

from __future__ import annotations

import torch

FOCAL_LENGTH = 5000.0
IMG_RES = 224
# the SPIN joint order as indices into the 54 SMPL-space joints
SPIN_GATHER = (24, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7, 25, 26,
               27, 28, 29, 30, 31, 32, 33, 34, 8, 5, 45, 46, 4, 7, 21, 19, 17,
               16, 18, 20, 47, 48, 49, 50, 51, 52, 53, 24, 26, 25, 28, 27)
H36M_TO_J14 = (6, 5, 4, 1, 2, 3, 16, 15, 14, 11, 12, 13, 8, 10)
SMPL_PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16,
                17, 18, 19, 20, 21)


# -- rotations ---------------------------------------------------------------

def quat_to_rotmat(q):
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    m = torch.stack([
        w * w + x * x - y * y - z * z, 2 * x * y - 2 * w * z,
        2 * w * y + 2 * x * z,
        2 * w * z + 2 * x * y, w * w - x * x + y * y - z * z,
        2 * y * z - 2 * w * x,
        2 * x * z - 2 * w * y, 2 * w * x + 2 * y * z,
        w * w - x * x - y * y + z * z], dim=-1)
    return m.reshape(*q.shape[:-1], 3, 3)


def rodrigues(theta):
    """Axis-angle (..., 3) -> (..., 3, 3), regularised at zero."""
    angle = torch.linalg.vector_norm(theta + 1e-8, dim=-1, keepdim=True)
    half = angle * 0.5
    return quat_to_rotmat(torch.cat([torch.cos(half),
                                     torch.sin(half) * theta / angle], -1))


def rotmat_to_aa(R, eps=1e-6):
    """Rotation matrices -> axis-angle by Shepperd's four cases (NaN -> 0)."""
    Rt = R.transpose(-1, -2)

    def r(i, j):
        return Rt[..., i, j]

    t0 = 1 + r(0, 0) - r(1, 1) - r(2, 2)
    t1 = 1 - r(0, 0) + r(1, 1) - r(2, 2)
    t2 = 1 - r(0, 0) - r(1, 1) + r(2, 2)
    t3 = 1 + r(0, 0) + r(1, 1) + r(2, 2)
    qs = (torch.stack([r(1, 2) - r(2, 1), t0, r(0, 1) + r(1, 0),
                       r(2, 0) + r(0, 2)], -1),
          torch.stack([r(2, 0) - r(0, 2), r(0, 1) + r(1, 0), t1,
                       r(1, 2) + r(2, 1)], -1),
          torch.stack([r(0, 1) - r(1, 0), r(2, 0) + r(0, 2),
                       r(1, 2) + r(2, 1), t2], -1),
          torch.stack([t3, r(1, 2) - r(2, 1), r(2, 0) - r(0, 2),
                       r(0, 1) - r(1, 0)], -1))
    d2 = r(2, 2) < eps
    d01 = r(0, 0) > r(1, 1)
    nd01 = r(0, 0) < -r(1, 1)
    case = torch.where(d2, torch.where(d01, 0, 1), torch.where(nd01, 2, 3))
    q = torch.stack(qs, 0)
    t = torch.stack([t0, t1, t2, t3], 0)
    idx = case[None]
    q = torch.gather(q, 0, idx[..., None].expand(1, *q.shape[1:]))[0]
    t = torch.gather(t, 0, idx)[0]
    q = q * 0.5 / torch.sqrt(torch.clamp(t, min=eps))[..., None]
    # quaternion -> axis-angle
    v = q[..., 1:]
    sin_sq = (v * v).sum(-1)
    sin_t = torch.sqrt(torch.where(sin_sq > 0, sin_sq, torch.ones_like(sin_sq)))
    cos_t = q[..., 0]
    two_theta = 2.0 * torch.where(cos_t < 0, torch.atan2(-sin_t, -cos_t),
                                  torch.atan2(sin_t, cos_t))
    k = torch.where(sin_sq > 0, two_theta / sin_t, torch.full_like(sin_t, 2.0))
    aa = v * k[..., None]
    return torch.where(torch.isnan(aa), torch.zeros_like(aa), aa)


# -- SMPL --------------------------------------------------------------------

def lbs(body, betas, rotmats):
    """betas (N, 10), rotmats (N, 24, 3, 3) -> vertices (N, V, 3), posed
    kinematic joints (N, 24, 3)."""
    N, K = rotmats.shape[:2]
    V = body["v_template"].shape[0]
    v_shaped = body["v_template"] + torch.einsum(
        "vcb,nb->nvc", body["shapedirs"], betas)
    J = torch.einsum("kv,nvc->nkc", body["J_regressor"], v_shaped)
    eye = torch.eye(3, dtype=rotmats.dtype, device=rotmats.device)
    pose_feat = (rotmats[:, 1:] - eye).reshape(N, -1)
    v_posed = v_shaped + (pose_feat @ body["posedirs"]).reshape(N, V, 3)

    parents = body["parents"]
    rel_j = J.clone()
    rel_j[:, 1:] = J[:, 1:] - J[:, list(parents[1:])]
    local = torch.zeros((N, K, 4, 4), dtype=J.dtype, device=J.device)
    local = torch.cat([torch.cat([rotmats, rel_j[..., None]], -1),
                       local[:, :, 3:4]], -2)
    local[:, :, 3, 3] = 1.0
    world = [local[:, 0]]
    for k in range(1, K):
        world.append(world[parents[k]] @ local[:, k])
    world = torch.stack(world, 1)
    posed_joints = world[..., :3, 3]
    shift = (world[..., :3, :3] @ J[..., None])[..., 0]
    rel = torch.cat([world[..., :3, :3],
                     (world[..., :3, 3] - shift)[..., None]], -1)   # (N,K,3,4)
    T = torch.einsum("vk,nkij->nvij", body["lbs_weights"], rel)
    verts = (T[..., :3] @ v_posed[..., None])[..., 0] + T[..., 3]
    return verts, posed_joints


def smpl(body, betas, rotmats):
    """-> (vertices (N, V, 3), SPIN joints (N, 49, 3))."""
    verts, kin = lbs(body, betas, rotmats)
    extra = torch.einsum("jv,nvc->njc", body["J_regressor_extra"], verts)
    j54 = torch.cat([kin, verts[:, body["vertex_joint_ids"]], extra], 1)
    return verts, j54[:, list(SPIN_GATHER)]


# -- camera ------------------------------------------------------------------

def project_to_crop(cam, s3d, eps=1e-9):
    """Weak-perspective projection into the 224 crop, normalised to
    [-1, 1]: a pinhole of focal 5000 at depth 2f / (224 s)."""
    tz = 2.0 * FOCAL_LENGTH / (IMG_RES * cam[:, 0] + eps)
    t = torch.stack([cam[:, 1], cam[:, 2], tz], -1)
    pts = s3d + t[:, None, :]
    return pts[..., :2] / pts[..., 2:3] * FOCAL_LENGTH / (IMG_RES / 2.0)


# -- metrics -----------------------------------------------------------------

def j14(Jreg, verts):
    j = torch.einsum("kv,nvc->nkc", Jreg, verts)
    return j[:, list(H36M_TO_J14)] - j[:, :1]


def procrustes(S1, S2):
    """Align S1 (B, N, 3) to S2 by the best similarity transform."""
    X1, X2 = S1.transpose(-1, -2), S2.transpose(-1, -2)
    mu1, mu2 = X1.mean(-1, keepdim=True), X2.mean(-1, keepdim=True)
    A, Bm = X1 - mu1, X2 - mu2
    K = A @ Bm.transpose(-1, -2)
    U, _, Vh = torch.linalg.svd(K)
    V = Vh.transpose(-1, -2)
    Z = torch.eye(3, dtype=S1.dtype, device=S1.device).repeat(K.shape[0], 1, 1)
    Z[:, 2, 2] = torch.sign(torch.linalg.det(U @ V.transpose(-1, -2)))
    R = V @ Z @ U.transpose(-1, -2)
    scale = torch.diagonal(R @ K, dim1=-2, dim2=-1).sum(-1) / (A ** 2).sum(
        (-1, -2))
    t = mu2 - scale[:, None, None] * (R @ mu1)
    return (scale[:, None, None] * (R @ X1) + t).transpose(-1, -2)


def gt_targets(bodies, Jh36m, pose_aa, betas, gender):
    """The GT 14 joints (gendered mesh) and the neutral GT mesh."""
    rot = rodrigues(pose_aa.reshape(-1, 3)).reshape(-1, 24, 3, 3)
    male, _ = smpl(bodies["male"], betas, rot)
    female, _ = smpl(bodies["female"], betas, rot)
    verts = torch.where((gender == 1)[:, None, None], female, male)
    neutral, _ = smpl(bodies["neutral"], betas, rot)
    return j14(Jh36m, verts), neutral


def evaluate(Jh36m, pred_verts, targets):
    """(mpjpe, pampjpe, pve) in mm, each (N,)."""
    gt_j, gt_v = targets
    pj = j14(Jh36m, pred_verts)
    mpjpe = torch.sqrt(((pj - gt_j) ** 2).sum(-1)).mean(-1)
    pa = torch.sqrt(((procrustes(pj, gt_j) - gt_j) ** 2).sum(-1)).mean(-1)
    pve = torch.sqrt(((gt_v - pred_verts) ** 2).sum(-1)).mean(-1)
    return mpjpe * 1000.0, pa * 1000.0, pve * 1000.0
