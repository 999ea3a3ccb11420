"""Functional SMPL body model with the SPIN 49-joint output space, on torch
tensors (counterpart of ``dynaboa_tpu/models/smpl.py``).

``smpl_forward(model, betas, pose)`` is the eager autograd path.  The
Hopper skinning kernel (``dynaboa_tpu_torch.kernels.lbs.LBSKernelSMPL``)
plugs in through ``lbs_fn=`` for decodes outside gradient computations: it
has no backward pass.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dynaboa_tpu_torch import constants
from dynaboa_tpu_torch.ops.rotations import batch_rodrigues

# SMPL kinematic tree (public topology).
SMPL_PARENTS = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
    18, 19, 20, 21,
)


class SMPLModel(NamedTuple):
    """Static SMPL model data (one per gender), float32 tensors on one
    device.  V=6890 vertices, K=24 joints, B=10 betas, P=207 pose features."""

    v_template: torch.Tensor        # (V, 3)
    shapedirs: torch.Tensor         # (V, 3, B)
    posedirs: torch.Tensor          # (P, V*3) row-major flattened
    J_regressor: torch.Tensor       # (K, V)
    lbs_weights: torch.Tensor       # (V, K)
    parents: tuple                  # length-K python tuple
    faces: np.ndarray               # (F, 3) int32, host-side
    J_regressor_extra: torch.Tensor  # (9, V)
    vertex_joint_ids: torch.Tensor  # (21,) int64


class SMPLOutput(NamedTuple):
    vertices: torch.Tensor      # (N, V, 3)
    joints: torch.Tensor        # (N, 49, 3) SPIN ordering
    smpl_joints: torch.Tensor   # (N, 24, 3) posed kinematic joints


def _depth_groups(parents: tuple) -> list[tuple[list[int], list[int]]]:
    """Joints grouped by depth in the kinematic tree: [(ids, parent ids)]."""
    K = len(parents)
    depth = [0] * K
    for k in range(1, K):
        depth[k] = depth[parents[k]] + 1
    groups = []
    for d in range(1, max(depth) + 1):
        ids = [k for k in range(K) if depth[k] == d]
        groups.append((ids, [parents[k] for k in ids]))
    return groups


def _rigid_transform_chain(rot_mats: torch.Tensor, joints: torch.Tensor,
                           parents: tuple):
    """World transforms of each joint from local rotations.

    All joints of one depth form one batched (N, L, 4, 4) matmul, so the
    chain costs max-depth products instead of K-1.

    Args:
      rot_mats: (N, K, 3, 3)
      joints: (N, K, 3) rest-pose joint locations.
    Returns:
      posed_joints: (N, K, 3), rel_transforms: (N, K, 4, 4)
    """
    N, K = rot_mats.shape[0], rot_mats.shape[1]
    rel_joints = joints - torch.cat(
        [torch.zeros_like(joints[:, :1]), joints[:, list(parents[1:])]], dim=1)

    top = torch.cat([rot_mats, rel_joints[..., None]], dim=-1)      # (N,K,3,4)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rot_mats.dtype,
                          device=rot_mats.device).expand(N, K, 1, 4)
    local = torch.cat([top, bottom], dim=-2)                         # (N,K,4,4)

    world = [local[:, 0]] + [None] * (K - 1)
    for ids, pids in _depth_groups(parents):
        prod = torch.stack([world[p] for p in pids], dim=1) @ local[:, ids]
        for j, k in enumerate(ids):
            world[k] = prod[:, j]
    world = torch.stack(world, dim=1)                                # (N,K,4,4)

    posed_joints = world[..., :3, 3]
    # subtract the rest joint's contribution from the translation column
    joints_homo = torch.cat([joints, torch.zeros_like(joints[..., :1])], -1)
    correction = (world @ joints_homo[..., None])[..., 0]            # (N,K,4)
    rel = torch.cat([world[..., :3], (world[..., 3] - correction)[..., None]],
                    dim=-1)
    return posed_joints, rel


def shaped_vertices_and_joints(model: SMPLModel, betas: torch.Tensor):
    """Shape blendshapes and rest joints: (N, V, 3), (N, K, 3)."""
    v_shaped = model.v_template + torch.einsum("vcb,nb->nvc", model.shapedirs,
                                               betas)
    J = torch.einsum("kv,nvc->nkc", model.J_regressor, v_shaped)
    return v_shaped, J


def pose_features(pose_rotmats: torch.Tensor) -> torch.Tensor:
    """(N, 24, 3, 3) -> (N, 207): the non-root rotations minus identity."""
    N = pose_rotmats.shape[0]
    eye = torch.eye(3, dtype=pose_rotmats.dtype, device=pose_rotmats.device)
    return (pose_rotmats[:, 1:] - eye).reshape(N, -1)


def lbs(model: SMPLModel, betas: torch.Tensor, pose_rotmats: torch.Tensor):
    """Linear blend skinning.

    Args:
      betas: (N, 10)
      pose_rotmats: (N, 24, 3, 3), global orientation at index 0.
    Returns:
      vertices (N, V, 3), posed kinematic joints (N, 24, 3)
    """
    N = betas.shape[0]
    v_shaped, J = shaped_vertices_and_joints(model, betas)
    pose_offsets = (pose_features(pose_rotmats) @ model.posedirs).reshape(
        N, -1, 3)
    v_posed = v_shaped + pose_offsets
    posed_joints, rel = _rigid_transform_chain(pose_rotmats, J, model.parents)

    # per-vertex blended transforms applied to the homogeneous vertices
    T = torch.einsum("vk,nkij->nvij", model.lbs_weights, rel)
    verts = (T[..., :3, :3] @ v_posed[..., None])[..., 0] + T[..., :3, 3]
    return verts, posed_joints


def spin_joints(model: SMPLModel, verts: torch.Tensor,
                kin_joints: torch.Tensor) -> torch.Tensor:
    """SPIN 49 joints: [24 posed kinematic + 21 selected vertices + 9 extra
    regressed] gathered into the SPIN order."""
    sel_verts = verts[:, model.vertex_joint_ids]                      # (N,21,3)
    extra = torch.einsum("jv,nvc->njc", model.J_regressor_extra, verts)
    joints54 = torch.cat([kin_joints, sel_verts, extra], dim=1)
    gather = torch.as_tensor(constants.SPIN_JOINT_GATHER, dtype=torch.long,
                             device=verts.device)
    return joints54[:, gather]


def original_joints(model: SMPLModel, verts: torch.Tensor,
                    kin_joints: torch.Tensor) -> torch.Tensor:
    """The joint set before the SPIN remap: [24 posed kinematic + 21
    selected vertices], (N, 45, 3), without the 9 extra regressed joints."""
    return torch.cat([kin_joints, verts[:, model.vertex_joint_ids]], dim=1)


def smpl_forward(model: SMPLModel, betas: torch.Tensor, pose: torch.Tensor,
                 pose2rot: bool = False, lbs_fn=None) -> SMPLOutput:
    """Full SMPL forward returning SPIN's 49-joint set.

    Args:
      betas: (N, 10)
      pose: (N, 24, 3, 3) rotmats, or (N, 72) axis-angle with pose2rot.
      lbs_fn: optional replacement for ``lbs`` with the same contract, e.g.
        an ``LBSKernelSMPL``; it has no backward pass.
    """
    if pose2rot:
        rotmats = batch_rodrigues(pose.reshape(-1, 3)).reshape(-1, 24, 3, 3)
    else:
        rotmats = pose
    if lbs_fn is not None:
        verts, kin_joints = lbs_fn(betas, rotmats)
    else:
        verts, kin_joints = lbs(model, betas, rotmats)
    joints = spin_joints(model, verts, kin_joints)
    return SMPLOutput(vertices=verts, joints=joints, smpl_joints=kin_joints)


# ---------------------------------------------------------------------------
# Model data
# ---------------------------------------------------------------------------

def _model_from_numpy(device, v_template, shapedirs, posedirs, J_regressor,
                      weights, parents, faces, J_regressor_extra,
                      vertex_joint_ids) -> SMPLModel:
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return SMPLModel(
        v_template=f32(v_template), shapedirs=f32(shapedirs),
        posedirs=f32(posedirs), J_regressor=f32(J_regressor),
        lbs_weights=f32(weights), parents=tuple(int(p) for p in parents),
        faces=np.asarray(faces, np.int32),
        J_regressor_extra=f32(J_regressor_extra),
        vertex_joint_ids=torch.as_tensor(
            np.asarray(vertex_joint_ids, np.int64), device=device),
    )


def load_smpl_npz(path: str, device) -> SMPLModel:
    """Load a converted SMPL model (see tools/convert_smpl.py)."""
    data = np.load(path, allow_pickle=False)
    posedirs = data["posedirs"]
    if posedirs.ndim == 3:  # (V, 3, P) -> (P, V*3)
        posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T
    extra = data.get("J_regressor_extra")
    if extra is None:
        extra = np.zeros((constants.NUM_EXTRA_JOINTS, constants.NUM_VERTICES),
                         np.float32)
    return _model_from_numpy(
        device, data["v_template"], data["shapedirs"][..., :10], posedirs,
        data["J_regressor"], data["weights"], data["kintree_parents"],
        data["f"], extra, constants.VERTEX_JOINT_IDS)


def synthetic_smpl_model(seed: int, device,
                         num_vertices: int = constants.NUM_VERTICES
                         ) -> SMPLModel:
    """Deterministic stand-in with the true SMPL topology shapes, built by
    the same numpy code as the JAX package's ``synthetic_smpl_model`` so the
    arrays are identical for the same seed."""
    rng = np.random.default_rng(seed)
    V, K, B = num_vertices, constants.NUM_JOINTS, constants.NUM_BETAS

    joints = rng.normal(scale=0.3, size=(K, 3)).astype(np.float64)
    for k in range(1, K):
        joints[k] = joints[SMPL_PARENTS[k]] + rng.normal(scale=0.15, size=3)

    owner = rng.integers(0, K, size=V)
    v_template = joints[owner] + rng.normal(scale=0.07, size=(V, 3))

    d2 = ((v_template[:, None, :] - joints[None]) ** 2).sum(-1)
    w = np.exp(-d2 / 0.02)
    w[np.arange(V), owner] += 1.0
    weights = (w / w.sum(1, keepdims=True)).astype(np.float32)

    Jreg = np.zeros((K, V), np.float64)
    for k in range(K):
        mask = owner == k
        if mask.sum() == 0:
            mask[rng.integers(0, V)] = True
        Jreg[k, mask] = 1.0 / mask.sum()

    shapedirs = rng.normal(scale=0.01, size=(V, 3, B)).astype(np.float32)
    posedirs = rng.normal(
        scale=0.001, size=(constants.NUM_POSEDIRS, V * 3)).astype(np.float32)
    faces = rng.integers(0, V, size=(13776, 3)).astype(np.int32)

    Jreg_extra = np.zeros((constants.NUM_EXTRA_JOINTS, V), np.float32)
    cols = rng.integers(0, V, size=(constants.NUM_EXTRA_JOINTS, 4))
    for j in range(constants.NUM_EXTRA_JOINTS):
        Jreg_extra[j, cols[j]] = 0.25

    vji = constants.VERTEX_JOINT_IDS
    if num_vertices < constants.NUM_VERTICES:
        vji = np.minimum(vji, num_vertices - 1).astype(np.int32)

    return _model_from_numpy(device, v_template, shapedirs, posedirs, Jreg,
                             weights, SMPL_PARENTS, faces, Jreg_extra, vji)
