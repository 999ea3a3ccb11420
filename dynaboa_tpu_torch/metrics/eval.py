"""3D evaluation metrics on the device: MPJPE, PA-MPJPE, PVE (counterpart
of ``dynaboa_tpu/metrics/eval.py``).

- MPJPE: mean L2 over 14 joints (H36M regressor on vertices, H36M_TO_J14,
  pelvis-centred), in mm.
- PA-MPJPE: the same after per-sample Procrustes alignment.
- PVE: mean per-vertex L2 against the neutral-SMPL GT mesh, in mm.
GT joints come from the gendered meshes (male, or female where gender == 1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dynaboa_tpu_torch import constants
from dynaboa_tpu_torch.models.smpl import SMPLModel, smpl_forward
from dynaboa_tpu_torch.ops.procrustes import similarity_transform


class GenderedSMPL(NamedTuple):
    neutral: SMPLModel
    male: SMPLModel
    female: SMPLModel
    J_regressor_h36m: torch.Tensor   # (17, V)


def h36m_14_joints(Jreg: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """Pelvis-centred 14-joint skeleton from mesh vertices."""
    j = torch.einsum("kv,nvc->nkc", Jreg, vertices)            # (N, 17, 3)
    pelvis = j[:, :1]
    j = j[:, list(constants.H36M_TO_J14)]
    return j - pelvis


def gt_targets(smpls: GenderedSMPL, gt_pose, gt_betas, gender) -> dict:
    """Prediction-independent targets (three eager GT SMPL forwards), shared
    by every evaluation of one frame.

    Args:
      gt_pose: (N, 72) axis-angle; gt_betas: (N, 10); gender: (N,) int.
    """
    male = smpl_forward(smpls.male, gt_betas, gt_pose, pose2rot=True)
    female = smpl_forward(smpls.female, gt_betas, gt_pose, pose2rot=True)
    gt_vertices = torch.where((gender == 1)[:, None, None], female.vertices,
                              male.vertices)
    neutral = smpl_forward(smpls.neutral, gt_betas, gt_pose, pose2rot=True)
    return {"gt_j14": h36m_14_joints(smpls.J_regressor_h36m, gt_vertices),
            "gt_neutral_vertices": neutral.vertices}


def evaluate_pred(smpls: GenderedSMPL, pred_vertices, targets: dict) -> dict:
    """(N,) metrics in mm of one prediction against ``gt_targets``."""
    gt_j14 = targets["gt_j14"]
    pred_j14 = h36m_14_joints(smpls.J_regressor_h36m, pred_vertices)
    mpjpe = torch.sqrt(((pred_j14 - gt_j14) ** 2).sum(-1)).mean(-1)
    aligned = similarity_transform(pred_j14, gt_j14)
    pampjpe = torch.sqrt(((aligned - gt_j14) ** 2).sum(-1)).mean(-1)
    pve = torch.sqrt(((targets["gt_neutral_vertices"] - pred_vertices) ** 2
                      ).sum(-1)).mean(-1)
    return {"mpjpe": mpjpe * 1000.0, "pampjpe": pampjpe * 1000.0,
            "pve": pve * 1000.0}


def evaluate_frame(smpls: GenderedSMPL, pred_vertices, gt_pose, gt_betas,
                   gender) -> dict:
    return evaluate_pred(smpls, pred_vertices,
                         gt_targets(smpls, gt_pose, gt_betas, gender))
