"""Offline 3DPW test-set extraction -> per-(sequence, person) npz archives
(counterpart of ``dynaboa_tpu/data/preprocess/pw3d.py``).

Reads the official sequenceFiles/test pickles in the reference's fixed
order, computes the 49 ground-truth joints through the gendered SMPL (one
batched decode per track on the SMPL models' device), projects them with
the camera pose and intrinsics, derives the bbox from the projected joints,
rotates the global orientation into the camera frame, and writes
``3dpw_{seq}_{person}.npz``.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from dynaboa_tpu_torch.models.smpl import SMPLModel, smpl_forward
from dynaboa_tpu_torch.ops.rotations import batch_rodrigues, rotmat_to_aa

# Fixed sequence order: it sets the benchmark's stream order and the
# protocol's sequence ids.
SEQUENCE_ORDER = [
    "downtown_runForBus_00.pkl", "downtown_rampAndStairs_00.pkl",
    "flat_packBags_00.pkl", "downtown_runForBus_01.pkl",
    "office_phoneCall_00.pkl", "downtown_windowShopping_00.pkl",
    "downtown_walkUphill_00.pkl", "downtown_sitOnStairs_00.pkl",
    "downtown_enterShop_00.pkl", "downtown_walking_00.pkl",
    "downtown_stairs_00.pkl", "downtown_crossStreets_00.pkl",
    "downtown_car_00.pkl", "downtown_downstairs_00.pkl",
    "downtown_bar_00.pkl", "downtown_walkBridge_01.pkl",
    "downtown_weeklyMarket_00.pkl", "downtown_warmWelcome_00.pkl",
    "downtown_arguing_00.pkl", "downtown_upstairs_00.pkl",
    "downtown_bus_00.pkl", "flat_guitar_01.pkl", "downtown_cafe_00.pkl",
    "outdoors_fencing_01.pkl",
]

# 3DPW's 18 OpenPose joints -> their SPIN-49 slots
OPENPOSE18_TO_SPIN49 = [0, 1, 2, 3, 4, 5, 6, 7, 9, 10, 11, 12, 13, 14, 15,
                        16, 17, 18]


def project_to_image(joints, trans, cam_pose, cam_intrinsics):
    """World-frame SMPL joints -> pixel coordinates."""
    pts = joints + trans
    pts_h = np.concatenate([pts, np.ones((pts.shape[0], 1))], axis=1)
    cam_pts = (pts_h @ cam_pose.T)[:, :3]
    cam_pts = cam_pts / cam_pts[:, None, -1]
    pix = cam_pts @ cam_intrinsics.T
    return pix[:, :2]


def bbox_from_j2d(j2d, scale_factor: float = 1.0):
    lo = j2d[:, :2].min(0)
    hi = j2d[:, :2].max(0)
    center = (lo + hi) / 2
    scale = scale_factor * max(hi[0] - lo[0], hi[1] - lo[1]) / 200.0
    return center, scale


def _decode(model: SMPLModel, betas: np.ndarray, poses: np.ndarray):
    """The 49 joints of a track, (N, 49, 3), and its root rotations
    (N, 3, 3), on the SMPL model's device without the skinning kernel."""
    dev = model.v_template.device
    with torch.no_grad():
        out = smpl_forward(model, torch.as_tensor(betas, device=dev),
                           torch.as_tensor(poses, device=dev), pose2rot=True)
        root = batch_rodrigues(torch.as_tensor(poses[:, :3], device=dev))
        return out.joints.cpu().numpy(), root.cpu().numpy()


def _root_to_aa(Rs: np.ndarray, device) -> np.ndarray:
    with torch.no_grad():
        return rotmat_to_aa(torch.as_tensor(Rs, device=device)).cpu().numpy()


def pw3d_extract(dataset_path: str, out_path: str, smpl_male: SMPLModel,
                 smpl_female: SMPLModel):
    """Extract all test sequences.

    Args:
      dataset_path: 3DPW root (contains sequenceFiles/test).
      out_path: output dir for 3dpw_{i}_{p}.npz.
      smpl_male/female: gendered SMPL models (``load_smpl_npz``), on the
        device the decodes run on.
    """
    os.makedirs(out_path, exist_ok=True)
    seq_dir = os.path.join(dataset_path, "sequenceFiles", "test")

    for seq_idx, name in enumerate(SEQUENCE_ORDER):
        with open(os.path.join(seq_dir, name), "rb") as f:
            data = pickle.load(f, encoding="latin1")
        num_people = len(data["poses"])
        num_frames = len(data["img_frame_ids"])
        seq_name = str(data["sequence"])

        for p_id in range(num_people):
            valid = np.asarray(data["campose_valid"][p_id]).astype(bool)
            poses = np.asarray(data["poses"][p_id])[valid].astype(np.float32)
            betas = np.tile(
                np.asarray(data["betas"][p_id][:10], np.float32)[None],
                (num_frames, 1))[valid]
            trans = np.asarray(data["trans"][p_id])[valid].astype(np.float32)
            op_j2d = np.asarray(
                data["poses2d"][p_id]).transpose(0, 2, 1)[valid]
            cam_pose = np.asarray(data["cam_poses"])[valid].astype(np.float32)
            intr = np.asarray(data["cam_intrinsics"], np.float32)
            gender = str(data["genders"][p_id])

            imgnames = np.array([
                f"imageFiles/{seq_name}/image_{i:05d}.jpg"
                for i in range(num_frames)
            ])[valid]

            # batched 49-joint SMPL forward (gendered)
            model = smpl_male if gender == "m" else smpl_female
            j3ds, root_rotmat = _decode(model, betas, poses)

            # project to the image plane + conf column
            gt_j2ds = np.stack([
                np.concatenate([
                    project_to_image(j3ds[i], trans[i], cam_pose[i], intr),
                    np.ones((49, 1)),
                ], axis=1)
                for i in range(j3ds.shape[0])
            ])

            # scatter the OpenPose 18 joints into the 49-slot layout
            op49 = np.zeros_like(gt_j2ds)
            op49[:, OPENPOSE18_TO_SPIN49] = op_j2d

            centers, scales = zip(*[bbox_from_j2d(j) for j in gt_j2ds])

            # rotate global orient into the camera frame
            Rs = cam_pose[:, :3, :3] @ root_rotmat
            poses[:, :3] = _root_to_aa(Rs, model.v_template.device)

            np.savez(
                os.path.join(out_path, f"3dpw_{seq_idx}_{p_id}.npz"),
                imgname=imgnames,
                gender=np.array([gender] * poses.shape[0]),
                scale=np.asarray(scales, np.float32),
                center=np.asarray(centers, np.float32),
                pose=poses, shape=betas, j3d=j3ds, j2d=gt_j2ds, op_j2d=op49,
            )
            print(f"wrote 3dpw_{seq_idx}_{p_id}.npz ({poses.shape[0]} frames)")
