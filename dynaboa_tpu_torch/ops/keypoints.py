"""Skeleton-format taxonomy and keypoint converters (a copy of
``dynaboa_tpu/ops/keypoints.py``, which the port does not import).

Capability parity with reference ``utils/kp_utils.py`` (convert_kps /
get_perm_idxs:28-44 and the per-dataset joint-name tables): one registry of
joint-name tuples, and converters expressed as gather index arrays, so the
same tables also index tensors.  Pure numpy.
"""

from __future__ import annotations

import numpy as np

# Canonical joint-name tables per skeleton format.  Names shared across
# formats identify the same physical landmark, which is what makes
# cross-format conversion a pure gather.
JOINT_FORMATS: dict[str, tuple[str, ...]] = {
    "spin": (
        "OP Nose", "OP Neck", "OP RShoulder", "OP RElbow", "OP RWrist",
        "OP LShoulder", "OP LElbow", "OP LWrist", "OP MidHip", "OP RHip",
        "OP RKnee", "OP RAnkle", "OP LHip", "OP LKnee", "OP LAnkle",
        "OP REye", "OP LEye", "OP REar", "OP LEar", "OP LBigToe",
        "OP LSmallToe", "OP LHeel", "OP RBigToe", "OP RSmallToe", "OP RHeel",
        "rankle", "rknee", "rhip", "lhip", "lknee", "lankle",
        "rwrist", "relbow", "rshoulder", "lshoulder", "lelbow", "lwrist",
        "neck", "headtop", "hip", "thorax", "Spine (H36M)", "Jaw (H36M)",
        "Head (H36M)", "nose", "leye", "reye", "lear", "rear",
    ),
    "h36m": (
        "hip", "lhip", "lknee", "lankle", "rhip", "rknee", "rankle",
        "Spine (H36M)", "neck", "Head (H36M)", "headtop", "lshoulder",
        "lelbow", "lwrist", "rshoulder", "relbow", "rwrist",
    ),
    "coco": (
        "nose", "leye", "reye", "lear", "rear", "lshoulder", "rshoulder",
        "lelbow", "relbow", "lwrist", "rwrist", "lhip", "rhip", "lknee",
        "rknee", "lankle", "rankle",
    ),
    "common": (
        "rankle", "rknee", "rhip", "lhip", "lknee", "lankle", "rwrist",
        "relbow", "rshoulder", "lshoulder", "lelbow", "lwrist", "neck",
        "headtop",
    ),
    "mpii": (
        "rankle", "rknee", "rhip", "lhip", "lknee", "lankle", "hip",
        "thorax", "neck", "headtop", "rwrist", "relbow", "rshoulder",
        "lshoulder", "lelbow", "lwrist",
    ),
    "mpii3d": (
        "spine3", "spine4", "spine2", "Spine (H36M)", "hip", "neck",
        "Head (H36M)", "headtop", "left_clavicle", "lshoulder", "lelbow",
        "lwrist", "left_hand", "right_clavicle", "rshoulder", "relbow",
        "rwrist", "right_hand", "lhip", "lknee", "lankle", "left_foot",
        "left_toe", "rhip", "rknee", "rankle", "right_foot", "right_toe",
    ),
    "mpii3d_test": (
        "headtop", "neck", "rshoulder", "relbow", "rwrist", "lshoulder",
        "lelbow", "lwrist", "rhip", "rknee", "rankle", "lhip", "lknee",
        "lankle", "hip", "Spine (H36M)", "Head (H36M)",
    ),
    "3dpw": (
        "nose", "thorax", "rshoulder", "relbow", "rwrist", "lshoulder",
        "lelbow", "lwrist", "rhip", "rknee", "rankle", "lhip", "lknee",
        "lankle",
    ),
    "smplcoco": (
        "rankle", "rknee", "rhip", "lhip", "lknee", "lankle", "rwrist",
        "relbow", "rshoulder", "lshoulder", "lelbow", "lwrist", "neck",
        "headtop", "nose", "leye", "reye", "lear", "rear",
    ),
    "smpl": (
        "hips", "leftUpLeg", "rightUpLeg", "spine", "leftLeg", "rightLeg",
        "spine1", "leftFoot", "rightFoot", "spine2", "leftToeBase",
        "rightToeBase", "neck", "leftShoulder", "rightShoulder", "head",
        "leftArm", "rightArm", "leftForeArm", "rightForeArm", "leftHand",
        "rightHand", "leftHandIndex1", "rightHandIndex1",
    ),
    "posetrack": (
        "nose", "neck", "headtop", "lear", "rear", "lshoulder", "rshoulder",
        "lelbow", "relbow", "lwrist", "rwrist", "lhip", "rhip", "lknee",
        "rknee", "lankle", "rankle",
    ),
    "pennaction": (
        "headtop", "lshoulder", "rshoulder", "lelbow", "relbow", "lwrist",
        "rwrist", "lhip", "rhip", "lknee", "rknee", "lankle", "rankle",
    ),
    "aich": (
        "rshoulder", "relbow", "rwrist", "lshoulder", "lelbow", "lwrist",
        "rhip", "rknee", "rankle", "lhip", "lknee", "lankle", "headtop",
        "neck",
    ),
    "insta": (
        "OP RHeel", "OP RKnee", "OP RHip", "OP LHip", "OP LKnee", "OP LHeel",
        "OP RWrist", "OP RElbow", "OP RShoulder", "OP LShoulder", "OP LElbow",
        "OP LWrist", "OP Neck", "headtop", "OP Nose", "OP LEye", "OP REye",
        "OP LEar", "OP REar", "OP LBigToe", "OP RBigToe", "OP LSmallToe",
        "OP RSmallToe", "OP LAnkle", "OP RAnkle",
    ),
    "staf": (
        "OP Nose", "OP Neck", "OP RShoulder", "OP RElbow", "OP RWrist",
        "OP LShoulder", "OP LElbow", "OP LWrist", "OP MidHip", "OP RHip",
        "OP RKnee", "OP RAnkle", "OP LHip", "OP LKnee", "OP LAnkle",
        "OP REye", "OP LEye", "OP REar", "OP LEar", "Neck (LSP)",
        "Top of Head (LSP)",
    ),
}


# The posetrack dataset's own joint naming (reference kp_utils.py:338-357,
# ``get_posetrack_original_kp_names``).  Position i here is the same landmark
# as position i of JOINT_FORMATS["posetrack"]'s canonical names.
POSETRACK_ORIGINAL_KP_NAMES: tuple[str, ...] = (
    "nose", "head_bottom", "head_top", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip", "left_knee",
    "right_knee", "left_ankle", "right_ankle",
)


def joint_names(fmt: str) -> tuple[str, ...]:
    try:
        return JOINT_FORMATS[fmt]
    except KeyError as e:
        raise ValueError(f"unknown skeleton format {fmt!r}; "
                         f"known: {sorted(JOINT_FORMATS)}") from e


def get_perm_idxs(src: str, dst: str) -> list[int]:
    """Indices into ``src`` for every dst joint present in src, in dst order.

    Parity with reference kp_utils.py:40-44.
    """
    src_names = joint_names(src)
    return [src_names.index(n) for n in joint_names(dst) if n in src_names]


def conversion_table(src: str, dst: str):
    """(gather, mask) arrays mapping src-format joints to dst format.

    ``gather[i]`` is the src index feeding dst joint i (0 where absent) and
    ``mask[i]`` is 1.0 where dst joint i exists in src.
    """
    src_names = joint_names(src)
    dst_names = joint_names(dst)
    gather = np.zeros(len(dst_names), dtype=np.int32)
    mask = np.zeros(len(dst_names), dtype=np.float32)
    for i, n in enumerate(dst_names):
        if n in src_names:
            gather[i] = src_names.index(n)
            mask[i] = 1.0
    return gather, mask


def convert_kps(joints: np.ndarray, src: str, dst: str) -> np.ndarray:
    """Re-index (B, J_src, 3) keypoints into (B, J_dst, 3); missing dst
    joints are zero.  Parity with reference kp_utils.py:28-38."""
    gather, mask = conversion_table(src, dst)
    out = joints[:, gather] * mask[None, :, None]
    return out


def keypoint_hflip(kp: np.ndarray, img_width: float) -> np.ndarray:
    """Horizontal flip in pixel space (reference kp_utils.py:19-26)."""
    kp = kp.copy()
    kp[..., 0] = (img_width - 1.0) - kp[..., 0]
    return kp


# ---------------------------------------------------------------------------
# Skeleton edge tables (bone connectivity per format, for visualization;
# reference kp_utils.py get_*_skeleton functions)
# ---------------------------------------------------------------------------

SKELETONS: dict[str, tuple[tuple[int, int], ...]] = {
    "spin": (
        (0, 1), (1, 2), (2, 3), (3, 4), (1, 5), (5, 6), (6, 7), (1, 8),
        (8, 9), (9, 10), (10, 11), (8, 12), (12, 13), (13, 14), (0, 15),
        (0, 16), (15, 17), (16, 18), (21, 19), (19, 20), (14, 21), (11, 24),
        (24, 22), (22, 23), (0, 38),
    ),
    "coco": (
        (15, 13), (13, 11), (16, 14), (14, 12), (11, 12), (5, 11), (6, 12),
        (5, 6), (5, 7), (6, 8), (7, 9), (8, 10), (1, 2), (0, 1), (0, 2),
        (1, 3), (2, 4), (3, 5), (4, 6),
    ),
    "common": (
        (0, 1), (1, 2), (3, 4), (4, 5), (6, 7), (7, 8), (8, 2), (8, 9),
        (9, 3), (2, 3), (8, 12), (9, 10), (12, 9), (10, 11), (12, 13),
    ),
    "mpii": (
        (0, 1), (1, 2), (2, 6), (6, 3), (3, 4), (4, 5), (6, 7), (7, 8),
        (8, 9), (7, 12), (12, 11), (11, 10), (7, 13), (13, 14), (14, 15),
    ),
    "smpl": (
        (0, 1), (0, 2), (0, 3), (1, 4), (2, 5), (3, 6), (4, 7), (5, 8),
        (6, 9), (7, 10), (8, 11), (9, 12), (9, 13), (9, 14), (12, 15),
        (13, 16), (14, 17), (16, 18), (17, 19), (18, 20), (19, 21),
        (20, 22), (21, 23),
    ),
    "3dpw": (
        (0, 1), (1, 2), (2, 3), (3, 4), (1, 5), (5, 6), (6, 7), (2, 8),
        (5, 11), (8, 11), (8, 9), (9, 10), (11, 12), (12, 13),
    ),
    "smplcoco": (
        (0, 1), (1, 2), (3, 4), (4, 5), (6, 7), (7, 8), (8, 12), (12, 9),
        (9, 10), (10, 11), (12, 13), (14, 15), (15, 17), (16, 18), (14, 16),
        (8, 2), (9, 3), (2, 3),
    ),
    "aich": (
        (0, 1), (1, 2), (3, 4), (4, 5), (6, 7), (7, 8), (9, 10), (10, 11),
        (12, 13), (13, 0), (13, 3), (0, 6), (3, 9),
    ),
    "staf": (
        (0, 1), (1, 2), (2, 3), (3, 4), (1, 5), (5, 6), (6, 7), (1, 8),
        (8, 9), (9, 10), (10, 11), (8, 12), (12, 13), (13, 14), (0, 15),
        (0, 16), (15, 17), (16, 18), (2, 9), (5, 12), (1, 19), (20, 19),
    ),
    "insta": (
        (0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (6, 7), (7, 8), (8, 9),
        (9, 10), (2, 8), (3, 9), (10, 11), (8, 12), (9, 12), (12, 13),
        (12, 14), (14, 15), (14, 16), (15, 17), (16, 18), (0, 20), (20, 22),
        (5, 19), (19, 21), (5, 23), (0, 24),
    ),
}


def get_skeleton(fmt: str) -> np.ndarray:
    """Bone edge list for a skeleton format, as an (E, 2) int array."""
    try:
        return np.asarray(SKELETONS[fmt], dtype=np.int32)
    except KeyError as e:
        raise ValueError(f"no skeleton table for format {fmt!r}") from e
