"""Camera, image and SMPL constants and the SPIN 49-joint ordering.

The port's own copy of ``dynaboa_tpu/constants.py`` (the public constants
of the SPIN/DynaBOA family of HMR models), so that no
module of the port imports the JAX package.  ``tests/test_torch_standalone.py``
holds every name here equal to the JAX package's.
"""

from __future__ import annotations

import numpy as np

# Camera / image conventions.
FOCAL_LENGTH = 5000.0
IMG_RES = 224

# ImageNet normalization statistics used by the backbone.
IMG_NORM_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMG_NORM_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

# 49-joint SPIN superset: 25 OpenPose BODY_25 joints + 24 "ground truth"
# joints.
JOINT_NAMES = [
    # 25 OpenPose joints, in OpenPose BODY_25 order.
    "OP Nose", "OP Neck", "OP RShoulder", "OP RElbow", "OP RWrist",
    "OP LShoulder", "OP LElbow", "OP LWrist", "OP MidHip", "OP RHip",
    "OP RKnee", "OP RAnkle", "OP LHip", "OP LKnee", "OP LAnkle",
    "OP REye", "OP LEye", "OP REar", "OP LEar", "OP LBigToe",
    "OP LSmallToe", "OP LHeel", "OP RBigToe", "OP RSmallToe", "OP RHeel",
    # 24 ground-truth joints (superset over datasets).
    "Right Ankle", "Right Knee", "Right Hip", "Left Hip", "Left Knee",
    "Left Ankle", "Right Wrist", "Right Elbow", "Right Shoulder",
    "Left Shoulder", "Left Elbow", "Left Wrist", "Neck (LSP)",
    "Top of Head (LSP)", "Pelvis (MPII)", "Thorax (MPII)", "Spine (H36M)",
    "Jaw (H36M)", "Head (H36M)", "Nose", "Left Eye", "Right Eye",
    "Left Ear", "Right Ear",
]
JOINT_IDS = {name: i for i, name in enumerate(JOINT_NAMES)}

# Index of each SPIN joint inside the 54-joint SMPL output space
# (24 kinematic + 21 selected vertices + 9 extra regressed joints).
JOINT_MAP = {
    "OP Nose": 24, "OP Neck": 12, "OP RShoulder": 17,
    "OP RElbow": 19, "OP RWrist": 21, "OP LShoulder": 16,
    "OP LElbow": 18, "OP LWrist": 20, "OP MidHip": 0,
    "OP RHip": 2, "OP RKnee": 5, "OP RAnkle": 8,
    "OP LHip": 1, "OP LKnee": 4, "OP LAnkle": 7,
    "OP REye": 25, "OP LEye": 26, "OP REar": 27,
    "OP LEar": 28, "OP LBigToe": 29, "OP LSmallToe": 30,
    "OP LHeel": 31, "OP RBigToe": 32, "OP RSmallToe": 33, "OP RHeel": 34,
    "Right Ankle": 8, "Right Knee": 5, "Right Hip": 45,
    "Left Hip": 46, "Left Knee": 4, "Left Ankle": 7,
    "Right Wrist": 21, "Right Elbow": 19, "Right Shoulder": 17,
    "Left Shoulder": 16, "Left Elbow": 18, "Left Wrist": 20,
    "Neck (LSP)": 47, "Top of Head (LSP)": 48,
    "Pelvis (MPII)": 49, "Thorax (MPII)": 50,
    "Spine (H36M)": 51, "Jaw (H36M)": 52,
    "Head (H36M)": 53, "Nose": 24, "Left Eye": 26,
    "Right Eye": 25, "Left Ear": 28, "Right Ear": 27,
}
# (49,) gather indices from 54-joint SMPL space -> SPIN ordering.
SPIN_JOINT_GATHER = np.array([JOINT_MAP[n] for n in JOINT_NAMES],
                             dtype=np.int32)

# Joint selectors: H36M 17-joint and the 24 GT joints -> 17 / 14.
H36M_TO_J17 = [6, 5, 4, 1, 2, 3, 16, 15, 14, 11, 12, 13, 8, 10, 0, 7, 9]
H36M_TO_J14 = H36M_TO_J17[:14]
J24_TO_J17 = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 18, 14, 16, 17]
J24_TO_J14 = J24_TO_J17[:14]

# Left/right flip permutations.
SMPL_JOINTS_FLIP_PERM = [
    0, 2, 1, 3, 5, 4, 6, 8, 7, 9, 11, 10, 12, 14, 13, 15, 17, 16, 19, 18,
    21, 20, 23, 22,
]
SMPL_POSE_FLIP_PERM = []
for _i in SMPL_JOINTS_FLIP_PERM:
    SMPL_POSE_FLIP_PERM.extend([3 * _i, 3 * _i + 1, 3 * _i + 2])
J24_FLIP_PERM = [
    5, 4, 3, 2, 1, 0, 11, 10, 9, 8, 7, 6, 12, 13, 14, 15, 16, 17, 18, 19,
    21, 20, 23, 22,
]
J49_FLIP_PERM = (
    [0, 1, 5, 6, 7, 2, 3, 4, 8, 12, 13, 14, 9, 10, 11, 16, 15, 18, 17,
     22, 23, 24, 19, 20, 21]
    + [25 + i for i in J24_FLIP_PERM]
)

# SMPL mesh topology.
NUM_VERTICES = 6890
NUM_JOINTS = 24          # SMPL kinematic joints
NUM_BETAS = 10
NUM_POSEDIRS = 207       # 23 * 9 pose-blendshape features

# Vertex ids appended to the 24 kinematic joints by the vertex-joint
# selector, in selector order: 5 face keypoints, 6 feet keypoints,
# 10 finger tips -> joints 24..44.
VERTEX_JOINT_IDS = np.array([
    332,    # nose
    6260,   # right eye
    2800,   # left eye
    4071,   # right ear
    583,    # left ear
    3216,   # left big toe
    3226,   # left small toe
    3387,   # left heel
    6617,   # right big toe
    6624,   # right small toe
    6787,   # right heel
    2746,   # left thumb tip
    2319,   # left index tip
    2445,   # left middle tip
    2556,   # left ring tip
    2673,   # left pinky tip
    6191,   # right thumb tip
    5782,   # right index tip
    5905,   # right middle tip
    6016,   # right ring tip
    6133,   # right pinky tip
], dtype=np.int32)

NUM_SELECTED_JOINTS = NUM_JOINTS + len(VERTEX_JOINT_IDS)  # 45
NUM_EXTRA_JOINTS = 9                                      # J_regressor_extra
NUM_SMPL_SPACE_JOINTS = NUM_SELECTED_JOINTS + NUM_EXTRA_JOINTS  # 54
NUM_SPIN_JOINTS = 49
