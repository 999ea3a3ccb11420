"""Labeled source-domain (H36M) exemplars for mixed training (counterpart
of ``dynaboa_tpu/data/source.py``): a joblib archive of fully labeled
samples (imgname / scale / center / pose / shape / S / part) whose images
are cropped and normalized once and kept on the device as the retrieval
bank."""

from __future__ import annotations

import os.path as osp

import numpy as np
import torch

from dynaboa_tpu_torch.data.streams import _imread_rgb, crop_and_normalize
from dynaboa_tpu_torch.engine.retrieval import ExemplarBank
from dynaboa_tpu_torch.ops import image as I


def load_source_exemplars(datapath: str, img_root: str,
                          device) -> ExemplarBank:
    """Load and preprocess the exemplar archive into a bank on ``device``."""
    import joblib

    data = joblib.load(datapath)
    imgnames = data["imgname"]
    scales = np.asarray(data["scale"], np.float32)
    centers = np.asarray(data["center"], np.float32)
    M = scales.shape[0]
    # 49-joint layout: 25 zero OpenPose slots + the 24 GT joints
    kp = np.concatenate([np.zeros((M, 25, 3), np.float32),
                         np.asarray(data["part"], np.float32)], axis=1)

    images, keypoints = [], []
    for i in range(M):
        img = _imread_rgb(osp.join(img_root, str(imgnames[i])))
        images.append(crop_and_normalize(img, centers[i], float(scales[i])))
        keypoints.append(I.normalize_j2d(kp[i], centers[i], float(scales[i])))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return ExemplarBank(images=t(np.stack(images)),
                        keypoints=t(np.stack(keypoints)),
                        pose=t(data["pose"]), betas=t(data["shape"]),
                        pose_3d=t(data["S"]))
