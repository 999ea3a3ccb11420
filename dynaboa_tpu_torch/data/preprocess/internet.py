"""Offline internet-video extraction: AlphaPose JSON -> per-sequence npz
(counterpart of ``dynaboa_tpu/data/preprocess/internet.py``).

Capability parity with reference ``utils/data_preprocess/internet_data.py``
(internet_data_extract:42-79): parse 17-joint COCO detections, filter
low-score (< 2.5) or small (person height < 250 px) detections, binarize
confidence at 0.3, scatter into the 49-slot SPIN layout, derive the bbox from
keypoint extremes, and write {seq}.npz with imgname/center/scale/part, the
archives that ``data.streams.InternetStream`` reads.  ``bbox_from_kp`` is
also the stream app's live crop, so the two crop conventions cannot diverge.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from dynaboa_tpu_torch.ops.keypoints import get_perm_idxs

SCORE_THRESHOLD = 2.5
MIN_PERSON_HEIGHT = 250.0
CONF_THRESHOLD = 0.3


def person_height(kp: np.ndarray) -> float:
    """Diagonal of the box around the confident keypoints."""
    vis = kp[:, 2] > CONF_THRESHOLD
    if not vis.any():
        return 0.0
    lo = kp[vis, :2].min(0)
    hi = kp[vis, :2].max(0)
    return float(np.linalg.norm(hi - lo))


def bbox_from_kp(kp: np.ndarray, scale_factor: float = 1.0):
    """(center, scale) of the keypoints' extent; scale in 200 px units."""
    lo = kp[:, :2].min(0)
    hi = kp[:, :2].max(0)
    center = [(hi[0] + lo[0]) / 2, (hi[1] + lo[1]) / 2]
    scale = scale_factor * max(hi[0] - lo[0], hi[1] - lo[1]) / 200.0
    return center, scale


def internet_data_extract(in_path: str):
    """Process every {seq}.json under in_path into {seq}.npz."""
    perm_idx = get_perm_idxs("spin", "coco")
    seqs = sorted(
        os.path.basename(n)[:-5]
        for n in glob.glob(os.path.join(in_path, "*.json"))
    )
    for seq in seqs:
        with open(os.path.join(in_path, f"{seq}.json")) as f:
            annots = json.load(f)

        names, centers, scales, parts = [], [], [], []
        for annot in annots:
            kp = np.asarray(annot["keypoints"], np.float64).reshape(-1, 3)
            if annot["score"] < SCORE_THRESHOLD:
                continue
            if person_height(kp) < MIN_PERSON_HEIGHT:
                continue
            if kp.shape != (17, 3):
                raise ValueError(f"{seq}: a detection has {kp.shape[0]} "
                                 f"keypoints, expected the 17 of COCO")

            center, scale = bbox_from_kp(kp)
            kp[:, 2] = kp[:, 2] > CONF_THRESHOLD
            part = np.zeros((49, 3))
            part[perm_idx] = kp

            names.append(os.path.join(seq, annot["image_id"]))
            centers.append(center)
            scales.append(scale)
            parts.append(part)

        out = os.path.join(in_path, f"{seq}.npz")
        np.savez(out, imgname=names, center=centers, scale=scales,
                 part=parts)
        print(f"{seq}: kept {len(names)} / {len(annots)} detections -> {out}")
