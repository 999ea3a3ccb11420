"""Offline Human3.6M frame extraction.

Capability parity with reference ``utils/data_preprocess/human36m.py``
(h36m_train_extract:25-74): walk each subject's D3_Positions_mono pose files,
decode the matching video, and save every 5th frame of camera 60457274 as
``{subject}_{action}.{camera}_{frame+1:06d}.jpg``.

The reference reads the 3D pose archives through spacepy's pycdf (a C
library); since the extracted *frames* are the only artifact consumed
downstream (the pose file just supplies the frame count), the CDF dependency
is optional here: frame counts fall back to the video length when no CDF
reader is available.
"""

from __future__ import annotations

import glob
import os

CAMERA_DICT = {
    "55011271": "cam1",
    "58860488": "cam2",
    "60457274": "cam3",
    "54138969": "cam0",
}

KEEP_CAMERA = "60457274"
FRAME_STRIDE = 5


def _cdf_frame_count(path: str) -> int | None:
    try:
        # in-repo pure-python CDF reader (replaces spacepy pycdf)
        from dynaboa_tpu_torch.data.preprocess.cdf import read_cdf

        return int(read_cdf(path)["Pose"][0].shape[0])
    except Exception:
        pass
    try:
        from spacepy import pycdf  # optional C fallback

        return int(pycdf.CDF(path)["Pose"][0].shape[0])
    except Exception:
        return None


def read_pose_cdf(path: str):
    """Read an H36M D3_Positions_mono archive -> (frames, 96) float64."""
    from dynaboa_tpu_torch.data.preprocess.cdf import read_cdf

    return read_cdf(path)["Pose"][0]


def h36m_train_extract(dataset_path: str, training_split: bool = True,
                       extract_img: bool = True):
    """NB: the reference's process_data.py calls this with an
    ``extract_img`` kwarg its function doesn't accept (a latent TypeError,
    reference process_data.py:13 vs human36m.py:25); here the kwarg exists
    and False skips the (only) image-writing work."""
    import cv2

    user_list = [1, 5, 6, 7, 8] if training_split else [9, 11]
    imgs_path = os.path.join(dataset_path, "images")
    os.makedirs(imgs_path, exist_ok=True)

    for user_i in user_list:
        user_name = f"S{user_i}"
        pose_path = os.path.join(dataset_path, user_name, "MyPoseFeatures",
                                 "D3_Positions_mono")
        vid_path = os.path.join(dataset_path, user_name, "Videos")

        for seq in sorted(glob.glob(os.path.join(pose_path, "*.cdf"))):
            seq_name = os.path.basename(seq)
            action, camera, _ = seq_name.split(".")
            action = action.replace(" ", "_")
            if action == "_ALL" or camera != KEEP_CAMERA:
                continue
            if not extract_img:
                continue

            n_frames = _cdf_frame_count(seq)
            vid_file = os.path.join(vid_path, seq_name.replace("cdf", "mp4"))
            cap = cv2.VideoCapture(vid_file)
            if n_frames is None:
                n_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))

            for frame_i in range(n_frames):
                ok, image = cap.read()
                if not ok:
                    break
                if frame_i % FRAME_STRIDE == 0:
                    imgname = (f"{user_name}_{action}.{camera}_"
                               f"{frame_i + 1:06d}.jpg")
                    cv2.imwrite(os.path.join(imgs_path, imgname), image)
            cap.release()
