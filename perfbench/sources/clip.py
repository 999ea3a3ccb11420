"""A pool of BGR uint8 frames of a mid-grey scene with a darker
person-sized box and per-pixel jitter, each with the BODY_25 keypoints of
a standing skeleton in that box, jittered per frame: a recorded video or a
webcam under an OpenPose-style detector, kept in memory.

``spec``: ``pool`` frames of ``width`` x ``height``, keypoint jitter
``kp_jitter`` (pixels) at confidence ``kp_conf``, and optionally
``no_person``, the share of the pool's frames in which the detector finds
nobody (their keypoints are ``None``, and the app passes them through).
"""

from __future__ import annotations

import numpy as np

# A standing BODY_25 skeleton in a unit person box (x, y)
SKELETON = np.array([
    [0.50, 0.08], [0.50, 0.22], [0.38, 0.22], [0.33, 0.38], [0.30, 0.52],
    [0.62, 0.22], [0.67, 0.38], [0.70, 0.52], [0.50, 0.52], [0.42, 0.52],
    [0.42, 0.72], [0.42, 0.92], [0.58, 0.52], [0.58, 0.72], [0.58, 0.92],
    [0.47, 0.06], [0.53, 0.06], [0.44, 0.08], [0.56, 0.08], [0.60, 0.96],
    [0.62, 0.96], [0.57, 0.94], [0.40, 0.96], [0.38, 0.96], [0.43, 0.94],
], np.float32)


def frames_and_keypoints(seed: int, n: int, width: int, height: int,
                         jitter: float, conf: float):
    """``n`` BGR frames (height, width, 3) and their (n, 25, 3) keypoints.
    The scene's box and the skeleton's box sit at fixed pixels (x 110-210,
    y 30-210), whatever the frame size."""
    r = np.random.default_rng(int(seed) % (2 ** 63))
    base = np.full((height, width, 3), 128, np.uint8)
    base[30:210, 110:210] = 90
    frames = [np.clip(base + r.integers(-6, 7, size=(height, width, 3)).astype(
        np.int16), 0, 255).astype(np.uint8) for _ in range(n)]
    kps = np.zeros((n, 25, 3), np.float32)
    box_x, box_y, box_w, box_h = 110.0, 30.0, 100.0, 180.0
    skel = np.stack([box_x + SKELETON[:, 0] * box_w,
                     box_y + SKELETON[:, 1] * box_h], -1)
    kps[:, :, :2] = skel[None] + r.normal(scale=jitter, size=(n, 25, 2))
    kps[:, :, 2] = conf
    return frames, kps


def make(seed: int, spec: dict, cfg: dict, device) -> list[dict]:
    """The pool as ``{"bgr": frame, "kp": (25, 3) keypoints or None}``."""
    n = spec["pool"]
    frames, kps = frames_and_keypoints(seed, n, spec["width"], spec["height"],
                                       spec["kp_jitter"], spec["kp_conf"])
    empty = set()
    k = int(round(spec.get("no_person", 0.0) * n))
    if k:
        r = np.random.default_rng([int(seed) % (2 ** 63), 2])
        empty = {int(i) for i in r.permutation(n)[:k]}
    return [{"bgr": f, "kp": None if i in empty else kps[i]}
            for i, f in enumerate(frames)]
