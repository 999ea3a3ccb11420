"""A pool of 3DPW-schema stream items as ``StreamRunner.run`` takes them
(``data/streams.py``'s keys, host preprocessing), drawn from the seed: a
raw RGB frame of ``width`` x ``height`` (smooth 8 x 8 blocks, as the
synthetic stream's raw frames), a person box (centre, scale) inside it, the
ImageNet-normalised crop of that box at the configuration's ``img_res``,
made on the host by the reference's crop (``reference/image.py``), 49
keypoints normalised to the crop (confidence 1), an SMPL pose, shape and
gender, and the frame's name and box.  The raw frame rides along under
``frame_rgb`` (a key the runner does not read) for the check's reference,
which crops it again.

``spec``: ``pool`` (the number of distinct items), ``width``, ``height``."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.harness.inputs import FRAMES, generator
from perfbench.reference import image as RI

BLOCK = 8


def make(seed: int, spec: dict, cfg: dict, device) -> list[dict]:
    n, w, h = spec["pool"], spec["width"], spec["height"]
    res = cfg["model"]["img_res"]
    g = generator(seed, FRAMES, device)
    low = torch.randint(0, 256, (n, h // BLOCK, w // BLOCK, 3), generator=g,
                        device=device, dtype=torch.uint8)
    frames = low.repeat_interleave(BLOCK, 1).repeat_interleave(BLOCK, 2).cpu()
    # a box of 0.5-0.9 of the frame's width, inside the frame
    u = torch.rand((n, 3), generator=g, device=device).cpu().numpy()
    side = (0.5 + 0.4 * u[:, 0]) * w
    cx = side / 2 + u[:, 1] * (w - side)
    cy = side / 2 + u[:, 2] * (h - side)
    kp = torch.cat([torch.rand((n, 49, 2), generator=g, device=device) * 2 - 1,
                    torch.ones((n, 49, 1), device=device)], -1).cpu().numpy()
    pose = (0.2 * torch.randn((n, 72), generator=g, device=device)).cpu().numpy()
    betas = (0.3 * torch.randn((n, 10), generator=g, device=device)
             ).cpu().numpy()
    gender = torch.randint(0, 2, (n,), generator=g, device=device,
                           dtype=torch.int32).cpu().numpy()
    out = []
    for i in range(n):
        center = np.array([cx[i], cy[i]], np.float32)
        scale = np.float32(side[i] / 200.0)
        item = {"frame_rgb": frames[i].numpy(), "center": center,
                "scale": scale, "smpl_j2d": kp[i], "op_j2d": kp[i],
                "pose": pose[i], "betas": betas[i], "gender": gender[i],
                "imgname": f"frame_{i:05d}.jpg",
                "bbox": np.array([center[0], center[1], side[i]], np.float32)}
        item["image"] = RI.crop(frames[i], center, float(scale), res).numpy()
        out.append(item)
    return out
