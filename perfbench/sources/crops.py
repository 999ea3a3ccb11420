"""A pool of 224 x 224 crops as a 3DPW stream feeds the engine, each with
49 normalised keypoints (confidence 1), an SMPL pose, shape and gender,
drawn on the device from the seed.

``spec``: ``pool``, the number of distinct frames."""

from __future__ import annotations

import torch

from perfbench.harness.inputs import FRAMES, generator


def make(seed: int, spec: dict, cfg: dict, device) -> list[dict]:
    """``spec["pool"]`` distinct frames as the engine takes them (batch of
    one): ``image``, ``j2d``, ``pose``, ``betas``, ``gender``."""
    n, res = spec["pool"], cfg["model"]["img_res"]
    g = generator(seed, FRAMES, device)
    img = torch.randn((n, 1, res, res, 3), generator=g, device=device)
    kp = torch.cat([torch.rand((n, 1, 49, 2), generator=g, device=device)
                    * 2 - 1, torch.ones((n, 1, 49, 1), device=device)], -1)
    pose = 0.2 * torch.randn((n, 1, 72), generator=g, device=device)
    betas = 0.3 * torch.randn((n, 1, 10), generator=g, device=device)
    gender = torch.randint(0, 2, (n, 1), generator=g, device=device,
                           dtype=torch.int32)
    return [{"image": img[i], "j2d": kp[i], "pose": pose[i],
             "betas": betas[i], "gender": gender[i]} for i in range(n)]
