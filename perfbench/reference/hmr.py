"""Plain HMR forward: ResNet-50 with GroupNorm and the iterative SMPL
regressor, as functions of a name -> tensor parameter dict.

A frozen, standalone copy of the architecture the system under test runs
(HMR of Kanazawa et al. 2018 with the GroupNorm backbone of DynaBOA,
arXiv 2111.04017).  Parameter names follow the published checkpoint
(``conv1``, ``bn1``, ``layerL.B.convI`` / ``bnI``,
``layerL.0.downsample.{0,1}``, ``fc1``, ``fc2``, ``decpose``, ``decshape``,
``deccam``).  Input images are NHWC and ImageNet-normalised.

Returns ``(rotmat (B, 24, 3, 3), shape (B, 10), cam (B, 3), taps)``; tap 5
is the pooled feature that retrieval reads and tap 12 the regressor's last
fc2 output that the dynamic update gate reads.  Dropout is off (the
protocol adapts in eval mode), so taps 7 + 3i equal taps 6 + 3i.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

GN_GROUPS = 4
GN_EPS = 1e-5


def _conv(p, name, x, stride=1, padding=0):
    return F.conv2d(x, p[f"{name}.weight"], None, stride, padding)


def _gn(p, name, x):
    return F.group_norm(x, GN_GROUPS, p[f"{name}.weight"], p[f"{name}.bias"],
                        GN_EPS)


def _linear(p, name, x):
    return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def safe_normalize(v, eps=1e-12):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=eps)


def rot6d_to_rotmat(x):
    """(..., 6k) -> (N, 3, 3) by Gram-Schmidt; the 6-vector is read as a
    row-major (3, 2) matrix."""
    x = x.reshape(-1, 3, 2)
    a1, a2 = x[..., 0], x[..., 1]
    b1 = safe_normalize(a1)
    b2 = safe_normalize(a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def forward(p, image, layers, n_iter, init_pose, init_shape, init_cam):
    """image (B, H, W, 3) -> rotmat, shape, cam, 15 taps."""
    B = image.shape[0]
    x = image.permute(0, 3, 1, 2)
    taps = []
    x = _conv(p, "conv1", x, 2, 3)
    taps.append(x)
    x = F.max_pool2d(F.relu(_gn(p, "bn1", x)), 3, 2, 1)
    for li, blocks in enumerate(layers, start=1):
        for b in range(blocks):
            pre = f"layer{li}.{b}"
            stride = 2 if (b == 0 and li > 1) else 1
            out = F.relu(_gn(p, f"{pre}.bn1", _conv(p, f"{pre}.conv1", x)))
            out = F.relu(_gn(p, f"{pre}.bn2",
                             _conv(p, f"{pre}.conv2", out, stride, 1)))
            out = _gn(p, f"{pre}.bn3", _conv(p, f"{pre}.conv3", out))
            res = x if b else _gn(p, f"{pre}.downsample.1",
                                  _conv(p, f"{pre}.downsample.0", x, stride))
            x = F.relu(out + res)
        taps.append(x)
    xf = x.mean(dim=(2, 3))
    taps.append(xf)
    pose = init_pose.expand(B, -1)
    shape = init_shape.expand(B, -1)
    cam = init_cam.expand(B, -1)
    for _ in range(n_iter):
        xc = _linear(p, "fc1", torch.cat([xf, pose, shape, cam], dim=1))
        taps += [xc, xc]
        xc = _linear(p, "fc2", xc)
        taps.append(xc)
        pose = _linear(p, "decpose", xc) + pose
        shape = _linear(p, "decshape", xc) + shape
        cam = _linear(p, "deccam", xc) + cam
    rotmat = rot6d_to_rotmat(pose).reshape(B, 24, 3, 3)
    return rotmat, shape, cam, tuple(taps)
