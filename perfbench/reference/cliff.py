"""Plain CLIFF-HR48 forward: the HRNet-W48-C trunk and the box-conditioned
iterative SMPL regressor, as functions of a name -> tensor parameter dict.

A standalone statement of the architecture the system under test runs (Li
et al., "CLIFF", ECCV 2022, arXiv 2208.00571; its ``cliff_hr48``; the trunk
of Wang et al., arXiv 1908.07919, ``cls_hrnet_w48``), at the widths of the
configuration's ``model`` group.  Parameter names are the published
modules' (``encoder.*``, ``fc1``, ``fc2``, ``decpose``, ``decshape``,
``deccam``).  Input images are NHWC, square and ImageNet-normalised; the
trunk reads their middle three quarters of columns (256x192 at 256).

Trunk: two 3x3 stride-2 convolutions and ``layer1`` (Bottlenecks, stride on
the 3x3); stages of modules whose branches run BasicBlocks and whose
exchange unit gives each branch i the ReLU of the sum over every branch j:
j itself, a higher-resolution j through 3x3 stride-2 convolutions (a ReLU
between them, none after the last), a lower-resolution j through a 1x1
convolution and a nearest upsample by 2^(j - i); transitions that add a
branch by a 3x3 stride-2 convolution of the last; the head's Bottleneck per
branch, the 3x3 stride-2 folds (with bias) each added to the next branch's
Bottleneck, a 1x1 convolution (with bias) and the mean over the map.
Regressor: fc1 over [feature, box information, pose, shape, camera], fc2
and the three decoders added to the mean parameters, ``n_iter`` times; the
6D rotation is HMR's row-major (3, 2) reading.

Departures from the published model, each stated: GroupNorm of 4 groups
(eps 1e-5) in every BatchNorm's place, as the system under test runs it
(DynaBOA adapts at batches of one to three rows); dropout off (adaptation
runs in eval mode).  Written out here rather than called: the GroupNorm
(the group's mean and biased variance, then the affine) and the nearest
upsample (``repeat_interleave`` on both axes).

Returns ``(rotmat (B, 24, 3, 3), shape (B, 10), cam (B, 3), taps)``: tap 0
the pooled feature (retrieval's key), then each iteration's fc1 and fc2
outputs; the last fc2 output (tap ``2 n_iter``) is the update gate's
signal.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.hmr import rot6d_to_rotmat

GN_GROUPS = 4
GN_EPS = 1e-5
EXPANSION = 4


def box_info(box):
    """(B, 5) rows (cx, cy, b, w, h) -> CLIFF's (B, 3) box information,
    with f the frame's diagonal: ((cx - w/2) / f * 2.8, (cy - h/2) / f *
    2.8, (b - 0.24 f) / (0.06 f))."""
    cx, cy, b, w, h = (box[:, i] for i in range(5))
    f = torch.sqrt(w * w + h * h)
    return torch.stack([(cx - 0.5 * w) / f * 2.8, (cy - 0.5 * h) / f * 2.8,
                        (b - 0.24 * f) / (0.06 * f)], dim=1)


def _conv(p, name, x, stride=1):
    w = p[f"{name}.weight"]
    return F.conv2d(x, w, p.get(f"{name}.bias"), stride, w.shape[-1] // 2)


def _gn(p, name, x):
    N, C, H, W = x.shape
    g = x.reshape(N, GN_GROUPS, -1)
    mean = g.mean(dim=2, keepdim=True)
    var = ((g - mean) ** 2).mean(dim=2, keepdim=True)
    y = ((g - mean) / torch.sqrt(var + GN_EPS)).reshape(N, C, H, W)
    return (y * p[f"{name}.weight"][:, None, None]
            + p[f"{name}.bias"][:, None, None])


def _cn(p, conv, norm, x, stride=1):
    return _gn(p, norm, _conv(p, conv, x, stride))


def _upsample(x, factor):
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


def _bottleneck(p, pre, x):
    out = F.relu(_cn(p, f"{pre}.conv1", f"{pre}.bn1", x))
    out = F.relu(_cn(p, f"{pre}.conv2", f"{pre}.bn2", out))
    out = _cn(p, f"{pre}.conv3", f"{pre}.bn3", out)
    res = (_cn(p, f"{pre}.downsample.0", f"{pre}.downsample.1", x)
           if f"{pre}.downsample.0.weight" in p else x)
    return F.relu(out + res)


def _basic(p, pre, x):
    out = F.relu(_cn(p, f"{pre}.conv1", f"{pre}.bn1", x))
    return F.relu(_cn(p, f"{pre}.conv2", f"{pre}.bn2", out) + x)


def _exchange(p, pre, xs):
    n = len(xs)
    out = []
    for i in range(n):
        y = None
        for j in range(n):
            q = f"{pre}.fuse_layers.{i}.{j}"
            if j == i:
                t = xs[j]
            elif j > i:
                t = _upsample(_cn(p, f"{q}.0", f"{q}.1", xs[j]), 2 ** (j - i))
            else:
                t = xs[j]
                for k in range(i - j):
                    t = _cn(p, f"{q}.{k}.0", f"{q}.{k}.1", t, 2)
                    if k < i - j - 1:
                        t = F.relu(t)
            y = t if y is None else y + t
        out.append(F.relu(y))
    return out


def trunk(p, x, m):
    """x (B, 3, H, W) -> the pooled feature (B, feat_dim)."""
    e = "encoder"
    x = F.relu(_cn(p, f"{e}.conv1", f"{e}.bn1", x, 2))
    x = F.relu(_cn(p, f"{e}.conv2", f"{e}.bn2", x, 2))
    for b in range(m["stage1_blocks"]):
        x = _bottleneck(p, f"{e}.layer1.{b}", x)
    ys = [x]
    for s, n_mod in enumerate(m["modules"], start=2):
        t = f"{e}.transition{s - 1}"
        xs = []
        for i in range(s):
            if f"{t}.{i}.0.weight" in p:          # a width changes
                xs.append(F.relu(_cn(p, f"{t}.{i}.0", f"{t}.{i}.1", ys[i])))
            elif f"{t}.{i}.0.0.weight" in p:      # a new branch
                xs.append(F.relu(_cn(p, f"{t}.{i}.0.0", f"{t}.{i}.0.1",
                                     ys[-1], 2)))
            else:
                xs.append(ys[i])
        for mod in range(n_mod):
            pre = f"{e}.stage{s}.{mod}"
            for i in range(s):
                for b in range(m["blocks"]):
                    xs[i] = _basic(p, f"{pre}.branches.{i}.{b}", xs[i])
            xs = _exchange(p, pre, xs)
        ys = xs
    y = _bottleneck(p, f"{e}.incre_modules.0.0", ys[0])
    for i in range(1, len(ys)):
        d = f"{e}.downsamp_modules.{i - 1}"
        y = (_bottleneck(p, f"{e}.incre_modules.{i}.0", ys[i])
             + F.relu(_cn(p, f"{d}.0", f"{d}.1", y, 2)))
    y = F.relu(_cn(p, f"{e}.final_layer.0", f"{e}.final_layer.1", y))
    return y.mean(dim=(2, 3))


def _linear(p, name, x):
    return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def forward(p, image, box, m, init_pose, init_shape, init_cam):
    """image (B, H, W, 3), box (B, 5) -> rotmat, shape, cam, taps."""
    B = image.shape[0]
    c = m["img_res"] // 8
    x = image.permute(0, 3, 1, 2)
    xf = trunk(p, x[:, :, :, c:x.shape[3] - c], m)
    info = box_info(box)
    pose = init_pose.expand(B, -1)
    shape = init_shape.expand(B, -1)
    cam = init_cam.expand(B, -1)
    taps = [xf]
    for _ in range(m["n_iter"]):
        xc = _linear(p, "fc1", torch.cat([xf, info, pose, shape, cam], dim=1))
        taps.append(xc)
        xc = _linear(p, "fc2", xc)
        taps.append(xc)
        pose = _linear(p, "decpose", xc) + pose
        shape = _linear(p, "decshape", xc) + shape
        cam = _linear(p, "deccam", xc) + cam
    rotmat = rot6d_to_rotmat(pose).reshape(B, 24, 3, 3)
    return rotmat, shape, cam, tuple(taps)
