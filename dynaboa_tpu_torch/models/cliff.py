"""CLIFF (Li et al., "CLIFF: Carrying Location Information in Full Frames
into Human Pose and Shape Estimation", ECCV 2022, arXiv 2208.00571;
github.com/huawei-noah/noah-research/tree/master/CLIFF, model
``cliff_hr48``): an HRNet-W48-C trunk and HMR's iterative regressor fed
the person box's place in the full frame, as a torch ``nn.Module`` that
``BilevelEngine`` drives through ``functional_call``.

Trunk (``encoder``; Wang et al., arXiv 1908.07919,
``HRNet/HRNet-Image-Classification`` ``cls_hrnet_w48``), on the square
crop's middle three quarters of columns (256x192 at the published 256):

* stem: two 3x3 stride-2 convolutions 3 -> 64 -> 64, then ``layer1``, four
  Bottlenecks of 64 planes (out 256);
* stages 2-4 (1, 4 and 3 modules) over branches of widths 48 / 96 / 192 /
  384 at 1/4 to 1/32 of the input; a module runs four BasicBlocks on each
  branch, then its exchange unit: each output branch i sums every input
  branch j, a higher-resolution one through a chain of 3x3 stride-2
  convolutions, a lower-resolution one through a 1x1 convolution and a
  nearest upsample by 2^(j - i), and a ReLU follows the sum;
* transitions: a branch whose width changes takes a 3x3 convolution, a new
  branch a 3x3 stride-2 one of the last;
* the classification head: a Bottleneck per branch to 128 / 256 / 512 /
  1024, 3x3 stride-2 convolutions (with bias) that fold each branch into
  the next, a 1x1 convolution (with bias) to 2048 and a global average
  pool: the 2048-d feature.

Every convolution is HMR's ``Conv2d32`` (on a card the Hopper kernel
``kernels/conv.py``) and every normalisation HMR's ``GroupNorm32`` (4
groups, eps 1e-5; on a card ``kernels/group_norm.py``) in place of the
published BatchNorm: DynaBOA adapts at batches of one to three unrelated
rows, where batch statistics mean nothing, and so swaps ResNet-50's
BatchNorm for GroupNorm in its own base model.  That is this model's one
departure from the published architecture.

Regressor: fc1 takes the feature, CLIFF's box information (below), the
pose (24 x 6D, HMR's row-major reading), the shape and the crop camera
(2048 + 3 + 144 + 10 + 3 = 2208), then fc2 1024 and the pose, shape and
camera decoders, added to the mean parameters, ``n_iter`` times.  The box
rows are ``(cx, cy, b, w, h)``: the box's centre and size b = 200 scale in
a frame of w x h pixels; the information is

    [(cx - w/2) / f * 2.8, (cy - h/2) / f * 2.8, (b - 0.24 f) / (0.06 f)]

with f = sqrt(w^2 + h^2), CLIFF's focal estimate.  The camera ``(s, tx,
ty)`` is the crop's; the engine turns it into a full-frame translation
(``ops/camera.py:cam_crop2full``) and projects in the full frame, as the
model declares (``box_conditioned``, ``camera``).

``forward(x, box)`` takes NCHW images (ImageNet-normalised) and ``box`` (B,
5) and returns ``(rotmat (B, 24, 3, 3), shape (B, 10), cam (B, 3), taps)``:

  0: the pooled 2048-d feature, the retrieval key
  1 + 2i, 2 + 2i (i < n_iter): fc1's and fc2's outputs; the last fc2
     output (tap 2 n_iter) is the update gate's signal

Dropout is off in eval mode, as the engine adapts.  Under
``torch.profiler`` the trunk is the span ``model.backbone``, each exchange
unit inside it ``model.fuse`` and the regressor ``model.head``.

Parameter and buffer names follow the published layout: ``encoder.*`` as
``cls_hrnet.py`` names its modules (``conv1``, ``bn1``, ``conv2``, ``bn2``,
``layer1``, ``transitionN``, ``stageN.M.branches`` / ``fuse_layers``,
``incre_modules``, ``downsamp_modules``, ``final_layer``), then ``fc1``,
``fc2``, ``decpose``, ``decshape``, ``deccam`` and the buffers
``init_pose``, ``init_shape``, ``init_cam``.  No checkpoint was at hand to
check them against.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Sequence

import torch
import torch.nn as nn

from dynaboa_tpu_torch.models.hmr import (NPOSE, Bottleneck, Conv2d32,
                                          _gn, _make_layer,
                                          _register_mean_params)
from dynaboa_tpu_torch.ops.rotations import rot6d_to_rotmat
from dynaboa_tpu_torch.tracing import span

# CLIFF's normalisation of the box information (its released code)
BOX_XY_SCALE = 2.8
BOX_SIZE_MEAN = 0.24
BOX_SIZE_STD = 0.06


def focal_length(box: torch.Tensor) -> torch.Tensor:
    """(..., 5) box rows -> (...,) CLIFF's focal estimate, the frame's
    diagonal in pixels."""
    return torch.sqrt(box[..., 3] ** 2 + box[..., 4] ** 2)


def bbox_info(box: torch.Tensor) -> torch.Tensor:
    """(B, 5) box rows ``(cx, cy, b, w, h)`` -> (B, 3) CLIFF's box
    information."""
    cx, cy, b, w, h = box.unbind(-1)
    f = focal_length(box)
    return torch.stack([(cx - w / 2) / f * BOX_XY_SCALE,
                        (cy - h / 2) / f * BOX_XY_SCALE,
                        (b - BOX_SIZE_MEAN * f) / (BOX_SIZE_STD * f)], -1)


def _conv3(cin: int, cout: int, stride: int = 1, bias: bool = False):
    return Conv2d32(cin, cout, 3, stride=stride, padding=1, bias=bias)


class BasicBlock(nn.Module):
    """HRNet's branch block: two 3x3 convolutions and the identity."""

    def __init__(self, planes: int):
        super().__init__()
        self.conv1 = _conv3(planes, planes)
        self.bn1 = _gn(planes)
        self.conv2 = _conv3(planes, planes)
        self.bn2 = _gn(planes)
        self.relu = nn.ReLU()

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        return self.relu(self.bn2(self.conv2(out)) + x)


def _down(cin: int, cout: int, relu: bool) -> nn.Sequential:
    mods = [_conv3(cin, cout, 2), _gn(cout)]
    return nn.Sequential(*mods, nn.ReLU()) if relu else nn.Sequential(*mods)


class HighResolutionModule(nn.Module):
    """``blocks`` BasicBlocks on each branch, then the exchange unit."""

    def __init__(self, widths: Sequence[int], blocks: int):
        super().__init__()
        n = len(widths)
        self.branches = nn.ModuleList([
            nn.Sequential(*[BasicBlock(w) for _ in range(blocks)])
            for w in widths])
        fuse = []
        for i in range(n):
            row = []
            for j in range(n):
                if j > i:
                    row.append(nn.Sequential(
                        Conv2d32(widths[j], widths[i], 1, bias=False),
                        _gn(widths[i]),
                        nn.Upsample(scale_factor=2 ** (j - i),
                                    mode="nearest")))
                elif j == i:
                    row.append(None)
                else:
                    row.append(nn.Sequential(
                        *[_down(widths[j], widths[j], True)
                          for _ in range(i - j - 1)],
                        _down(widths[j], widths[i], False)))
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse) if n > 1 else None
        self.relu = nn.ReLU()

    def forward(self, xs: list) -> list:
        xs = [b(x) for b, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return xs
        with span("model.fuse"):
            out = []
            for i, row in enumerate(self.fuse_layers):
                y = xs[0] if i == 0 else row[0](xs[0])
                for j in range(1, len(xs)):
                    y = y + (xs[j] if i == j else row[j](xs[j]))
                out.append(self.relu(y))
        return out


def _transition(pre: Sequence[int], cur: Sequence[int]) -> nn.ModuleList:
    """Each existing branch whose width changes takes a 3x3 convolution; a
    new branch a 3x3 stride-2 one of the last existing branch."""
    mods = []
    for i, c in enumerate(cur):
        if i < len(pre):
            mods.append(None if pre[i] == c else nn.Sequential(
                _conv3(pre[i], c), _gn(c), nn.ReLU()))
        else:
            mods.append(nn.Sequential(*[
                _down(pre[-1], c if k == i - len(pre) else pre[-1], True)
                for k in range(i + 1 - len(pre))]))
    return nn.ModuleList(mods)


class HRNet(nn.Module):
    """HRNet-C's classification trunk up to the pooled feature."""

    def __init__(self, stem_width: int, stage1_blocks: int,
                 widths: Sequence[int], modules: Sequence[int], blocks: int,
                 head_widths: Sequence[int], feat_dim: int):
        super().__init__()
        self.conv1 = _conv3(3, stem_width, 2)
        self.bn1 = _gn(stem_width)
        self.conv2 = _conv3(stem_width, stem_width, 2)
        self.bn2 = _gn(stem_width)
        self.relu = nn.ReLU()
        net = SimpleNamespace(inplanes=stem_width)
        self.layer1 = _make_layer(net, stem_width, stage1_blocks, 1, _gn,
                                  Conv2d32)
        pre = [net.inplanes]
        for s, n_mod in enumerate(modules, start=2):
            cur = list(widths[:s])
            setattr(self, f"transition{s - 1}", _transition(pre, cur))
            setattr(self, f"stage{s}", nn.Sequential(*[
                HighResolutionModule(cur, blocks) for _ in range(n_mod)]))
            pre = cur
        self.n_stages = len(modules)
        incre = []
        for w, h in zip(widths, head_widths):
            net.inplanes = w
            incre.append(_make_layer(net, h, 1, 1, _gn, Conv2d32))
        self.incre_modules = nn.ModuleList(incre)
        outs = [h * Bottleneck.expansion for h in head_widths]
        self.downsamp_modules = nn.ModuleList([
            nn.Sequential(_conv3(a, b, 2, bias=True), _gn(b), nn.ReLU())
            for a, b in zip(outs[:-1], outs[1:])])
        self.final_layer = nn.Sequential(
            Conv2d32(outs[-1], feat_dim, 1, bias=True), _gn(feat_dim),
            nn.ReLU())

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.relu(self.bn2(self.conv2(x)))
        ys = [self.layer1(x)]
        for s in range(2, 2 + self.n_stages):
            trans = getattr(self, f"transition{s - 1}")
            xs = [ys[i] if i < len(ys) and t is None
                  else t(ys[min(i, len(ys) - 1)])
                  for i, t in enumerate(trans)]
            ys = getattr(self, f"stage{s}")(xs)
        y = self.incre_modules[0](ys[0])
        for i, down in enumerate(self.downsamp_modules):
            y = self.incre_modules[i + 1](ys[i + 1]) + down(y)
        return self.final_layer(y).mean(dim=(2, 3))


class CLIFF(nn.Module):
    """CLIFF-HR48 at the published widths by default.  ``img_res`` is the
    square crop the model takes; the trunk reads its middle three quarters
    of columns."""

    compute_dtype = "float32"
    # what the engine reads besides the taps and the crop: the forward takes
    # the box rows, and the camera is projected in the full frame
    box_conditioned = True
    camera = "full_frame"
    retrieval_tap = 0

    def __init__(self, img_res: int = 256, stem_width: int = 64,
                 stage1_blocks: int = 4,
                 widths: Sequence[int] = (48, 96, 192, 384),
                 modules: Sequence[int] = (1, 4, 3), blocks: int = 4,
                 head_widths: Sequence[int] = (32, 64, 128, 256),
                 feat_dim: int = 2048, regressor_dim: int = 1024,
                 n_iter: int = 3, mean_pose=None, mean_shape=None,
                 mean_cam=None):
        super().__init__()
        if img_res % 8:
            raise ValueError(f"img_res={img_res} must be a multiple of 8")
        if not len(widths) == len(modules) + 1 == len(head_widths):
            raise ValueError("CLIFF: one width and one head width a branch, "
                             "one module count a stage after the first")
        self.img_res = img_res
        self.margin = img_res // 8
        self.n_iter = n_iter
        self.gate_tap = 2 * n_iter
        self.encoder = HRNet(stem_width, stage1_blocks, widths, modules,
                             blocks, head_widths, feat_dim)
        self.fc1 = nn.Linear(feat_dim + 3 + NPOSE + 13, regressor_dim)
        self.drop1 = nn.Dropout(0.5)
        self.fc2 = nn.Linear(regressor_dim, regressor_dim)
        self.drop2 = nn.Dropout(0.5)
        self.decpose = nn.Linear(regressor_dim, NPOSE)
        self.decshape = nn.Linear(regressor_dim, 10)
        self.deccam = nn.Linear(regressor_dim, 3)
        _register_mean_params(self, mean_pose, mean_shape, mean_cam)

    def forward(self, x: torch.Tensor, box: torch.Tensor):
        """x: (B, 3, img_res, img_res), ImageNet-normalised; box: (B, 5)."""
        B = x.shape[0]
        with span("model.backbone"):
            xf = self.encoder(x[..., self.margin:x.shape[-1] - self.margin])
        with span("model.head"):
            info = bbox_info(box)
            pose = self.init_pose.expand(B, -1)
            shape = self.init_shape.expand(B, -1)
            cam = self.init_cam.expand(B, -1)
            taps = [xf]
            for _ in range(self.n_iter):
                xc = self.fc1(torch.cat([xf, info, pose, shape, cam], 1))
                taps.append(xc)
                xc = self.fc2(self.drop1(xc))
                taps.append(xc)
                xc = self.drop2(xc)
                pose = self.decpose(xc) + pose
                shape = self.decshape(xc) + shape
                cam = self.deccam(xc) + cam
            rotmat = rot6d_to_rotmat(pose).reshape(B, 24, 3, 3)
        return rotmat, shape, cam, tuple(taps)
