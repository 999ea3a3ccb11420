"""HMR: ResNet-50 (GroupNorm) backbone + iterative SMPL-parameter regressor,
as a torch ``nn.Module`` (counterpart of ``dynaboa_tpu/models/hmr.py``).

Parameter names are the reference checkpoint's (``conv1``, ``bn1``,
``layerL.B.convI`` / ``bnI``, ``layerL.0.downsample.{0,1}``, ``fc1``,
``fc2``, ``decpose``, ``decshape``, ``deccam``), so a ``basemodel.pt``
state_dict loads directly once its ``module.`` prefix is stripped.

``forward`` takes NCHW images and returns ``(rotmat (B,24,3,3), shape
(B,10), cam (B,3), features)`` with the 15-tap feature contract:

  0: conv1 output (pre-GN)      1-4: layer1..layer4 outputs (NCHW)
  5: pooled feature xf          6+3i, 7+3i, 8+3i (i in 0..2):
                                fc1-out, post-dropout1, fc2-out per iteration

Tap 5 feeds retrieval; tap 12 is the dynamic-BOA convergence signal.  The
SMPL mean parameters are buffers, so they are neither adapted nor in the
parameter dict the engine differentiates.

``compute_dtype="bfloat16"`` runs the backbone's convolutions (``conv1``
through ``layer4``) under ``torch.autocast`` in bfloat16, as the JAX model's
``compute_dtype`` does: tap 0 (a convolution's output) is bfloat16, GroupNorm
and everything after it float32.  The regressor runs outside autocast, in
float32 like the JAX model's ``nn.Dense`` layers; parameters, gradients and
every update stay float32.  On a card the float32 convolutions
(``Conv2d32``) run as the Hopper kernel ``kernels/conv.py`` and the
GroupNorms as ``kernels/group_norm.py``; under autocast the convolutions
stay ATen's.

``HMRISO`` is the dual-head variant with a BatchNorm backbone (fp32 only);
``iso_params_from_jax`` carries the JAX package's HMRISO variables across.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
import torch.nn as nn

from dynaboa_tpu_torch.kernels.conv import conv2d
from dynaboa_tpu_torch.kernels.group_norm import group_norm
from dynaboa_tpu_torch.ops.rotations import rot6d_to_rotmat

NPOSE = 24 * 6
_MEAN_KEYS = ("init_pose", "init_shape", "init_cam")
COMPUTE_DTYPES = ("float32", "bfloat16")


class GroupNorm32(nn.GroupNorm):
    """GroupNorm computed in float32 whatever its input's dtype.  Autocast
    keeps ``group_norm`` in float32 on the card but not on the CPU, so the
    cast is made here, as the JAX GroupNorm reduces a bfloat16 input in
    float32.  On a card it runs as the Hopper kernel
    ``kernels/group_norm.py``; on the CPU as ``nnf.group_norm``."""

    def forward(self, x):
        return group_norm(x.float(), self.num_groups, self.weight, self.bias,
                          self.eps)


class Conv2d32(nn.Conv2d):
    """A convolution that runs in float32 on a card as the Hopper kernel
    ``kernels/conv.py`` (its backward is ATen's), on the CPU as
    ``nnf.conv2d``.  Under autocast it is ``nn.Conv2d`` itself, so the
    bfloat16 arm's arithmetic is ATen's, as before.  A bias (HMR's
    convolutions have none; CLIFF's head has four) is added after the
    convolution."""

    def forward(self, x):
        if torch.is_autocast_enabled(x.device.type):
            return super().forward(x)
        y = conv2d(x, self.weight, None, self.stride, self.padding,
                   self.dilation, self.groups)
        return y if self.bias is None else y + self.bias[:, None, None]


def _gn(channels: int) -> nn.GroupNorm:
    # GroupNorm(4 groups), eps 1e-5
    return GroupNorm32(4, channels, eps=1e-5)


def _bn(channels: int) -> nn.BatchNorm2d:
    # BatchNorm, eps 1e-5; HMRISO runs it in eval() on running statistics
    return nn.BatchNorm2d(channels, eps=1e-5)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: nn.Module | None = None, norm=_gn,
                 conv=Conv2d32):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 1, bias=False)
        self.bn1 = norm(planes)
        self.conv2 = conv(planes, planes, 3, stride=stride, padding=1,
                          bias=False)
        self.bn2 = norm(planes)
        self.conv3 = conv(planes, planes * 4, 1, bias=False)
        self.bn3 = norm(planes * 4)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(out + residual)


def _register_mean_params(module: nn.Module, mean_pose, mean_shape,
                          mean_cam) -> None:
    """The SMPL mean parameters as (1, n) buffers ``init_pose``,
    ``init_shape`` and ``init_cam``."""
    for name, v, default in (("init_pose", mean_pose, np.zeros(NPOSE)),
                             ("init_shape", mean_shape, np.zeros(10)),
                             ("init_cam", mean_cam, [0.9, 0.0, 0.0])):
        a = np.asarray(default if v is None else v, np.float32)
        module.register_buffer(name, torch.as_tensor(a.reshape(1, -1)))


def _make_layer(net: nn.Module, planes: int, blocks: int, stride: int,
                norm, conv) -> nn.Sequential:
    """One ResNet stage; its first block downsamples. ``net.inplanes``
    carries the channel count from stage to stage."""
    downsample = nn.Sequential(
        conv(net.inplanes, planes * 4, 1, stride=stride, bias=False),
        norm(planes * 4))
    mods = [Bottleneck(net.inplanes, planes, stride, downsample, norm, conv)]
    net.inplanes = planes * 4
    mods += [Bottleneck(net.inplanes, planes, norm=norm, conv=conv)
             for _ in range(1, blocks)]
    return nn.Sequential(*mods)


class HMR(nn.Module):
    # what the engine reads of the model: the crop it projects at (the
    # pixels of the weak-perspective camera, whatever size the input has),
    # the retrieval feature's tap and the update gate's tap
    img_res = 224
    retrieval_tap = 5
    gate_tap = 12

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 regressor_dim: int = 1024, n_iter: int = 3,
                 mean_pose=None, mean_shape=None, mean_cam=None,
                 compute_dtype: str = "float32"):
        super().__init__()
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype={compute_dtype!r}, expected one "
                             f"of {COMPUTE_DTYPES}")
        self.compute_dtype = compute_dtype
        self.layers_cfg = tuple(layers)
        self.width = width
        self.regressor_dim = regressor_dim
        self.n_iter = n_iter
        w = width
        self.conv1 = Conv2d32(3, w, 7, stride=2, padding=3, bias=False)
        self.bn1 = _gn(w)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.inplanes = w
        self.layer1 = _make_layer(self, w, layers[0], 1, _gn, Conv2d32)
        self.layer2 = _make_layer(self, 2 * w, layers[1], 2, _gn, Conv2d32)
        self.layer3 = _make_layer(self, 4 * w, layers[2], 2, _gn, Conv2d32)
        self.layer4 = _make_layer(self, 8 * w, layers[3], 2, _gn, Conv2d32)
        feat = 8 * w * Bottleneck.expansion
        self.fc1 = nn.Linear(feat + NPOSE + 13, regressor_dim)
        self.drop1 = nn.Dropout(0.5)
        self.fc2 = nn.Linear(regressor_dim, regressor_dim)
        self.drop2 = nn.Dropout(0.5)
        self.decpose = nn.Linear(regressor_dim, NPOSE)
        self.decshape = nn.Linear(regressor_dim, 10)
        self.deccam = nn.Linear(regressor_dim, 3)
        _register_mean_params(self, mean_pose, mean_shape, mean_cam)

    def forward(self, x: torch.Tensor):
        """x: (B, 3, H, W), ImageNet-normalized."""
        B = x.shape[0]
        features = []
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=self.compute_dtype == "bfloat16"):
            x = self.conv1(x)
            features.append(x)                   # tap 0: pre-GN conv1 out
            x = self.maxpool(self.relu(self.bn1(x)))
            for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
                x = layer(x)
                features.append(x)               # taps 1-4
        xf = x.mean(dim=(2, 3))
        features.append(xf)                      # tap 5: retrieval feature

        pred_pose = self.init_pose.expand(B, -1)
        pred_shape = self.init_shape.expand(B, -1)
        pred_cam = self.init_cam.expand(B, -1)
        for _ in range(self.n_iter):
            xc = torch.cat([xf, pred_pose, pred_shape, pred_cam], dim=1)
            xc = self.fc1(xc)
            features.append(xc)                  # tap 6 + 3i
            xc = self.drop1(xc)
            features.append(xc)                  # tap 7 + 3i
            xc = self.fc2(xc)
            features.append(xc)                  # tap 8 + 3i
            xc = self.drop2(xc)
            pred_pose = self.decpose(xc) + pred_pose
            pred_shape = self.decshape(xc) + pred_shape
            pred_cam = self.deccam(xc) + pred_cam

        rotmat = rot6d_to_rotmat(pred_pose).reshape(B, 24, 3, 3)
        return rotmat, pred_shape, pred_cam, tuple(features)


def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialization of ``HMR`` or ``HMRISO``: convs normal(0,
    sqrt(2 / (kh*kw*out))), the decoder heads xavier-uniform with gain
    0.01, GroupNorm and BatchNorm (1, 0) (running statistics untouched),
    and fc1/fc2 keep PyTorch's default Linear scheme drawn from
    ``generator``."""
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, nn.Conv2d):
                kh, kw = m.kernel_size
                std = float(np.sqrt(2.0 / (kh * kw * m.out_channels)))
                m.weight.normal_(0.0, std, generator=generator)
            elif isinstance(m, (nn.GroupNorm, nn.BatchNorm2d)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Linear):
                fan_in, fan_out = m.in_features, m.out_features
                if name.rsplit(".", 1)[-1] in ("decpose", "decshape",
                                               "deccam"):
                    bound = 0.01 * float(np.sqrt(6.0 / (fan_in + fan_out)))
                    m.weight.uniform_(-bound, bound, generator=generator)
                    m.bias.zero_()
                else:
                    bound = 1.0 / float(np.sqrt(fan_in))
                    m.weight.uniform_(-bound, bound, generator=generator)
                    m.bias.uniform_(-bound, bound, generator=generator)
    return model


def hmr(mean_params_path: str | None = None, **kwargs) -> HMR:
    """ResNet-50 HMR, seeding the regressor from smpl_mean_params.npz when
    a path is given."""
    if mean_params_path:
        mp = np.load(mean_params_path)
        kwargs.setdefault("mean_pose", mp["pose"])
        kwargs.setdefault("mean_shape", mp["shape"])
        kwargs.setdefault("mean_cam", mp["cam"])
    return HMR(**kwargs)


def load_basemodel(path: str, device, compute_dtype: str = "float32") -> HMR:
    """Load the reference ``basemodel.pt`` (a ``model`` key holding a
    possibly ``module.``-prefixed HMR state_dict).  The topology is read
    from the state_dict itself; ``compute_dtype`` as in ``HMR``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = {k.replace("module.", ""): v
             for k, v in ckpt.get("model", ckpt).items()}
    layers = tuple(1 + max(int(k.split(".")[1]) for k in state
                           if k.startswith(f"layer{i}."))
                   for i in (1, 2, 3, 4))
    model = HMR(layers=layers,
                width=int(state["conv1.weight"].shape[0]),
                regressor_dim=int(state["fc1.weight"].shape[0]),
                compute_dtype=compute_dtype)
    missing, unexpected = model.load_state_dict(state, strict=False)
    missing = [k for k in missing if k not in _MEAN_KEYS]
    if missing or unexpected:
        raise KeyError(f"{path}: missing {missing}, unexpected {unexpected}")
    return model.to(device)


def params_from_jax(flax_params: dict[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX package's HMR param pytree -> this module's state_dict.

    The exact inverse of ``dynaboa_tpu.models.hmr.convert_torch_state_dict``
    (unscanned layout): conv HWIO -> OIHW, Dense (in, out) -> (out, in),
    GroupNorm ``scale`` -> ``weight``.  Leaves may be numpy or jax arrays;
    the result holds CPU float32 tensors.
    """
    sd: dict[str, torch.Tensor] = {}

    def t(a):
        return torch.as_tensor(np.array(a, dtype=np.float32))

    def conv(src, dst):
        sd[f"{dst}.weight"] = t(np.transpose(np.asarray(src["kernel"]),
                                             (3, 2, 0, 1)))

    def gn(src, dst):
        sd[f"{dst}.weight"] = t(src["scale"])
        sd[f"{dst}.bias"] = t(src["bias"])

    conv(flax_params["conv1"], "conv1")
    gn(flax_params["gn1"], "bn1")
    for li in (1, 2, 3, 4):
        blocks = sorted(int(k.split("_")[1]) for k in flax_params
                        if k.startswith(f"layer{li}_"))
        for b in blocks:
            src, dst = flax_params[f"layer{li}_{b}"], f"layer{li}.{b}"
            for i in (1, 2, 3):
                conv(src[f"conv{i}"], f"{dst}.conv{i}")
                gn(src[f"gn{i}"], f"{dst}.bn{i}")
            if "down_conv" in src:
                conv(src["down_conv"], f"{dst}.downsample.0")
                gn(src["down_gn"], f"{dst}.downsample.1")
    for name in ("fc1", "fc2", "decpose", "decshape", "deccam"):
        sd[f"{name}.weight"] = t(np.asarray(flax_params[name]["kernel"]).T)
        sd[f"{name}.bias"] = t(flax_params[name]["bias"])
    return sd


class _RegressorHead(nn.Module):
    """One HMRISO head: fc1 -> fc2 -> residual pose/shape/cam decoders,
    iterated from the mean parameters (no dropout)."""

    def __init__(self, feat: int, regressor_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(feat + NPOSE + 13, regressor_dim)
        self.fc2 = nn.Linear(regressor_dim, regressor_dim)
        self.decpose = nn.Linear(regressor_dim, NPOSE)
        self.decshape = nn.Linear(regressor_dim, 10)
        self.deccam = nn.Linear(regressor_dim, 3)

    def forward(self, xf, pose, shape, cam, n_iter: int):
        for _ in range(n_iter):
            xc = self.fc2(self.fc1(torch.cat([xf, pose, shape, cam], dim=1)))
            pose = self.decpose(xc) + pose
            shape = self.decshape(xc) + shape
            cam = self.deccam(xc) + cam
        B = xf.shape[0]
        return rot6d_to_rotmat(pose).reshape(B, 24, 3, 3), shape, cam


class HMRISO(nn.Module):
    """Dual-head HMR (counterpart of ``dynaboa_tpu.models.hmr.HMRISO``): a
    BatchNorm ResNet-50 backbone, meant to run in ``eval()`` on its running
    statistics, a spatial-mean pooled feature, and two regressor heads,
    ``fsl`` (fully supervised) and ``ssl`` (self-supervised).

    ``forward(x, n_iter=None)`` takes NCHW images and returns ``(fsl
    rotmat, fsl shape, fsl cam, ssl rotmat, ssl shape, ssl cam)``.
    """

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 regressor_dim: int = 1024, n_iter: int = 3,
                 mean_pose=None, mean_shape=None, mean_cam=None):
        super().__init__()
        self.layers_cfg = tuple(layers)
        self.n_iter = n_iter
        w = width
        self.conv1 = nn.Conv2d(3, w, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(w)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.inplanes = w
        self.layer1 = _make_layer(self, w, layers[0], 1, _bn, nn.Conv2d)
        self.layer2 = _make_layer(self, 2 * w, layers[1], 2, _bn, nn.Conv2d)
        self.layer3 = _make_layer(self, 4 * w, layers[2], 2, _bn, nn.Conv2d)
        self.layer4 = _make_layer(self, 8 * w, layers[3], 2, _bn, nn.Conv2d)
        feat = 8 * w * Bottleneck.expansion
        self.fsl = _RegressorHead(feat, regressor_dim)
        self.ssl = _RegressorHead(feat, regressor_dim)
        _register_mean_params(self, mean_pose, mean_shape, mean_cam)

    def forward(self, x: torch.Tensor, n_iter: int | None = None):
        """x: (B, 3, H, W), ImageNet-normalized."""
        n_iter = self.n_iter if n_iter is None else n_iter
        B = x.shape[0]
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
        xf = x.mean(dim=(2, 3))
        init = (self.init_pose.expand(B, -1), self.init_shape.expand(B, -1),
                self.init_cam.expand(B, -1))
        return (*self.fsl(xf, *init, n_iter), *self.ssl(xf, *init, n_iter))


def iso_params_from_jax(variables: dict[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX package's HMRISO variables (``params`` and ``batch_stats``,
    flat names such as ``layer2_0_down_conv`` and ``fsl_fc1``) -> this
    module's state_dict entries: conv HWIO -> OIHW, Dense (in, out) ->
    (out, in), BatchNorm ``scale``/``bias``/``mean``/``var`` ->
    ``weight``/``bias``/``running_mean``/``running_var``.  The mean
    parameters and ``num_batches_tracked`` are not among them (load with
    ``strict=False``)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {}

    def t(a):
        return torch.as_tensor(np.array(a, dtype=np.float32))

    def conv(src, dst):
        sd[f"{dst}.weight"] = t(np.transpose(np.asarray(
            params[src]["kernel"]), (3, 2, 0, 1)))

    def bn(src, dst):
        sd[f"{dst}.weight"] = t(params[src]["scale"])
        sd[f"{dst}.bias"] = t(params[src]["bias"])
        sd[f"{dst}.running_mean"] = t(stats[src]["mean"])
        sd[f"{dst}.running_var"] = t(stats[src]["var"])

    conv("conv1", "conv1")
    bn("bn1", "bn1")
    for key in params:
        parts = key.split("_")
        if not (parts[0].startswith("layer") and parts[-1] == "conv1"):
            continue
        src, dst = "_".join(parts[:2]), f"{parts[0]}.{parts[1]}"
        for i in (1, 2, 3):
            conv(f"{src}_conv{i}", f"{dst}.conv{i}")
            bn(f"{src}_bn{i}", f"{dst}.bn{i}")
        if f"{src}_down_conv" in params:
            conv(f"{src}_down_conv", f"{dst}.downsample.0")
            bn(f"{src}_down_bn", f"{dst}.downsample.1")
    for head in ("fsl", "ssl"):
        for name in ("fc1", "fc2", "decpose", "decshape", "deccam"):
            src = params[f"{head}_{name}"]
            sd[f"{head}.{name}.weight"] = t(np.asarray(src["kernel"]).T)
            sd[f"{head}.{name}.bias"] = t(src["bias"])
    return sd
