"""What the benchmark knows of CLIFF-HR48 (Li et al., ECCV 2022, arXiv
2208.00571; HRNet-W48-C, arXiv 1908.07919) from its configuration's
``model`` group alone: the name, shape and seeded draw of every weight,
every convolution with its output size, the box rows' seeded draws, and
the FLOPs of one forward row by the protocol.  Nothing here reads the
program.

The draw follows the published initialisation: every convolution
kaiming-normal (fan out, ReLU), normal(0, sqrt(2 / (k k out))), as HRNet's
classification ``init_weights`` draws them; the biases of the head's
convolutions, which that leaves alone, and fc1 / fc2 PyTorch's default,
uniform within +-1 / sqrt(fan in); every normalisation (1, 0); the
decoders' weights xavier-uniform with gain 0.01 and their biases PyTorch's
default, as CLIFF's ``cliff.py`` leaves them.  One normal and one uniform
draw for the whole network.  The regressor starts where HMR's does
(``inputs.mean_params``): CLIFF reads the 6D rotation row-major, as HMR
does.
"""

from __future__ import annotations

import math

import torch

from perfbench.harness.inputs import WEIGHTS, generator
from perfbench.harness.work import NPOSE

BOXES = 4        # the frames' boxes: a stream of the seed of their own
STORE_BOXES = 5  # the exemplars' boxes
EXPANSION = 4    # a Bottleneck's output over its planes


def input_size(m: dict) -> tuple[int, int]:
    """The trunk's input: the square crop less an eighth of it each side."""
    res = m["img_res"]
    return res, res - 2 * (res // 8)


def _out(n: int, k: int, s: int) -> int:
    return (n + 2 * (k // 2) - k) // s + 1


class _Walk:
    """The layers in the order the published modules register them: each
    convolution as (name, cin, cout, k, stride, bias, output (h, w)), each
    normalisation as (name, channels)."""

    def __init__(self):
        self.layers = []

    def conv(self, name, cin, cout, k, stride, hw, bias=False):
        out = (_out(hw[0], k, stride), _out(hw[1], k, stride))
        self.layers.append(("conv", name, cin, cout, k, stride, bias, out))
        return out

    def norm(self, name, c):
        self.layers.append(("norm", name, c))

    def conv_norm(self, name, norm, cin, cout, k, stride, hw, bias=False):
        out = self.conv(name, cin, cout, k, stride, hw, bias)
        self.norm(norm, cout)
        return out

    def bottleneck_layer(self, pre, cin, planes, blocks, hw):
        for b in range(blocks):
            p = f"{pre}.{b}"
            c = cin if b == 0 else planes * EXPANSION
            self.conv_norm(f"{p}.conv1", f"{p}.bn1", c, planes, 1, 1, hw)
            self.conv_norm(f"{p}.conv2", f"{p}.bn2", planes, planes, 3, 1, hw)
            self.conv_norm(f"{p}.conv3", f"{p}.bn3", planes,
                           planes * EXPANSION, 1, 1, hw)
            if b == 0:
                self.conv_norm(f"{p}.downsample.0", f"{p}.downsample.1", c,
                               planes * EXPANSION, 1, 1, hw)
        return planes * EXPANSION

    def down(self, pre, cin, cout, hw):
        return self.conv_norm(f"{pre}.0", f"{pre}.1", cin, cout, 3, 2, hw)


def walk(m: dict) -> list:
    """Every layer of one CLIFF forward at the configuration's sizes."""
    w = _Walk()
    e = "encoder"
    hw = input_size(m)
    s = m["stem_width"]
    hw = w.conv_norm(f"{e}.conv1", f"{e}.bn1", 3, s, 3, 2, hw)
    hw = w.conv_norm(f"{e}.conv2", f"{e}.bn2", s, s, 3, 2, hw)
    pre = [w.bottleneck_layer(f"{e}.layer1", s, s, m["stage1_blocks"], hw)]
    sizes = [hw]
    widths = m["widths"]
    for st, n_mod in enumerate(m["modules"], start=2):
        cur = widths[:st]
        t = f"{e}.transition{st - 1}"
        for i, c in enumerate(cur):
            if i < len(pre):
                if pre[i] != c:
                    w.conv_norm(f"{t}.{i}.0", f"{t}.{i}.1", pre[i], c, 3, 1,
                                sizes[i])
            else:
                sizes.append(w.down(f"{t}.{i}.0", pre[-1], c, sizes[-1]))
        for mod in range(n_mod):
            p = f"{e}.stage{st}.{mod}"
            for i, c in enumerate(cur):
                for b in range(m["blocks"]):
                    q = f"{p}.branches.{i}.{b}"
                    w.conv_norm(f"{q}.conv1", f"{q}.bn1", c, c, 3, 1, sizes[i])
                    w.conv_norm(f"{q}.conv2", f"{q}.bn2", c, c, 3, 1, sizes[i])
            for i in range(len(cur)):
                for j in range(len(cur)):
                    q = f"{p}.fuse_layers.{i}.{j}"
                    if j > i:
                        w.conv_norm(f"{q}.0", f"{q}.1", cur[j], cur[i], 1, 1,
                                    sizes[j])
                    elif j < i:
                        hw = sizes[j]
                        for k in range(i - j):
                            hw = w.down(f"{q}.{k}", cur[j],
                                        cur[i] if k == i - j - 1 else cur[j],
                                        hw)
        pre = list(cur)
    outs = []
    for i, (c, h) in enumerate(zip(widths, m["head_widths"])):
        outs.append(w.bottleneck_layer(f"{e}.incre_modules.{i}", c, h, 1,
                                       sizes[i]))
    for i in range(len(outs) - 1):
        w.conv_norm(f"{e}.downsamp_modules.{i}.0",
                    f"{e}.downsamp_modules.{i}.1", outs[i], outs[i + 1], 3,
                    2, sizes[i], bias=True)
    w.conv_norm(f"{e}.final_layer.0", f"{e}.final_layer.1", outs[-1],
                m["feat_dim"], 1, 1, sizes[-1], bias=True)
    return w.layers


def shapes(m: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, init kind) of every CLIFF parameter, in the order of
    the published modules; kinds: ``conv`` (kaiming normal), ``uniform``
    (PyTorch's default, bound from the fan in), ``head`` (xavier gain
    0.01), ``ones``, ``zero``."""
    out = []
    for layer in walk(m):
        if layer[0] == "conv":
            _, name, cin, cout, k, _, bias, _ = layer
            out.append((f"{name}.weight", (cout, cin, k, k), "conv"))
            if bias:
                out.append((f"{name}.bias", (cout,), "uniform"))
        else:
            _, name, c = layer
            out += [(f"{name}.weight", (c,), "ones"),
                    (f"{name}.bias", (c,), "zero")]
    R = m["regressor_dim"]
    for name, fi, fo, kind in (("fc1", m["feat_dim"] + 3 + NPOSE + 13, R,
                                "uniform"),
                               ("fc2", R, R, "uniform"),
                               ("decpose", R, NPOSE, "head"),
                               ("decshape", R, 10, "head"),
                               ("deccam", R, 3, "head")):
        out += [(f"{name}.weight", (fo, fi), kind),
                (f"{name}.bias", (fo,), "uniform")]
    return out


def _fan_in(name: str, shape: tuple, table: dict) -> int:
    """A weight's fan in; a bias takes its weight's, drawn before it."""
    prefix, leaf = name.rsplit(".", 1)
    if leaf == "weight":
        table[prefix] = math.prod(shape[1:])
    return table[prefix]


def weights(m: dict, seed: int, device) -> dict:
    """Seeded CLIFF weights (module docstring)."""
    sh = shapes(m)
    g = generator(seed, WEIGHTS, device)
    n_normal = sum(math.prod(s) for _, s, k in sh if k == "conv")
    n_unif = sum(math.prod(s) for _, s, k in sh if k in ("uniform", "head"))
    normal = torch.randn(n_normal, generator=g, device=device)
    unif = torch.rand(n_unif, generator=g, device=device) * 2.0 - 1.0
    out, i, j, fans = {}, 0, 0, {}
    for name, shape, kind in sh:
        n = math.prod(shape)
        fan = _fan_in(name, shape, fans)
        if kind == "conv":
            std = math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
            out[name] = (normal[i:i + n] * std).reshape(shape)
            i += n
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zero":
            out[name] = torch.zeros(shape, device=device)
        else:
            if kind == "head":
                bound = 0.01 * math.sqrt(6.0 / (shape[0] + shape[1]))
            else:
                bound = 1.0 / math.sqrt(fan)
            out[name] = (unif[j:j + n] * bound).reshape(shape)
            j += n
    return out


def conv_flops(m: dict) -> int:
    """FLOPs (2 per multiply-add) of the convolutions of one CLIFF forward
    of one image row."""
    return 2 * sum(cin * cout * k * k * hw[0] * hw[1]
                   for kind, _, cin, cout, k, _, _, hw in
                   (x for x in walk(m) if x[0] == "conv"))


def norm_elements(m: dict) -> int:
    """Elements the normalisations of one forward of one image row
    normalise: each convolution's output."""
    return sum(cout * hw[0] * hw[1] for kind, _, _, cout, _, _, _, hw in
               (x for x in walk(m) if x[0] == "conv"))


def forward_flops(m: dict) -> int:
    """FLOPs (2 per multiply-add) of the convolutions and linear layers of
    one CLIFF forward of one image row: the trunk's convolutions, then
    ``n_iter`` regressor iterations.  Normalisation, activations, the
    upsampling, the sums, the biases and the pooling are not counted."""
    R = m["regressor_dim"]
    per_iter = ((m["feat_dim"] + 3 + NPOSE + 13) * R + R * R
                + R * (NPOSE + 10 + 3))
    return conv_flops(m) + 2 * m["n_iter"] * per_iter


def boxes(n: int, spec: dict, g: torch.Generator, device) -> torch.Tensor:
    """(n, 5) box rows ``(cx, cy, b, w, h)`` in a frame of ``spec["width"]``
    x ``spec["height"]`` pixels: centres uniform over its central
    ``spec["centre_share"]`` in x and y, sizes uniform in
    ``spec["size"]``."""
    w, h = float(spec["width"]), float(spec["height"])
    share = float(spec["centre_share"])
    lo, hi = spec["size"]
    u = torch.rand((n, 3), generator=g, device=device)
    cx = w * (0.5 + share * (u[:, 0] - 0.5))
    cy = h * (0.5 + share * (u[:, 1] - 0.5))
    b = lo + (hi - lo) * u[:, 2]
    return torch.stack([cx, cy, b, torch.full_like(b, w),
                        torch.full_like(b, h)], -1)


def store_boxes(spec: dict, seed: int, device) -> torch.Tensor:
    """One box per exemplar of the seeded store (``spec`` is the
    configuration's ``store`` group, its ``boxes`` the frame and box
    ranges of the H36M-style exemplars)."""
    n = spec["clusters"] * spec["per_cluster"]
    return boxes(n, spec["boxes"], generator(seed, STORE_BOXES, device),
                 device)
