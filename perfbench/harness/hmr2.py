"""What the benchmark knows of HMR 2.0 (Goel et al., ICCV 2023, arXiv
2305.20091) from its configuration's ``model`` group alone: the name,
shape and seeded draw of every weight, the regressor's starting point, and
the FLOPs of one forward row by the protocol.  Nothing here reads the
program.

The draw follows the published initialisation as far as it is written
down: the ViT's linear layers and position table truncated-normal with
standard deviation 0.02 (timm's bounds of +-2 lie 100 standard deviations
out, so a plain normal draw), their biases 0; the patch embedding and the
decoder's linear layers PyTorch's default, uniform within +-1 / sqrt(fan
in) for weights and biases; the decoder's position a standard normal (it is
``torch.randn`` there); every LayerNorm (1, 0); the decoder heads
xavier-uniform with gain 0.01 and bias 0.  One normal and one uniform draw
for the whole network.
"""

from __future__ import annotations

import math

import torch

from perfbench.harness.inputs import WEIGHTS, generator
from perfbench.harness.work import NPOSE

# standard deviations of the normal kinds
STD = {"vit_lin": 0.02, "pos": 0.02, "dec_pos": 1.0}


def grid(m: dict) -> tuple[int, int]:
    """The patch grid of the crop's middle three quarters of columns."""
    res, p, pad = m["img_res"], m["patch_size"], m["patch_padding"]

    def cells(n):
        return (n + 2 * pad - p) // p + 1

    return cells(res), cells(res - 2 * (res // 8))


def shapes(m: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, init kind) of every HMR 2.0 parameter, in the order of
    4D-Humans' modules; kinds: ``vit_lin``, ``pos``, ``dec_pos`` (normal),
    ``uniform`` (PyTorch's default, bound from ``fan_in``), ``head``
    (xavier gain 0.01), ``ln_w`` (1), ``zero`` (0)."""
    D, R = m["embed_dim"], m["mlp_ratio"]
    P = m["patch_size"]
    gh, gw = grid(m)
    out = [("backbone.pos_embed", (1, gh * gw + 1, D), "pos"),
           ("backbone.patch_embed.proj.weight", (D, 3, P, P), "uniform"),
           ("backbone.patch_embed.proj.bias", (D,), "uniform")]
    for i in range(m["depth"]):
        b = f"backbone.blocks.{i}"
        out += [(f"{b}.norm1.weight", (D,), "ln_w"),
                (f"{b}.norm1.bias", (D,), "zero"),
                (f"{b}.attn.qkv.weight", (3 * D, D), "vit_lin"),
                (f"{b}.attn.qkv.bias", (3 * D,), "zero"),
                (f"{b}.attn.proj.weight", (D, D), "vit_lin"),
                (f"{b}.attn.proj.bias", (D,), "zero"),
                (f"{b}.norm2.weight", (D,), "ln_w"),
                (f"{b}.norm2.bias", (D,), "zero"),
                (f"{b}.mlp.fc1.weight", (R * D, D), "vit_lin"),
                (f"{b}.mlp.fc1.bias", (R * D,), "zero"),
                (f"{b}.mlp.fc2.weight", (D, R * D), "vit_lin"),
                (f"{b}.mlp.fc2.bias", (D,), "zero")]
    out += [("backbone.last_norm.weight", (D,), "ln_w"),
            ("backbone.last_norm.bias", (D,), "zero")]
    dd, inner = m["dec_dim"], m["dec_heads"] * m["dec_dim_head"]
    t = "smpl_head.transformer"
    out += [(f"{t}.pos_embedding", (1, 1, dd), "dec_pos"),
            (f"{t}.to_token_embedding.weight", (dd, 1), "uniform"),
            (f"{t}.to_token_embedding.bias", (dd,), "uniform")]
    for i in range(m["dec_depth"]):
        L = f"{t}.transformer.layers.{i}"
        for j, mats in enumerate(([("to_qkv", 3 * inner, dd)],
                                  [("to_kv", 2 * inner, D),
                                   ("to_q", inner, dd)],
                                  None)):
            out += [(f"{L}.{j}.norm.weight", (dd,), "ln_w"),
                    (f"{L}.{j}.norm.bias", (dd,), "zero")]
            if mats is None:       # the feed-forward
                h = m["dec_mlp_dim"]
                out += [(f"{L}.2.fn.net.0.weight", (h, dd), "uniform"),
                        (f"{L}.2.fn.net.0.bias", (h,), "uniform"),
                        (f"{L}.2.fn.net.3.weight", (dd, h), "uniform"),
                        (f"{L}.2.fn.net.3.bias", (dd,), "uniform")]
                continue
            out += [(f"{L}.{j}.fn.{name}.weight", (fo, fi), "uniform")
                    for name, fo, fi in mats]
            out += [(f"{L}.{j}.fn.to_out.0.weight", (dd, inner), "uniform"),
                    (f"{L}.{j}.fn.to_out.0.bias", (dd,), "uniform")]
    for name, fo in (("decpose", NPOSE), ("decshape", 10), ("deccam", 3)):
        out += [(f"smpl_head.{name}.weight", (fo, dd), "head"),
                (f"smpl_head.{name}.bias", (fo,), "zero")]
    return out


def _fan_in(name: str, shape: tuple, table: dict) -> int:
    """A weight's fan in; a bias takes its weight's, drawn before it."""
    prefix, leaf = name.rsplit(".", 1)
    if leaf == "weight":
        table[prefix] = math.prod(shape[1:])
    return table[prefix]


def weights(m: dict, seed: int, device) -> dict:
    """Seeded HMR 2.0 weights (module docstring)."""
    sh = shapes(m)
    g = generator(seed, WEIGHTS, device)
    n_normal = sum(math.prod(s) for _, s, k in sh if k in STD)
    n_unif = sum(math.prod(s) for _, s, k in sh if k in ("uniform", "head"))
    normal = torch.randn(n_normal, generator=g, device=device)
    unif = torch.rand(n_unif, generator=g, device=device) * 2.0 - 1.0
    out, i, j, fans = {}, 0, 0, {}
    for name, shape, kind in sh:
        n = math.prod(shape)
        if kind in STD:
            out[name] = (normal[i:i + n] * STD[kind]).reshape(shape)
            i += n
        elif kind == "ln_w":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zero":
            out[name] = torch.zeros(shape, device=device)
        else:
            if kind == "head":
                bound = 0.01 * math.sqrt(6.0 / (shape[0] + shape[1]))
            else:
                bound = 1.0 / math.sqrt(_fan_in(name, shape, fans))
            out[name] = (unif[j:j + n] * bound).reshape(shape)
            j += n
    return out


def mean_params(device) -> tuple:
    """The regressor's starting point: the identity rotation at every joint
    in HMR 2.0's 6D reading (1, 0, 0, 0, 1, 0), zero shape, camera
    (0.9, 0, 0)."""
    pose = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0],
                        device=device).repeat(24)[None]
    return (pose, torch.zeros((1, 10), device=device),
            torch.tensor([[0.9, 0.0, 0.0]], device=device))


def forward_flops(m: dict) -> int:
    """FLOPs (2 per multiply-add) of the linear maps and attention products
    of one HMR 2.0 forward of one image row: the patch embedding; per ViT
    block qkv, q k^T, attention times v, proj, fc1 and fc2; the token
    embedding; per decoder layer self-attention over its one token,
    cross-attention whose keys and values span every backbone token, and
    the feed-forward; the three heads.  Normalisation, softmax, GELU and
    the residual sums are not counted."""
    D, R, P = m["embed_dim"], m["mlp_ratio"], m["patch_size"]
    gh, gw = grid(m)
    N = gh * gw
    macs = N * 3 * P * P * D
    macs += m["depth"] * (N * D * 3 * D + 2 * N * N * D + N * D * D
                          + 2 * N * D * R * D)
    dd, inner, h = m["dec_dim"], m["dec_heads"] * m["dec_dim_head"], \
        m["dec_mlp_dim"]
    per_layer = (dd * 3 * inner + 2 * inner + inner * dd        # self
                 + dd * inner + N * D * 2 * inner + 2 * N * inner
                 + inner * dd                                   # cross
                 + 2 * dd * h)                                  # feed-forward
    macs += m["ief_iters"] * (dd + m["dec_depth"] * per_layer
                              + dd * (NPOSE + 10 + 3))
    return 2 * macs
