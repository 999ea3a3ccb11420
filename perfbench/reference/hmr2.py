"""Plain HMR 2.0 forward: the ViTPose-H backbone and the transformer-decoder
SMPL head, as functions of a name -> tensor parameter dict.

A standalone statement of the architecture the system under test runs
(Goel et al., "Humans in 4D", ICCV 2023, arXiv 2305.20091;
github.com/shubham-goel/4D-Humans, ``hmr2/models/backbones/vit.py``,
``heads/smpl_head.py``, ``components/pose_transformer.py``), at the widths
of the configuration's ``model`` group.  Parameter names are 4D-Humans'
(``backbone.*``, ``smpl_head.*``).  Input images are NHWC, square and
ImageNet-normalised.

Backbone: the crop's middle three quarters of columns (256x192 at 256), a
patch convolution (kernel and stride ``patch_size``, padding
``patch_padding``), ``pos_embed[:, 1:] + pos_embed[:, :1]``, ``depth``
pre-LayerNorm blocks (eps ``ln_eps``) of biased-qkv self-attention with q
scaled by 1 / sqrt(head width) before q k^T, and a GELU MLP of
``mlp_ratio`` times the width; a last LayerNorm.  Head: a zero token of
width 1 through Linear(1, dec_dim) plus its position, ``dec_depth``
pre-LayerNorm layers (eps 1e-5) of self-attention, cross-attention onto the
backbone tokens (the context not normalised; q k^T scaled after the
product) and a GELU feed-forward, each added to the token; the pose (24 x
6D), shape and camera heads added to the mean parameters, ``ief_iters``
times.  The 6D rotation is read as HMR 2.0 reads it: numbers 0-2 the first
column, 3-5 the second.

Departures from the published description: drop path (0.55) and the
dropouts (0) are off, since adaptation runs in eval mode; the backbone's
tokens go to the head as (B, N, C) without the published round trip
through an NCHW map, which moves no number.

Returns ``(rotmat (B, 24, 3, 3), shape (B, 10), cam (B, 3), taps)`` with
taps (the tokens after the last LayerNorm, their mean over the tokens, the
decoder's output token): the mean is the retrieval key (tap 1), the
decoder's token the update gate's signal (tap 2).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

RETRIEVAL_TAP = 1
GATE_TAP = 2
DEC_EPS = 1e-5


def _linear(p, name, x, bias=True):
    return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"] if bias else None)


def _ln(p, name, x, eps):
    w = p[f"{name}.weight"]
    return F.layer_norm(x, w.shape, w, p[f"{name}.bias"], eps)


def _split_heads(x, h):
    B, N, _ = x.shape
    return x.reshape(B, N, h, -1).permute(0, 2, 1, 3)


def _join_heads(x):
    B, h, N, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(B, N, h * d)


def rot6d_to_rotmat(x):
    """(..., 6k) -> (N, 3, 3); numbers 0-2 the first column, 3-5 the
    second, Gram-Schmidt, the third column their cross product."""
    x = x.reshape(-1, 6)
    a1, a2 = x[:, :3], x[:, 3:]
    b1 = a1 / torch.clamp(torch.linalg.vector_norm(a1, dim=-1, keepdim=True),
                          min=1e-12)
    u = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = u / torch.clamp(torch.linalg.vector_norm(u, dim=-1, keepdim=True),
                         min=1e-12)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], dim=-1)


def backbone(p, x, m):
    """x (B, 3, H, W) -> tokens (B, N, embed_dim)."""
    c = m["img_res"] // 8
    x = x[:, :, :, c:x.shape[3] - c]
    x = F.conv2d(x, p["backbone.patch_embed.proj.weight"],
                 p["backbone.patch_embed.proj.bias"], m["patch_size"],
                 m["patch_padding"])
    x = x.flatten(2).transpose(1, 2)
    pos = p["backbone.pos_embed"]
    x = x + pos[:, 1:] + pos[:, :1]
    h, eps = m["num_heads"], m["ln_eps"]
    scale = (m["embed_dim"] // h) ** -0.5
    for i in range(m["depth"]):
        b = f"backbone.blocks.{i}"
        y = _ln(p, f"{b}.norm1", x, eps)
        q, k, v = (_split_heads(t, h) for t in
                   _linear(p, f"{b}.attn.qkv", y).chunk(3, dim=-1))
        a = torch.softmax((q * scale) @ k.transpose(-2, -1), dim=-1)
        x = x + _linear(p, f"{b}.attn.proj", _join_heads(a @ v))
        y = _ln(p, f"{b}.norm2", x, eps)
        x = x + _linear(p, f"{b}.mlp.fc2",
                        F.gelu(_linear(p, f"{b}.mlp.fc1", y)))
    return _ln(p, "backbone.last_norm", x, eps)


def _attend(p, name, q_in, kv_in, h, scale, cross):
    if cross:
        k, v = _linear(p, f"{name}.to_kv", kv_in, False).chunk(2, dim=-1)
        q = _linear(p, f"{name}.to_q", q_in, False)
    else:
        q, k, v = _linear(p, f"{name}.to_qkv", q_in, False).chunk(3, dim=-1)
    q, k, v = (_split_heads(t, h) for t in (q, k, v))
    a = torch.softmax((q @ k.transpose(-2, -1)) * scale, dim=-1)
    return _linear(p, f"{name}.to_out.0", _join_heads(a @ v))


def head(p, tokens, m, init_pose, init_shape, init_cam):
    """tokens (B, N, embed_dim) -> rotmat, shape, cam, decoder token."""
    B = tokens.shape[0]
    t = "smpl_head.transformer"
    h, scale = m["dec_heads"], m["dec_dim_head"] ** -0.5
    pose = init_pose.expand(B, -1)
    shape = init_shape.expand(B, -1)
    cam = init_cam.expand(B, -1)
    for _ in range(m["ief_iters"]):
        x = _linear(p, f"{t}.to_token_embedding",
                    torch.zeros((B, 1, 1), device=tokens.device))
        x = x + p[f"{t}.pos_embedding"]
        for i in range(m["dec_depth"]):
            L = f"{t}.transformer.layers.{i}"
            x = x + _attend(p, f"{L}.0.fn", _ln(p, f"{L}.0.norm", x, DEC_EPS),
                            None, h, scale, False)
            x = x + _attend(p, f"{L}.1.fn", _ln(p, f"{L}.1.norm", x, DEC_EPS),
                            tokens, h, scale, True)
            y = _ln(p, f"{L}.2.norm", x, DEC_EPS)
            x = x + _linear(p, f"{L}.2.fn.net.3",
                            F.gelu(_linear(p, f"{L}.2.fn.net.0", y)))
        token = x[:, 0]
        pose = _linear(p, "smpl_head.decpose", token) + pose
        shape = _linear(p, "smpl_head.decshape", token) + shape
        cam = _linear(p, "smpl_head.deccam", token) + cam
    return rot6d_to_rotmat(pose).reshape(B, 24, 3, 3), shape, cam, token


def forward(p, image, m, init_pose, init_shape, init_cam):
    """image (B, H, W, 3) -> rotmat, shape, cam, (tokens, token mean,
    decoder token)."""
    tokens = backbone(p, image.permute(0, 3, 1, 2), m)
    rotmat, shape, cam, token = head(p, tokens, m, init_pose, init_shape,
                                     init_cam)
    return rotmat, shape, cam, (tokens, tokens.mean(dim=1), token)
