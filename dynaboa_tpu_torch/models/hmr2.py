"""HMR 2.0 (Goel et al., "Humans in 4D", ICCV 2023, arXiv 2305.20091;
github.com/shubham-goel/4D-Humans, experiment ``hmr_vit_transformer``): a
ViTPose-H backbone and a transformer-decoder SMPL head, as a torch
``nn.Module`` that ``BilevelEngine`` drives through ``functional_call``.

Backbone (``hmr2/models/backbones/vit.py:vit()``; ViTPose, Xu et al.,
arXiv 2204.12484): the square crop is cut to its middle three quarters of
columns (256x192 by columns 32:-32 at the published 256), a convolution of
kernel 16, stride 16 and padding 2 embeds it into a 16x12 grid of tokens of
width 1280, the absolute position ``pos_embed[:, 1:] + pos_embed[:, :1]`` is
added, then 32 pre-LayerNorm blocks (eps 1e-6)

    x += proj(softmax((q / sqrt(d)) k^T) v)     16 heads of 80, biased qkv
    x += fc2(GELU(fc1(LN(x))))                  fc1 1280 -> 5120

and a last LayerNorm.  Drop path (0.55 in training) is off: the engine
adapts in eval mode.  The published backbone hands the head its tokens as
an NCHW map that the head flattens back; here the tokens pass as they are.

Head (``hmr2/models/heads/smpl_head.py:SMPLTransformerDecoderHead``,
``components/pose_transformer.py:TransformerDecoder``): one zero token of
width 1 embedded by Linear(1, 1024) plus a learned position, 6 pre-LayerNorm
layers (eps 1e-5) of self-attention (8 heads of 64, ``to_qkv`` without
bias), cross-attention onto the backbone's tokens (``to_q`` 1024 -> 512,
``to_kv`` 1280 -> 1024, no bias, the context not normalised) and a GELU
feed-forward 1024 -> 1024 -> 1024; ``decpose`` (24 x 6D), ``decshape`` (10)
and ``deccam`` (3) are added to the mean parameters, once (one IEF
iteration).  The 6D rotation is read as HMR 2.0 reads it
(``hmr2/utils/geometry.py:rot6d_to_rotmat``): the first three numbers are
the first column, the next three the second.  HMR's reading
(``ops.rotations``) is a row-major (3, 2) matrix, so the identity pose is
(1, 0, 0, 0, 1, 0) here and (1, 0, 0, 1, 0, 0) there.

Parameter and buffer names follow 4D-Humans' ``backbone.*`` / ``smpl_head.*``
layout: ``backbone.patch_embed.proj``, ``backbone.pos_embed``,
``backbone.blocks.N.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}``,
``backbone.last_norm``; ``smpl_head.transformer.{to_token_embedding,
pos_embedding}``, ``smpl_head.transformer.transformer.layers.N.{0,1,2}``
(self-attention, cross-attention, feed-forward, each ``.norm`` and
``.fn``: ``to_qkv``, ``to_q``, ``to_kv``, ``to_out.0``, ``net.0``,
``net.3``), ``smpl_head.{decpose,decshape,deccam}`` and the buffers
``smpl_head.{init_body_pose,init_betas,init_cam}``.  They are written from
the published modules' attribute names; no checkpoint was at hand to check
them against.

``forward`` takes NCHW images (ImageNet-normalised) and returns ``(rotmat
(B, 24, 3, 3), shape (B, 10), cam (B, 3), taps)`` with three taps:

  0: the backbone's tokens after its last LayerNorm (B, N, 1280)
  1: their mean over the tokens (B, 1280), the retrieval key
  2: the decoder's output token (B, 1024), the update gate's signal

The camera is HMR's weak perspective (s, tx, ty), at depth 2 f / (256 s).
Under ``torch.profiler`` the backbone and the head are the spans
``model.backbone`` and ``model.head``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as nnf

from dynaboa_tpu_torch.tracing import span

NPOSE = 24 * 6


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """(..., 6k) -> (N, 3, 3) by Gram-Schmidt, HMR 2.0's reading: numbers
    0-2 are the first column, 3-5 the second."""
    x = x.reshape(-1, 2, 3)
    b1 = nnf.normalize(x[:, 0], dim=-1)
    a2 = x[:, 1]
    b2 = nnf.normalize(a2 - (b1 * a2).sum(-1, keepdim=True) * b1, dim=-1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, N, h d) -> (B, h, N, d)."""
    B, N, _ = x.shape
    return x.reshape(B, N, heads, -1).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    """(B, h, N, d) -> (B, N, h d)."""
    B, h, N, d = x.shape
    return x.transpose(1, 2).reshape(B, N, h * d)


# -- backbone: ViTPose-H --------------------------------------------------------

class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int, padding: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch, padding=padding)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)      # (B, N, dim)


class ViTAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.scale = (dim // heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim, bias=True)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = ((q * self.scale) @ k.transpose(-2, -1)).softmax(dim=-1)
        return self.proj(_merge(attn @ v))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int, eps: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = ViTAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    def __init__(self, grid: tuple[int, int], dim: int, depth: int, heads: int,
                 mlp_ratio: int, patch: int, padding: int, eps: float):
        super().__init__()
        self.patch_embed = PatchEmbed(dim, patch, padding)
        # the pretrained layout keeps a class token's position in row 0
        self.pos_embed = nn.Parameter(torch.zeros(1, grid[0] * grid[1] + 1,
                                                  dim))
        self.blocks = nn.ModuleList([Block(dim, heads, mlp_ratio, eps)
                                     for _ in range(depth)])
        self.last_norm = nn.LayerNorm(dim, eps=eps)

    def forward(self, x):
        x = self.patch_embed(x)
        x = x + self.pos_embed[:, 1:] + self.pos_embed[:, :1]
        for blk in self.blocks:
            x = blk(x)
        return self.last_norm(x)


# -- head: the transformer decoder ---------------------------------------------

class SelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads = heads
        self.scale = dim_head ** -0.5
        self.to_qkv = nn.Linear(dim, 3 * heads * dim_head, bias=False)
        self.to_out = nn.Sequential(nn.Linear(heads * dim_head, dim))

    def forward(self, x):
        q, k, v = (_heads(t, self.heads) for t in self.to_qkv(x).chunk(3, -1))
        attn = (q @ k.transpose(-1, -2) * self.scale).softmax(dim=-1)
        return self.to_out(_merge(attn @ v))


class CrossAttention(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads = heads
        self.scale = dim_head ** -0.5
        self.to_kv = nn.Linear(context_dim, 2 * heads * dim_head, bias=False)
        self.to_q = nn.Linear(dim, heads * dim_head, bias=False)
        self.to_out = nn.Sequential(nn.Linear(heads * dim_head, dim))

    def forward(self, x, context):
        k, v = (_heads(t, self.heads) for t in self.to_kv(context).chunk(2, -1))
        q = _heads(self.to_q(x), self.heads)
        attn = (q @ k.transpose(-1, -2) * self.scale).softmax(dim=-1)
        return self.to_out(_merge(attn @ v))


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        # the published net's dropouts (rate 0) keep their places
        self.net = nn.Sequential(nn.Linear(dim, hidden), nn.GELU(),
                                 nn.Dropout(0.0), nn.Linear(hidden, dim),
                                 nn.Dropout(0.0))

    def forward(self, x):
        return self.net(x)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim)
        self.fn = fn

    def forward(self, x, **kw):
        return self.fn(self.norm(x), **kw)


class TransformerCrossAttn(nn.Module):
    def __init__(self, dim, depth, heads, dim_head, mlp_dim, context_dim):
        super().__init__()
        self.layers = nn.ModuleList([nn.ModuleList([
            PreNorm(dim, SelfAttention(dim, heads, dim_head)),
            PreNorm(dim, CrossAttention(dim, context_dim, heads, dim_head)),
            PreNorm(dim, FeedForward(dim, mlp_dim))]) for _ in range(depth)])

    def forward(self, x, context):
        for self_attn, cross_attn, ff in self.layers:
            x = self_attn(x) + x
            x = cross_attn(x, context=context) + x
            x = ff(x) + x
        return x


class TransformerDecoder(nn.Module):
    def __init__(self, dim, depth, heads, dim_head, mlp_dim, context_dim):
        super().__init__()
        self.to_token_embedding = nn.Linear(1, dim)
        self.pos_embedding = nn.Parameter(torch.zeros(1, 1, dim))
        self.transformer = TransformerCrossAttn(dim, depth, heads, dim_head,
                                                mlp_dim, context_dim)

    def forward(self, token, context):
        x = self.to_token_embedding(token) + self.pos_embedding
        return self.transformer(x, context)


class SMPLTransformerDecoderHead(nn.Module):
    def __init__(self, dim, depth, heads, dim_head, mlp_dim, context_dim,
                 ief_iters: int = 1):
        super().__init__()
        self.ief_iters = ief_iters
        self.transformer = TransformerDecoder(dim, depth, heads, dim_head,
                                              mlp_dim, context_dim)
        self.decpose = nn.Linear(dim, NPOSE)
        self.decshape = nn.Linear(dim, 10)
        self.deccam = nn.Linear(dim, 3)
        pose = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0]).repeat(24)
        self.register_buffer("init_body_pose", pose[None])
        self.register_buffer("init_betas", torch.zeros(1, 10))
        self.register_buffer("init_cam", torch.tensor([[0.9, 0.0, 0.0]]))

    def forward(self, tokens):
        B = tokens.shape[0]
        pose = self.init_body_pose.expand(B, -1)
        shape = self.init_betas.expand(B, -1)
        cam = self.init_cam.expand(B, -1)
        for _ in range(self.ief_iters):
            token = self.transformer(tokens.new_zeros((B, 1, 1)), tokens)[:, 0]
            pose = self.decpose(token) + pose
            shape = self.decshape(token) + shape
            cam = self.deccam(token) + cam
        return rot6d_to_rotmat(pose).reshape(B, 24, 3, 3), shape, cam, token


class HMR2(nn.Module):
    """HMR 2.0 at the published widths by default.  ``img_res`` is the square
    crop the model takes and projects at; the backbone reads its middle
    three quarters of columns."""

    compute_dtype = "float32"
    retrieval_tap = 1
    gate_tap = 2

    def __init__(self, img_res: int = 256, patch_size: int = 16,
                 patch_padding: int = 2, embed_dim: int = 1280,
                 depth: int = 32, num_heads: int = 16, mlp_ratio: int = 4,
                 ln_eps: float = 1e-6, dec_dim: int = 1024,
                 dec_depth: int = 6, dec_heads: int = 8,
                 dec_dim_head: int = 64, dec_mlp_dim: int = 1024,
                 ief_iters: int = 1):
        super().__init__()
        if img_res % 8:
            raise ValueError(f"img_res={img_res} must be a multiple of 8")
        self.img_res = img_res
        self.margin = img_res // 8

        def cells(n):
            return (n + 2 * patch_padding - patch_size) // patch_size + 1

        grid = (cells(img_res), cells(img_res - 2 * self.margin))
        self.backbone = ViT(grid, embed_dim, depth, num_heads, mlp_ratio,
                            patch_size, patch_padding, ln_eps)
        self.smpl_head = SMPLTransformerDecoderHead(
            dec_dim, dec_depth, dec_heads, dec_dim_head, dec_mlp_dim,
            embed_dim, ief_iters)

    def forward(self, x: torch.Tensor):
        """x: (B, 3, img_res, img_res), ImageNet-normalised."""
        with span("model.backbone"):
            tokens = self.backbone(x[..., self.margin:x.shape[-1] - self.margin])
        with span("model.head"):
            rotmat, shape, cam, token = self.smpl_head(tokens)
        return rotmat, shape, cam, (tokens, tokens.mean(dim=1), token)
