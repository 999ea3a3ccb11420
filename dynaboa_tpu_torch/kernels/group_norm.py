"""GroupNorm through the hand-written Hopper kernel ``csrc/group_norm.cu``.

It replaces no TPU kernel (the JAX package's GroupNorm is Flax's).  On the
card ATen runs a GroupNorm as three kernels, the first of which gives one
block to each (image, group) row: 4 to 12 blocks for HMR's ResNet-50 at
N = 1 to 3.  The kernel does the statistics and the affine in one launch,
splitting each row over a thread-block cluster (the note in the ``.cu``
file says how), and writes ``mean`` and ``rstd`` as (N, G) for the
backward.

What bounds it on the H100: reading x once and writing y once, 8 B per
element; 88.9 MB for the 53 GroupNorms of one 224^2 image row, 26.5 us at
the data sheet's 3.35 TB/s (derived, not measured).  Measured times are in
the root PERF.md.

``group_norm`` dispatches on the device of its input: a CPU tensor takes
``torch.nn.functional.group_norm``, as before the kernel existed; a CUDA
tensor launches the kernel or raises.  On the card the gradient is a
``torch.autograd.Function`` whose backward is ATen's
``native_group_norm_backward``, fed the kernel's ``mean`` and ``rstd``.
``group_norm_plain`` is the kernel's arithmetic in plain PyTorch.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as nnf

MAX_CLUSTER = 16        # CTAs of one row; above 8 needs the non-portable size
MAX_THREADS = 512       # threads per CTA (the kernel's launch bound)
PER_THREAD = 8          # float4s a thread holds at most
MAX_GROUP = MAX_CLUSTER * MAX_THREADS * PER_THREAD * 4   # floats of a row
SLICE = 6_272           # floats a CTA of a large row aims at (25 KB)
RESIDENT_CTAS = 264     # two CTAs on each of the H100's 132 SMs

_built = {}     # the loaded library, built at the first CUDA launch
_ready = set()  # devices whose cluster attribute is set


def library(device_index: int = 0):
    """Build (at first use) and load the kernel's shared library, and set
    its cluster attribute on the device (once, outside any capture)."""
    if "group_norm" not in _built:
        from dynaboa_tpu_torch.kernels.build import build

        b = build("group_norm")
        fn = b.lib.dynaboa_group_norm_forward
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        b.lib.dynaboa_group_norm_init.argtypes = [ctypes.c_int]
        b.lib.dynaboa_group_norm_init.restype = ctypes.c_int
        _built["group_norm"] = b
    b = _built["group_norm"]
    if device_index not in _ready:
        err = b.lib.dynaboa_group_norm_init(device_index)
        if err != 0:
            raise RuntimeError(f"group_norm kernel set-up failed with CUDA "
                               f"error {err}")
        _ready.add(device_index)
    return b


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(n: int, c: int, groups: int, hw: int) -> tuple[int, int]:
    """``(cluster, threads)`` for an (n, c, hw) input: a row of E = c /
    groups * hw floats spreads over the power of two of CTAs that gives
    each about ``SLICE`` floats (at most ``MAX_CLUSTER``), fewer where the
    n * groups rows would not all be resident and fewer CTAs still hold a
    row."""
    E = c // groups * hw
    if E > MAX_GROUP:
        raise ValueError(f"group_norm: a group of {E} elements is more than "
                         f"the kernel's {MAX_GROUP}")
    cluster = 1
    while cluster < MAX_CLUSTER and cluster * SLICE < E:
        cluster *= 2
    while (cluster > 1 and n * groups * cluster > RESIDENT_CTAS
           and threads_for(E, cluster // 2) <= MAX_THREADS):
        cluster //= 2
    return cluster, threads_for(E, cluster)


def threads_for(E: int, cluster: int) -> int:
    """The threads of a CTA that holds its share of a row of E floats split
    over ``cluster`` CTAs, ``PER_THREAD`` float4s a thread (a warp at
    least)."""
    f4 = _cdiv(_cdiv(E, 4), cluster)             # float4s of one CTA
    return max(32, 32 * _cdiv(_cdiv(f4, PER_THREAD), 32))


def group_norm_plain(x, num_groups: int, weight=None, bias=None,
                     eps: float = 1e-5):
    """The kernel's arithmetic in plain PyTorch: ``(y, mean, rstd)`` with
    mean and rstd (N, G), the variance biased and centred (two passes)."""
    N, C = x.shape[:2]
    xr = x.reshape(N, num_groups, -1)
    mean = xr.mean(-1)
    rstd = torch.rsqrt((xr - mean[..., None]).square().mean(-1) + eps)
    scale = rstd.repeat_interleave(C // num_groups, 1)            # (N, C)
    if weight is not None:
        scale = scale * weight
    shift = (torch.zeros((C,), dtype=x.dtype, device=x.device)
             if bias is None else bias)
    xc = x.reshape(N, C, -1) - mean.repeat_interleave(C // num_groups,
                                                      1)[..., None]
    y = torch.addcmul(shift[:, None], xc, scale[..., None])
    return y.reshape(x.shape), mean, rstd


def _check(x, num_groups, weight, bias):
    if x.dtype != torch.float32:
        raise TypeError(f"group_norm: x must be float32, got {x.dtype}")
    if x.dim() < 2 or x.numel() == 0:
        raise ValueError(f"group_norm: x of shape {tuple(x.shape)}, expected "
                         f"(N, C, ...) with elements")
    C = x.shape[1]
    if num_groups <= 0 or C % num_groups:
        raise ValueError(f"group_norm: {C} channels do not split into "
                         f"{num_groups} groups")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"group_norm: {name} must be float32, got "
                            f"{t.dtype}")
        if t.device != x.device:
            raise ValueError(f"group_norm: {name} is on {t.device}, x on "
                             f"{x.device}")
        if tuple(t.shape) != (C,) or not t.is_contiguous():
            raise ValueError(f"group_norm: {name} must be contiguous of "
                             f"shape ({C},), got {tuple(t.shape)}")


def launch(x, num_groups: int, weight, bias, eps: float, stats: bool = True):
    """One launch on a contiguous float32 CUDA ``x``: ``(y, mean, rstd)``,
    mean and rstd (N, G) float32 (None unless ``stats``), with the geometry
    ``plan`` picks from the shape."""
    dev = x.device
    N, C = x.shape[:2]
    hw = x.numel() // (N * C)
    cluster, threads = plan(N, C, num_groups, hw)
    y = torch.empty_like(x)
    mean = rstd = None
    if stats:
        mean = torch.empty((N, num_groups), dtype=torch.float32, device=dev)
        rstd = torch.empty((N, num_groups), dtype=torch.float32, device=dev)
    err = library(dev.index).lib.dynaboa_group_norm_forward(
        x.data_ptr(), None if weight is None else weight.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(),
        None if mean is None else mean.data_ptr(),
        None if rstd is None else rstd.data_ptr(), N, C, num_groups, hw,
        eps, cluster, threads, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"group_norm kernel launch failed with CUDA error "
                           f"{err} (N={N}, C={C}, G={num_groups}, HW={hw}, "
                           f"{cluster} CTAs of {threads} threads a row)")
    return y, mean, rstd


class GroupNormFunction(torch.autograd.Function):
    """The kernel's forward; ATen's GroupNorm backward on its statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps):
        y, mean, rstd = launch(x, num_groups, weight, bias, eps)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.num_groups = num_groups
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        N, C = x.shape[:2]
        dx, dw, db = torch.ops.aten.native_group_norm_backward(
            dy.contiguous(), x, mean, rstd, weight, N, C,
            x.numel() // (N * C), ctx.num_groups,
            list(ctx.needs_input_grad[:3]))
        return dx, dw, db, None, None


def group_norm(x, num_groups: int, weight=None, bias=None, eps: float = 1e-5):
    """GroupNorm of x (N, C, ...) over ``num_groups`` groups with the
    per-channel affine ``weight`` and ``bias``.  CPU tensors take
    ``torch.nn.functional.group_norm``; CUDA tensors launch the kernel (on
    an input made contiguous, as ATen's GroupNorm makes it on the card)."""
    dev = x.device
    if dev.type == "cpu":
        return nnf.group_norm(x, num_groups, weight, bias, eps)
    if dev.type != "cuda":
        raise ValueError(f"group_norm: no kernel for device {dev}")
    _check(x, num_groups, weight, bias)
    x = x.contiguous()
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias)):
        y = GroupNormFunction.apply(x, weight, bias, num_groups, eps)
    else:
        y = launch(x, num_groups, weight, bias, eps, stats=False)[0]
    group_norm.launches += 1
    return y


group_norm.launches = 0   # kernel launches by this wrapper (CUDA path only)
