"""Forward convolution through the hand-written Hopper kernel
``csrc/conv_fprop.cu``.

It replaces no TPU kernel (the JAX package's convolutions are Flax's
``nn.Conv``, which XLA compiles).  On the card cuDNN ran the float32
forward convolutions of HMR's ResNet-50 at about a tenth of the fp32 peak:
at a batch of 1 to 3 images the late layers have few output pixels, and a
tiling that does not split the reduction leaves most of the 132 SMs idle.
The kernel is an fp32 implicit GEMM (FFMA only, no tensor cores) whose
reduction is split over a thread-block cluster; the note in the ``.cu``
file says how.

What bounds it on the H100: the FMA rate.  The 53 convolutions of one
224^2 image row are 8.17 GFLOP, 122 us at the data sheet's 67 TFLOP/s
(derived, not measured); their weights, 93.8 MB, take 28 us at 3.35 TB/s.
Measured times are in the root PERF.md.

``conv2d`` dispatches on the device of its input: a CPU tensor takes
``torch.nn.functional.conv2d``; a float32 CUDA tensor launches the kernel
or raises.  On the card the gradient is a ``torch.autograd.Function`` whose
backward is ATen's ``convolution_backward`` on the saved input and weight,
so the data and weight gradients are cuDNN's, as before.  ``plan`` picks
the tile and the split from the shape alone; ``conv2d_plain`` is the
kernel's arithmetic in plain PyTorch, split as the plan splits it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as nnf
from torch._prims_common import suggest_memory_format

BK = 16                 # depth of a reduction step
STAGES = 4              # slices of A and B in flight
TILES = ((64, 64), (128, 32))   # (BM, BN) of the kernel's instances
MAX_CLUSTER = 16        # CTAs of one tile; above 8 needs the non-portable size
TARGET_CTAS = 200       # about one and a half on each of the H100's 132 SMs
MIN_STEPS = 4           # 16-deep steps a CTA of a split keeps at least
MAX_SMEM = 160 * 1024   # the kernel's dynamic shared-memory attribute

_built = {}     # the loaded library, built at the first CUDA launch
_ready = set()  # devices whose attributes are set
_geoms = {}     # checked launch per (shapes, strides, stride, padding, device)


def library(device_index: int = 0):
    """Build (at first use) and load the kernel's shared library, and set
    its cluster and shared-memory attributes on the device (once, outside
    any capture)."""
    if "conv_fprop" not in _built:
        from dynaboa_tpu_torch.kernels.build import build

        b = build("conv_fprop")
        fn = b.lib.dynaboa_conv_fprop_forward
        fn.argtypes = [ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
        b.lib.dynaboa_conv_fprop_init.argtypes = [ctypes.c_int]
        b.lib.dynaboa_conv_fprop_init.restype = ctypes.c_int
        _built["conv_fprop"] = b
    b = _built["conv_fprop"]
    if device_index not in _ready:
        err = b.lib.dynaboa_conv_fprop_init(device_index)
        if err != 0:
            raise RuntimeError(f"conv_fprop kernel set-up failed with CUDA "
                               f"error {err}")
        _ready.add(device_index)
    return b


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class Plan(NamedTuple):
    bm: int         # output channels of a tile
    bn: int         # output columns (image x pixel) of a tile
    split: int      # CTAs of a cluster, each a contiguous share of C*R*S
    tiles: int      # output tiles
    smem: int       # dynamic shared memory of a CTA, bytes

    @property
    def ctas(self) -> int:
        return self.tiles * self.split


def smem_bytes(bm: int, bn: int, kred: int, split: int, ksize: int) -> int:
    """A CTA's ring of ``STAGES`` slices of A (rows padded by 4) and B, and
    for a kernel larger than 1x1 its gather table, 8 B per reduction index
    of the longest share."""
    ring = 4 * STAGES * (bm * (BK + 4) + BK * bn)
    table = 0 if ksize == 1 else 8 * BK * _cdiv(_cdiv(kred, BK), split)
    return ring + table


def plan(k_out: int, ncol: int, kred: int, ksize: int) -> Plan:
    """The tile and the split for a convolution of ``k_out`` output
    channels, ``ncol`` = N * P * Q output columns and a reduction of
    ``kred`` = C * R * S over a ``ksize`` x ``ksize`` kernel.  The tile is
    the instance that pads the output least (64 x 64 on a tie); the split
    doubles, up to ``MAX_CLUSTER``, while the CTAs fall short of
    ``TARGET_CTAS`` and each CTA keeps ``MIN_STEPS`` steps.  (The constants
    were chosen from the kernel's times on the H100 at ResNet-50's shapes,
    N = 1 and 3, against the neighbouring splits: root PERF.md.)"""
    best = None
    for bm, bn in TILES:
        tm, tn = _cdiv(k_out, bm), _cdiv(ncol, bn)
        if best is None or tm * bm * tn * bn < best[0]:
            best = (tm * bm * tn * bn, bm, bn, tm * tn)
    _, bm, bn, tiles = best
    steps = _cdiv(kred, BK)
    split = 1
    while (split < MAX_CLUSTER and tiles * split < TARGET_CTAS
           and steps // (2 * split) >= MIN_STEPS):
        split *= 2
    smem = smem_bytes(bm, bn, kred, split, ksize)
    if smem > MAX_SMEM:
        raise ValueError(f"conv2d: a reduction of {kred} over {split} CTAs "
                         f"needs {smem} B of shared memory, more than the "
                         f"kernel's {MAX_SMEM}")
    return Plan(bm, bn, split, tiles, smem)


def out_size(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def _out_format(x) -> torch.memory_format:
    # ATen's convolution on the card gives a channels_last output where the
    # input (or the weight, never channels_last here) suggests that layout
    return (torch.channels_last
            if suggest_memory_format(x) == torch.channels_last
            else torch.contiguous_format)


def conv2d_plain(x, weight, stride=(1, 1), padding=(0, 0)):
    """The kernel's arithmetic in plain PyTorch: the reduction C*R*S cut
    into the plan's shares of 16-deep steps, each share's product of the
    weight rows and the gathered (im2col) columns, and the shares summed in
    rank order; the output in the layout the kernel gives."""
    N, C, H, W = x.shape
    K, _, R, S = weight.shape
    P = out_size(H, R, stride[0], padding[0])
    Q = out_size(W, S, stride[1], padding[1])
    kred = C * R * S
    pl = plan(K, N * P * Q, kred, R)
    cols = nnf.unfold(x, (R, S), padding=padding, stride=stride)  # N, CRS, PQ
    a = weight.reshape(K, kred)
    steps = _cdiv(kred, BK)
    y = None
    for rank in range(pl.split):
        lo = rank * steps // pl.split * BK
        hi = min((rank + 1) * steps // pl.split * BK, kred)
        part = a[:, lo:hi] @ cols[:, lo:hi]
        y = part if y is None else y + part
    return y.reshape(N, K, P, Q).contiguous(memory_format=_out_format(x))


class _Launch(NamedTuple):
    ints: ctypes.Array      # the C entry's geometry (see conv_fprop.cu)
    shape: tuple            # the output's (N, K, P, Q)
    fmt: torch.memory_format
    fn: ctypes._CFuncPtr    # the loaded library's entry


def _geometry(x, weight, stride, padding) -> _Launch:
    """The launch of a float32 CUDA ``x`` and ``weight``, checked and
    planned once per shape, strides and device and cached, so that a call
    costs a dictionary lookup, one ``torch.empty`` and one ctypes call."""
    key = (x.shape, x.stride(), weight.shape, stride, padding,
           x.get_device())
    g = _geoms.get(key)
    if g is None:
        if x.dim() != 4 or weight.dim() != 4 or x.shape[1] != weight.shape[1]:
            raise ValueError(f"conv2d: x {tuple(x.shape)} and weight "
                             f"{tuple(weight.shape)}, expected (N, C, H, W) "
                             f"and (K, C, R, S)")
        N, C, H, W = x.shape
        K, _, R, S = weight.shape
        if R != S or stride[0] != stride[1] or padding[0] != padding[1]:
            raise ValueError(f"conv2d: a square kernel, stride and padding "
                             f"only, got {R}x{S}, {stride}, {padding}")
        P = out_size(H, R, stride[0], padding[0])
        Q = out_size(W, S, stride[1], padding[1])
        if P <= 0 or Q <= 0 or x.numel() == 0:
            raise ValueError(f"conv2d: no output for x {tuple(x.shape)}")
        span = sum((n - 1) * s for n, s in zip(x.shape, x.stride())) + 1
        if max(span, N * K * P * Q, weight.numel()) >= 2 ** 31:
            raise ValueError("conv2d: the kernel indexes with 32-bit ints")
        fmt = _out_format(x)
        pl = plan(K, N * P * Q, C * R * S, R)
        ints = (x.get_device(), N, C, H, W, K, P, Q, R, S, stride[0],
                padding[0], *x.stride(), int(fmt == torch.channels_last),
                pl.bm, pl.split)
        g = _Launch((ctypes.c_int * len(ints))(*ints), (N, K, P, Q), fmt,
                    library(x.get_device()).lib.dynaboa_conv_fprop_forward)
        _geoms[key] = g
    return g


def launch(x, weight, stride, padding):
    """One launch on a float32 CUDA ``x`` (any strides) and ``weight``: the
    output, in the memory format ATen's convolution gives for ``x``."""
    g = _geometry(x, weight, stride, padding)
    weight = weight.contiguous()
    dev = x.get_device()
    y = torch.empty(g.shape, dtype=torch.float32, device=dev,
                    memory_format=g.fmt)
    err = g.fn(x.data_ptr(), weight.data_ptr(), y.data_ptr(), g.ints,
               torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"conv_fprop kernel launch failed with CUDA error "
                           f"{err} (x {tuple(x.shape)} strides {x.stride()}, "
                           f"weight {tuple(weight.shape)}, stride {stride}, "
                           f"padding {padding})")
    return y


class Conv2dFunction(torch.autograd.Function):
    """The kernel's forward; ATen's convolution backward on the saved input
    and weight, with the output mask autograd asks for."""

    @staticmethod
    def forward(ctx, x, weight, stride, padding):
        ctx.save_for_backward(x, weight)
        ctx.geometry = (stride, padding)
        return launch(x, weight, stride, padding)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        stride, padding = ctx.geometry
        dx, dw, _ = torch.ops.aten.convolution_backward(
            dy, x, weight, None, list(stride), list(padding), [1, 1], False,
            [0, 0], 1, [*ctx.needs_input_grad[:2], False])
        return dx, dw, None, None


def conv2d(x, weight, bias=None, stride=(1, 1), padding=(0, 0),
           dilation=(1, 1), groups: int = 1):
    """``torch.nn.functional.conv2d`` with tuple arguments.  CPU tensors
    take it as it is; float32 CUDA tensors launch the kernel (no bias,
    dilation or groups)."""
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"conv2d: no kernel for device {x.device}")
        return nnf.conv2d(x, weight, bias, stride, padding, dilation, groups)
    if x.dtype != torch.float32 or weight.dtype != torch.float32:
        raise TypeError(f"conv2d: x and weight must be float32, got "
                        f"{x.dtype} and {weight.dtype}")
    if weight.get_device() != x.get_device():
        raise ValueError(f"conv2d: weight is on {weight.device}, x on "
                         f"{x.device}")
    if bias is not None or tuple(dilation) != (1, 1) or groups != 1:
        raise ValueError("conv2d: the kernel takes no bias, dilation or "
                         "groups")
    stride, padding = tuple(stride), tuple(padding)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        y = Conv2dFunction.apply(x, weight, stride, padding)
    else:
        y = launch(x, weight, stride, padding)
    conv2d.launches += 1
    return y


conv2d.launches = 0   # kernel launches by this wrapper (CUDA path only)
