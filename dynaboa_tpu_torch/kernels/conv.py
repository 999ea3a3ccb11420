"""Forward convolution and its data gradient through the hand-written
Hopper kernels ``csrc/conv_fprop.cu`` and ``csrc/conv_dgrad.cu``.

They replace no TPU kernel (the JAX package's convolutions are Flax's
``nn.Conv``, which XLA compiles, gradients included).  On the card cuDNN
ran the float32 forward convolutions of HMR's ResNet-50 at about a tenth of
the fp32 peak, and the data gradients of CLIFF's HRNet-W48 at under a
tenth: at a batch of 1 to 3 images the late layers and the low-resolution
branches have few pixels, and a tiling that does not split the reduction
leaves most of the 132 SMs idle.  Both kernels are fp32 implicit GEMMs
(FFMA only, no tensor cores) whose reduction is split over a thread-block
cluster; the data gradient runs a strided convolution as stride^2 dense
phases.  The notes in the ``.cu`` files say how.

What bounds them on the H100: the FMA rate.  The 53 convolutions of one
224^2 image row are 8.17 GFLOP, 122 us at the data sheet's 67 TFLOP/s
(derived, not measured); their weights, 93.8 MB, take 28 us at 3.35 TB/s.
The data gradient of the 52 whose input is not the image is 7.94 GFLOP;
CLIFF's 324 are 33.80 GFLOP.  Measured times are in the root PERF.md.

``conv2d`` dispatches on the device of its input: a CPU tensor takes
``torch.nn.functional.conv2d``; a float32 CUDA tensor launches the forward
kernel or raises.  On the card the gradient is a ``torch.autograd.Function``
whose backward launches the data-gradient kernel (``conv2d_dgrad``) where
the input needs a gradient, and takes the weight's gradient from ATen's
``convolution_backward`` (cuDNN's wgrad) with the output mask
``[False, True, False]``.  ``plan`` and ``dgrad_plan`` pick the tile and
the split from the shape alone; ``conv2d_plain`` and ``conv2d_dgrad_plain``
are the kernels' arithmetic in plain PyTorch, split as the plans split it.
"""

from __future__ import annotations

import ctypes
import math
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

_built = {}     # the loaded libraries, built at their first CUDA launch
_ready = set()  # (library, device) pairs whose attributes are set
_geoms = {}     # checked launch per (shapes, strides, stride, padding, device)
_dgrad_geoms = {}   # the same for the data gradient
# each library's launch entry
_ENTRIES = {"conv_fprop": "dynaboa_conv_fprop_forward",
            "conv_dgrad": "dynaboa_conv_dgrad_backward"}


def library(device_index: int, name: str):
    """Build (at first use) and load the kernel's shared library (``name``
    is ``conv_fprop`` or ``conv_dgrad``), and set its cluster and
    shared-memory attributes on the device (once, outside any capture)."""
    if name not in _built:
        from dynaboa_tpu_torch.kernels.build import build

        b = build(name)
        fn = getattr(b.lib, _ENTRIES[name])
        fn.argtypes = [ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
        init = getattr(b.lib, f"dynaboa_{name}_init")
        init.argtypes = [ctypes.c_int]
        init.restype = ctypes.c_int
        _built[name] = b
    b = _built[name]
    if (name, device_index) not in _ready:
        err = getattr(b.lib, f"dynaboa_{name}_init")(device_index)
        if err != 0:
            raise RuntimeError(f"{name} kernel set-up failed with CUDA "
                               f"error {err}")
        _ready.add((name, device_index))
    return b


def _entry(device_index: int, name: str):
    """The launch entry of library ``name``, loaded for the device."""
    return getattr(library(device_index, name).lib, _ENTRIES[name])


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


def _tile_and_split(rows: int, ncol: int, kred: int, groups: int,
                    target: int, min_steps: int) -> tuple[int, int, int, int]:
    """The instance that pads ``groups`` problems of ``rows`` x ``ncol``
    least (64 x 64 on a tie), and the split, doubled up to ``MAX_CLUSTER``
    while the CTAs fall short of ``target`` and each CTA keeps
    ``min_steps`` 16-deep steps of ``kred``: (bm, bn, split, tiles)."""
    best = None
    for bm, bn in TILES:
        tm, tn = _cdiv(rows, bm), _cdiv(ncol, bn)
        if best is None or tm * bm * tn * bn < best[0]:
            best = (tm * bm * tn * bn, bm, bn, tm * tn * groups)
    _, bm, bn, tiles = best
    steps = _cdiv(kred, BK)
    split = 1
    while (split < MAX_CLUSTER and tiles * split < target
           and steps // (2 * split) >= min_steps):
        split *= 2
    return bm, bn, split, tiles


def _fits(smem: int, kred: int, split: int, name: str) -> None:
    if smem > MAX_SMEM:
        raise ValueError(f"{name}: a reduction of {kred} over {split} CTAs "
                         f"needs {smem} B of shared memory, more than the "
                         f"kernel's {MAX_SMEM}")


def plan(k_out: int, ncol: int, kred: int, ksize: int) -> Plan:
    """The tile and the split for a convolution of ``k_out`` output
    channels, ``ncol`` = N * P * Q output columns and a reduction of
    ``kred`` = C * R * S over a ``ksize`` x ``ksize`` kernel.  The tile is
    the instance that pads the output least (64 x 64 on a tie); the split
    doubles, up to ``MAX_CLUSTER``, while the CTAs fall short of
    ``TARGET_CTAS`` and each CTA keeps ``MIN_STEPS`` steps.  (The constants
    were chosen from the kernel's times on the H100 at ResNet-50's shapes,
    N = 1 and 3, against the neighbouring splits: root PERF.md.)"""
    bm, bn, split, tiles = _tile_and_split(k_out, ncol, kred, 1, TARGET_CTAS,
                                           MIN_STEPS)
    smem = smem_bytes(bm, bn, kred, split, ksize)
    _fits(smem, kred, split, "conv2d")
    return Plan(bm, bn, split, tiles, smem)


class Phase(NamedTuple):
    """A class of the data gradient's phase split: the input pixels
    (a + stride * i, b + stride * j), ``hz`` x ``wz`` of them, and the taps
    that reach them, rows ``rs`` and columns ``ss`` of the kernel."""
    a: int
    b: int
    hz: int
    wz: int
    rs: tuple
    ss: tuple


def phases(H: int, W: int, R: int, S: int, stride: int,
           pad: int) -> list[Phase]:
    """The stride^2 classes of a strided convolution's data gradient, by
    (h mod stride, w mod stride): tap r reaches row h where
    (h + pad - r) / stride is whole, at dy's row (h + pad - r) / stride."""
    return [Phase(a, b, len(range(a, H, stride)), len(range(b, W, stride)),
                  tuple(r for r in range(R) if (a + pad - r) % stride == 0),
                  tuple(s for s in range(S) if (b + pad - s) % stride == 0))
            for a in range(stride) for b in range(stride)]


def dgrad_smem_bytes(bm: int, bn: int, kred: int, split: int,
                     ksize: int) -> int:
    """A CTA's ring of ``STAGES`` slices of A (stored [k][c], rows padded
    by 4) and B, and for a kernel larger than 1x1 its tables, 12 B per
    reduction index of the longest share."""
    ring = 4 * STAGES * (BK * (bm + 4) + BK * bn)
    table = 0 if ksize == 1 else 12 * BK * _cdiv(_cdiv(kred, BK), split)
    return ring + table


def dgrad_plan(x_shape, w_shape, stride: int, pad: int) -> Plan:
    """The tile and the split for the data gradient of a convolution of an
    input of ``x_shape`` (N, C, H, W) by a weight of ``w_shape``: ``C``
    rows, the columns of the largest phase, N * ceil(H / stride) *
    ceil(W / stride), and the reduction of the longest, K * ceil(R /
    stride)^2; ``tiles`` counts the tiles of the phases some tap reaches.
    The rule and its constants are the forward's: timed on the H100 at
    every tile and split of ResNet-50's and HRNet-W48's data-gradient
    shapes, N = 1-3, no other target or least share of steps did better by
    more than the times' noise (root PERF.md)."""
    N, C, H, W = x_shape
    K, _, R, S = w_shape
    live = [ph for ph in phases(H, W, R, S, stride, pad) if ph.rs and ph.ss]
    kred = K * _cdiv(R, stride) * _cdiv(S, stride)
    bm, bn, split, tiles = _tile_and_split(
        C, N * _cdiv(H, stride) * _cdiv(W, stride), kred, len(live),
        TARGET_CTAS, MIN_STEPS)
    smem = dgrad_smem_bytes(bm, bn, kred, split, R)
    _fits(smem, kred, split, "conv2d_dgrad")
    return Plan(bm, bn, split, tiles, smem)


def out_size(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def _out_format(x) -> torch.memory_format:
    # ATen's convolution on the card gives a channels_last output where the
    # input (or the weight, never channels_last here) suggests that layout
    return (torch.channels_last
            if suggest_memory_format(x) == torch.channels_last
            else torch.contiguous_format)


def _split_sum(a, cols, split: int):
    """``a @ cols`` (rows by reduction, a batch of reduction by columns)
    with the reduction cut into ``split`` shares of 16-deep steps, as a
    cluster's ranks cut it, and the shares' products summed in rank
    order."""
    kred = a.shape[1]
    steps = _cdiv(kred, BK)
    y = None
    for rank in range(split):
        lo = rank * steps // split * BK
        hi = min((rank + 1) * steps // split * BK, kred)
        part = a[:, lo:hi] @ cols[:, lo:hi]
        y = part if y is None else y + part
    return y


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
    y = _split_sum(weight.reshape(K, kred), cols, pl.split)
    return y.reshape(N, K, P, Q).contiguous(memory_format=_out_format(x))


def conv2d_dgrad_plain(dy, weight, x, stride=(1, 1), padding=(0, 0)):
    """The data-gradient kernel's arithmetic in plain PyTorch: for each
    phase, the reduction K * taps (k-major) cut into the plan's shares of
    16-deep steps, each share's product of the transposed weight rows and
    the columns gathered from dy at the taps' shifts (zeros beyond dy), the
    shares summed in rank order; pixels no tap reaches zero; the gradient in
    the layout ATen's ``convolution_backward`` gives ``x``'s."""
    N, C, H, W = x.shape
    K, _, R, S = weight.shape
    st, pd = stride[0], padding[0]
    P, Q = dy.shape[2], dy.shape[3]
    pl = dgrad_plan(x.shape, weight.shape, st, pd)
    dx = dy.new_zeros((N, C, H, W))
    for ph in phases(H, W, R, S, st, pd):
        if not (ph.rs and ph.ss and ph.hz and ph.wz):
            continue
        dr = [(ph.a + pd - r) // st for r in ph.rs]
        ds = [(ph.b + pd - s) // st for s in ph.ss]
        top, left = max(0, -min(dr)), max(0, -min(ds))
        padded = nnf.pad(dy, (left, max(0, max(ds) + ph.wz - Q),
                              top, max(0, max(dr) + ph.hz - P)))
        cols = torch.stack([padded[:, :, top + i:top + i + ph.hz,
                                   left + j:left + j + ph.wz]
                            for i in dr for j in ds], dim=2)
        taps = len(dr) * len(ds)
        cols = cols.reshape(N, K * taps, ph.hz * ph.wz)
        a = weight[:, :, list(ph.rs)][:, :, :, list(ph.ss)]
        a = a.permute(1, 0, 2, 3).reshape(C, K * taps)
        y = _split_sum(a, cols, pl.split)
        dx[:, :, ph.a::st, ph.b::st] = y.reshape(N, C, ph.hz, ph.wz)
    return dx.contiguous(memory_format=_out_format(x))


class _Launch(NamedTuple):
    ints: ctypes.Array      # the C entry's geometry (see the .cu files)
    shape: tuple            # the result's shape
    fmt: torch.memory_format
    fn: ctypes._CFuncPtr    # the loaded library's entry


def _square(name: str, R: int, S: int, stride, padding) -> None:
    if R != S or stride[0] != stride[1] or padding[0] != padding[1]:
        raise ValueError(f"{name}: a square kernel, stride and padding only, "
                         f"got {R}x{S}, {stride}, {padding}")


def _pack(name: str, src, weight, dims: tuple, stride, padding, fmt,
          pl: Plan, shape: tuple) -> _Launch:
    """The launch of library ``name`` on ``src`` (x, or dy for the data
    gradient), whose C entry reads the device, ``dims`` (N, C, H, W, K, P,
    Q, R, S), the stride and padding, ``src``'s strides, the layout of the
    result (of ``shape``), the tile's rows and the split; the kernels index
    with 32-bit ints."""
    span = sum((n - 1) * s for n, s in zip(src.shape, src.stride())) + 1
    if max(span, math.prod(shape), weight.numel()) >= 2 ** 31:
        raise ValueError(f"{name}: the kernel indexes with 32-bit ints")
    dev = src.get_device()
    ints = (dev, *dims, stride[0], padding[0], *src.stride(),
            int(fmt == torch.channels_last), pl.bm, pl.split)
    return _Launch((ctypes.c_int * len(ints))(*ints), shape, fmt,
                   _entry(dev, name))


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
        _square("conv2d", R, S, stride, padding)
        P = out_size(H, R, stride[0], padding[0])
        Q = out_size(W, S, stride[1], padding[1])
        if P <= 0 or Q <= 0 or x.numel() == 0:
            raise ValueError(f"conv2d: no output for x {tuple(x.shape)}")
        g = _geoms[key] = _pack(
            "conv_fprop", x, weight, (N, C, H, W, K, P, Q, R, S), stride,
            padding, _out_format(x), plan(K, N * P * Q, C * R * S, R),
            (N, K, P, Q))
    return g


def _run(g: _Launch, src, weight, name: str):
    """One launch of ``g`` on the float32 CUDA ``src`` (x, or dy for the
    data gradient) and ``weight``: its result, allocated with
    ``torch.empty`` in ``g``'s memory format, on the current stream."""
    weight = weight.contiguous()
    dev = src.get_device()
    out = torch.empty(g.shape, dtype=torch.float32, device=dev,
                      memory_format=g.fmt)
    err = g.fn(src.data_ptr(), weight.data_ptr(), out.data_ptr(), g.ints,
               torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err} (input {tuple(src.shape)} strides "
                           f"{src.stride()}, weight {tuple(weight.shape)}, "
                           f"geometry {list(g.ints)})")
    return out


def launch(x, weight, stride, padding):
    """One launch on a float32 CUDA ``x`` (any strides) and ``weight``: the
    output, in the memory format ATen's convolution gives for ``x``."""
    return _run(_geometry(x, weight, stride, padding), x, weight,
                "conv_fprop")


def _dgrad_geometry(dy, weight, x, stride, padding) -> _Launch:
    """The data gradient's launch for float32 CUDA ``dy`` and ``weight``,
    checked and planned once per shape, strides, layout of ``x`` and device
    and cached, as the forward's is."""
    key = (dy.shape, dy.stride(), dy.dtype, x.shape, x.stride(),
           weight.shape, weight.dtype, stride, padding, dy.device)
    g = _dgrad_geoms.get(key)
    if g is None:
        if not dy.is_cuda:
            raise ValueError(f"conv2d_dgrad: no kernel for device "
                             f"{dy.device}")
        if dy.dtype != torch.float32 or weight.dtype != torch.float32:
            raise TypeError(f"conv2d_dgrad: dy and weight must be float32, "
                            f"got {dy.dtype} and {weight.dtype}")
        if weight.device != dy.device:
            raise ValueError(f"conv2d_dgrad: weight is on {weight.device}, "
                             f"dy on {dy.device}")
        if (dy.dim() != 4 or weight.dim() != 4 or len(x.shape) != 4
                or x.shape[1] != weight.shape[1]):
            raise ValueError(f"conv2d_dgrad: dy {tuple(dy.shape)}, weight "
                             f"{tuple(weight.shape)} and x "
                             f"{tuple(x.shape)}")
        N, C, H, W = x.shape
        K, _, R, S = weight.shape
        _square("conv2d_dgrad", R, S, stride, padding)
        P = out_size(H, R, stride[0], padding[0])
        Q = out_size(W, S, stride[1], padding[1])
        if tuple(dy.shape) != (N, K, P, Q) or P <= 0 or Q <= 0:
            raise ValueError(f"conv2d_dgrad: dy {tuple(dy.shape)} is not the "
                             f"output of x {tuple(x.shape)} and weight "
                             f"{tuple(weight.shape)}")
        g = _dgrad_geoms[key] = _pack(
            "conv_dgrad", dy, weight, (N, C, H, W, K, P, Q, R, S), stride,
            padding, _out_format(x),
            dgrad_plan(x.shape, weight.shape, stride[0], padding[0]),
            (N, C, H, W))
    return g


def dgrad_launch(dy, weight, x, stride, padding):
    """One launch of the data-gradient kernel on a float32 CUDA ``dy`` (any
    strides) and ``weight``: the gradient with respect to ``x`` (of which
    only the shape and layout are read), in the memory format ATen's
    ``convolution_backward`` gives it."""
    return _run(_dgrad_geometry(dy, weight, x, stride, padding), dy, weight,
                "conv_dgrad")


def conv2d_dgrad(dy, weight, x, stride=(1, 1), padding=(0, 0)):
    """The gradient of ``conv2d(x, weight, None, stride, padding)`` with
    respect to ``x``, given the output's gradient ``dy``: one launch of the
    data-gradient kernel on float32 CUDA tensors (the backward of
    ``Conv2dFunction``; there is no CPU path, the CPU's convolutions being
    ATen's)."""
    dx = dgrad_launch(dy, weight, x, tuple(stride), tuple(padding))
    conv2d_dgrad.launches += 1
    return dx


conv2d_dgrad.launches = 0   # data-gradient kernel launches by this wrapper


class Conv2dFunction(torch.autograd.Function):
    """The forward kernel; in the backward, the data-gradient kernel where
    the input needs a gradient, and ATen's ``convolution_backward`` asked
    for the weight's gradient alone where the weight needs one."""

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
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv2d_dgrad(dy, weight, x, stride, padding)
        if ctx.needs_input_grad[1]:
            dw = torch.ops.aten.convolution_backward(
                dy, x, weight, None, list(stride), list(padding), [1, 1],
                False, [0, 0], 1, [False, True, False])[1]
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
