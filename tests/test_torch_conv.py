"""The convolution wrapper ``kernels/conv.py`` and HMR's ``Conv2d32`` on the
CPU: a CPU tensor takes ``nnf.conv2d`` bit for bit, forward and backward,
and launches nothing; the plain versions of the forward and of the data
gradient against ATen's at every convolution shape of ResNet-50 (and the
data gradient's at HRNet-W48's, its phase split and zeroed pixels at
ragged sizes); the autograd Function's backward wiring with the plain
versions standing in for the kernels; the launchers' plans at every shape;
the bfloat16 arm staying on ATen's convolution; the parameter names; and
the benchmark's counts of convolution FLOPs, data-gradient FLOPs and image
rows.  The kernels themselves run in ``tests/test_torch_conv_cuda.py`` on a
card."""

from __future__ import annotations

import json
import os

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as nnf

import torch_port_fixtures  # noqa: F401  (shares the cores among workers)
from torch_conv_shapes import HRNET_SHAPES as CONV_SHAPES
from torch_conv_shapes import RESNET50_SHAPES as SHAPES

from dynaboa_tpu_torch.kernels import conv as kc
from dynaboa_tpu_torch.models import hmr as mhmr
from dynaboa_tpu_torch.models.hmr import HMR, HMRISO, Conv2d32
from perfbench.harness import found, work

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the plain version against ATen's convolution on the CPU: the same
# float32 products summed in another order (the plan's shares of the
# reduction, each a matmul, then the shares in rank order), over up to
# 4,608 terms; the largest gap measured over these shapes is 9.7e-7 of the
# output's largest magnitude
PLAIN_TOL = 2e-6


def _inputs(n, shape, seed, grad=False, channels_last=False):
    (C, H, W), K, k, _, _ = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, C, H, W), generator=g)
    if channels_last:
        x = x.to(memory_format=torch.channels_last)
    w = torch.randn((K, C, k, k), generator=g) * (2.0 / (k * k * K)) ** 0.5
    if grad:
        x.requires_grad_(True)
        w.requires_grad_(True)
    return x, w


def _gap(a, b) -> float:
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


@pytest.mark.parametrize("case,channels_last", [
    (((3, 32, 32), 8, 7, 2, 3), False), (((3, 32, 32), 8, 7, 2, 3), True),
    (((16, 9, 9), 8, 3, 1, 1), False), (((16, 9, 9), 8, 3, 2, 1), True),
    (((16, 9, 9), 32, 1, 2, 0), False), (((5, 7, 6), 3, 1, 1, 0), False)])
def test_cpu_takes_nnf_conv2d_bit_for_bit(case, channels_last):
    (C, _, _), K, k, s, p = case
    x, w = _inputs(2, case, seed=C + K, grad=True,
                   channels_last=channels_last)
    m = Conv2d32(C, K, k, stride=s, padding=p, bias=False)
    with torch.no_grad():
        m.weight.copy_(w)
    before = kc.conv2d.launches
    y = m(x)
    ref = nnf.conv2d(x, m.weight, None, s, p)
    assert torch.equal(y, ref) and y.stride() == ref.stride()
    dy = torch.randn_like(ref)
    got = torch.autograd.grad(y, (x, m.weight), dy)
    want = torch.autograd.grad(ref, (x, m.weight), dy)
    for a, e in zip(got, want):
        assert torch.equal(a, e)
    assert kc.conv2d.launches == before


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_aten(shape, n):
    _, _, _, s, p = shape
    x, w = _inputs(n, shape, seed=sum(shape[0]) + n)
    y = kc.conv2d_plain(x, w, (s, s), (p, p))
    ref = nnf.conv2d(x, w, None, s, p)
    assert y.shape == ref.shape and y.stride() == ref.stride()
    assert _gap(y, ref) <= PLAIN_TOL


def test_plain_keeps_a_channels_last_layout():
    """conv1's input is a channels_last view of the NHWC crop; the plain
    version (and the kernel) give the layout ATen's convolution gives."""
    nhwc = torch.randn((2, 32, 32, 3), generator=torch.Generator()
                       .manual_seed(1))
    x = nhwc.permute(0, 3, 1, 2)
    w = torch.randn((8, 3, 7, 7))
    y = kc.conv2d_plain(x, w, (2, 2), (3, 3))
    ref = nnf.conv2d(x, w, None, 2, 3)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert y.stride() == ref.stride()
    assert _gap(y, ref) <= PLAIN_TOL


def test_function_backward_is_atens(monkeypatch):
    """``Conv2dFunction`` with the plain versions standing in for the
    kernels: the input's gradient is one data-gradient launch (the plain
    version's result, bit for bit, within ``PLAIN_TOL`` of ATen's); the
    weight's is ATen's ``convolution_backward`` on the saved input and
    weight asked for with the mask ``[False, True, False]``, bit for bit;
    an input without grad launches nothing."""
    monkeypatch.setattr(kc, "launch",
                        lambda x, w, stride, padding:
                        kc.conv2d_plain(x, w, stride, padding))
    monkeypatch.setattr(kc, "dgrad_launch",
                        lambda dy, w, x, stride, padding:
                        kc.conv2d_dgrad_plain(dy, w, x, stride, padding))
    masks = []
    aten_backward = torch.ops.aten.convolution_backward

    def backward(*args):
        masks.append(list(args[-1]))
        return aten_backward(*args)

    monkeypatch.setattr(torch.ops.aten, "convolution_backward", backward)
    shape = ((16, 9, 9), 8, 3, 2, 1)
    x, w = _inputs(2, shape, seed=4, grad=True)
    y = kc.Conv2dFunction.apply(x, w, (2, 2), (1, 1))
    dy = torch.randn_like(y)
    before = kc.conv2d_dgrad.launches
    got_x, got_w = torch.autograd.grad(y, (x, w), dy)
    assert kc.conv2d_dgrad.launches == before + 1
    assert masks == [[False, True, False]]
    want_x, want_w = torch.autograd.grad(nnf.conv2d(x, w, None, 2, 1),
                                         (x, w), dy)
    assert torch.equal(got_w, want_w)
    assert torch.equal(got_x, kc.conv2d_dgrad_plain(dy, w, x, (2, 2),
                                                    (1, 1)))
    assert got_x.stride() == want_x.stride()
    assert _gap(got_x, want_x) <= PLAIN_TOL
    x0 = x.detach()
    y = kc.Conv2dFunction.apply(x0, w, (2, 2), (1, 1))
    got_w, = torch.autograd.grad(y, (w,), dy)
    assert kc.conv2d_dgrad.launches == before + 1
    assert torch.equal(got_w, torch.autograd.grad(
        nnf.conv2d(x0, w, None, 2, 1), (w,), dy)[0])
    # an input that needs a gradient under a weight that does not: the data
    # gradient alone, and no call of ATen's backward
    masks.clear()
    y = kc.Conv2dFunction.apply(x, w.detach(), (2, 2), (1, 1))
    got_x, = torch.autograd.grad(y, (x,), dy)
    assert kc.conv2d_dgrad.launches == before + 2 and masks == []
    assert torch.equal(got_x, kc.conv2d_dgrad_plain(dy, w.detach(), x,
                                                    (2, 2), (1, 1)))


# every data-gradient shape of ResNet-50 and HRNet-W48: each convolution
# but the first, whose input is the image and takes no gradient
DGRAD_SHAPES = tuple(dict.fromkeys(SHAPES[1:] + CONV_SHAPES[1:]))
# (C, H, W, K, kernel, stride, padding) off the models' shapes: ragged
# channel counts and odd sizes, for the phase split of each stride and
# kernel the models use (and conv1's 7x7), the pixels no tap reaches (1x1,
# stride 2) and the taps that fall beyond dy's edge
DGRAD_CASES = ((5, 9, 7, 6, 1, 1, 0), (5, 9, 7, 6, 1, 2, 0),
               (7, 8, 6, 70, 1, 2, 0), (7, 9, 11, 5, 3, 1, 1),
               (7, 9, 11, 5, 3, 2, 1), (6, 8, 10, 5, 3, 2, 1),
               (130, 5, 3, 9, 3, 2, 1), (3, 10, 10, 4, 7, 2, 3))


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("case", DGRAD_CASES)
def test_dgrad_plain_matches_aten_at_ragged_sizes(case, n):
    """The data-gradient kernel's arithmetic (each phase's taps, the plan's
    shares in rank order) against ``torch.nn.grad.conv2d_input``, in both
    of the input's layouts; the pixels no tap reaches are zeros."""
    C, H, W, K, k, s, p = case
    g = torch.Generator().manual_seed(sum(case) + n)
    w = torch.randn((K, C, k, k), generator=g)
    P, Q = kc.out_size(H, k, s, p), kc.out_size(W, k, s, p)
    dy = torch.randn((n, K, P, Q), generator=g)
    want = torch.nn.grad.conv2d_input((n, C, H, W), w, dy, s, p)
    for fmt in (torch.contiguous_format, torch.channels_last):
        x = torch.empty((n, C, H, W)).contiguous(memory_format=fmt)
        got = kc.conv2d_dgrad_plain(dy, w, x, (s, s), (p, p))
        assert got.shape == want.shape
        assert got.is_contiguous(memory_format=fmt)
        assert _gap(got, want) <= PLAIN_TOL
    if k == 1 and s == 2:
        assert not got[:, :, 1::2].any() and not got[:, :, :, 1::2].any()
    # the phases cover every pixel once and every tap once
    phs = kc.phases(H, W, k, k, s, p)
    assert sum(ph.hz * ph.wz for ph in phs) == H * W
    assert sorted((r, t) for ph in phs for r in ph.rs for t in ph.ss
                  if ph.hz and ph.wz) == [(r, t) for r in range(k)
                                          for t in range(k)]


def _dgrad_plan_checks(shape, n):
    (C, H, W), K, k, s, p = shape
    pl = kc.dgrad_plan((n, C, H, W), (K, C, k, k), s, p)
    live = [ph for ph in kc.phases(H, W, k, k, s, p) if ph.rs and ph.ss]
    kred = K * (-(-k // s)) ** 2
    assert (pl.bm, pl.bn) in kc.TILES
    assert pl.split in (1, 2, 4, 8, 16)
    assert pl.split <= -(-kred // kc.BK)     # every CTA has a share
    assert pl.smem <= kc.MAX_SMEM < 227 * 1024
    ncol = n * -(-H // s) * -(-W // s)
    assert pl.tiles == len(live) * -(-C // pl.bm) * -(-ncol // pl.bn)
    assert (pl.ctas >= kc.TARGET_CTAS or pl.split == kc.MAX_CLUSTER
            or -(-kred // kc.BK) // (2 * pl.split) < kc.MIN_STEPS)


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("shape", DGRAD_SHAPES)
def test_dgrad_plain_and_plan_at_every_shape(shape, n):
    """At every data-gradient shape of ResNet-50 and HRNet-W48 (every
    convolution but the first, whose input is the image): the plain version
    against ATen's data gradient within ``PLAIN_TOL``, and a plan within the
    kernel's shared memory."""
    (C, H, W), K, k, s, p = shape
    g = torch.Generator().manual_seed(sum(shape[0]) + K + n)
    w = torch.randn((K, C, k, k), generator=g) * (2.0 / (k * k * K)) ** 0.5
    dy = torch.randn((n, K, kc.out_size(H, k, s, p), kc.out_size(W, k, s, p)),
                     generator=g)
    x = torch.empty((n, C, H, W))
    got = kc.conv2d_dgrad_plain(dy, w, x, (s, s), (p, p))
    want = torch.nn.grad.conv2d_input(x.shape, w, dy, s, p)
    assert got.stride() == want.stride()
    assert _gap(got, want) <= PLAIN_TOL
    _dgrad_plan_checks(shape, n)


def test_dgrad_shapes_are_every_convolution_but_the_first():
    assert DGRAD_SHAPES == tuple(dict.fromkeys(SHAPES[1:] + CONV_SHAPES[1:]))
    assert all(shape[0][0] != 3 for shape in DGRAD_SHAPES)


def test_dgrad_refuses_the_cpu():
    """The data gradient has no CPU path: the CPU's convolutions are
    ATen's, so only the card's backward reaches it."""
    x = torch.zeros((1, 4, 8, 8))
    with pytest.raises(ValueError):
        kc.conv2d_dgrad(torch.zeros((1, 4, 8, 8)), torch.zeros((4, 4, 1, 1)),
                        x)


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_covers_every_resnet_shape(shape, n):
    (C, H, _), K, k, s, p = shape
    P = kc.out_size(H, k, s, p)
    kred = C * k * k
    pl = kc.plan(K, n * P * P, kred, k)
    assert (pl.bm, pl.bn) in kc.TILES
    assert pl.split in (1, 2, 4, 8, 16)
    assert pl.split <= -(-kred // kc.BK)     # every CTA has a share
    assert pl.smem <= kc.MAX_SMEM < 227 * 1024
    assert pl.tiles == -(-K // pl.bm) * -(-n * P * P // pl.bn)
    # about one CTA on every SM, unless the split is at the cluster's limit
    # or a doubling would leave a CTA fewer than MIN_STEPS steps
    assert (pl.ctas >= kc.TARGET_CTAS or pl.split == kc.MAX_CLUSTER
            or -(-kred // kc.BK) // (2 * pl.split) < kc.MIN_STEPS)


def test_plan_refuses_what_shared_memory_cannot_hold():
    with pytest.raises(ValueError):
        kc.plan(64, 64 * 132, 3 * 3 * 4096, 3)


def test_conv_shapes_are_the_cards_tests():
    """The card's tests cover every convolution of a full-width HMR
    forward, 53 calls of 23 shapes."""
    model = HMR()
    seen = []
    handles = [m.register_forward_pre_hook(
        lambda mod, args: seen.append(
            (tuple(args[0].shape[1:]), mod.out_channels, mod.kernel_size[0],
             mod.stride[0], mod.padding[0])))
        for m in model.modules() if isinstance(m, Conv2d32)]
    with torch.no_grad():
        model(torch.zeros((1, 3, 224, 224)))
    for h in handles:
        h.remove()
    assert len(seen) == 53
    assert tuple(dict.fromkeys(seen)) == SHAPES


def test_bf16_autocast_stays_on_aten(monkeypatch):
    """Under autocast ``Conv2d32`` is ``nn.Conv2d``: the bfloat16 arm never
    reaches the kernel's wrapper, and its outputs are the same bits."""
    def refuse(*a, **k):
        raise AssertionError("conv2d called under autocast")

    torch.manual_seed(0)
    model = HMR(layers=(1, 1, 1, 1), width=16, regressor_dim=64,
                compute_dtype="bfloat16").eval()
    x = torch.randn((2, 3, 64, 64))
    with torch.no_grad():
        want = model(x)[3][0]
    monkeypatch.setattr(mhmr, "conv2d", refuse)
    with torch.no_grad():
        got = model(x)[3][0]
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    m = Conv2d32(16, 8, 3, padding=1, bias=False)
    xs = torch.randn((1, 16, 8, 8))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = m(xs)
        want = nn.Conv2d.forward(m, xs)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    with pytest.raises(AssertionError):
        m(xs)


def _backbone_conv_names(layers) -> list[str]:
    names = ["conv1"]
    for li, blocks in enumerate(layers, 1):
        for b in range(blocks):
            names += [f"layer{li}.{b}.conv{i}" for i in (1, 2, 3)]
            if b == 0:
                names.append(f"layer{li}.0.downsample.0")
    return names


def test_parameter_names_unchanged():
    """The reference checkpoint's names: every convolution is a bias-free
    ``Conv2d32`` (an ``nn.Conv2d``) under its old name, HMRISO's stay
    ``nn.Conv2d``, and a state dict saved from the one loads into the
    other."""
    model = HMR()
    convs = {n: m for n, m in model.named_modules()
             if isinstance(m, nn.Conv2d)}
    assert sorted(convs) == sorted(_backbone_conv_names((3, 4, 6, 3)))
    assert all(type(m) is Conv2d32 and m.bias is None
               for m in convs.values())
    names = [n for n, _ in model.named_parameters()]
    assert [n for n in names if n.endswith("weight") and n[:-7] in convs] \
        == [f"{n}.weight" for n in _backbone_conv_names((3, 4, 6, 3))]
    iso = HMRISO(layers=(1, 1, 1, 1), width=8, regressor_dim=32)
    assert all(type(m) is nn.Conv2d for m in iso.modules()
               if isinstance(m, nn.Conv2d))
    small = HMR(layers=(1, 1, 1, 1), width=8, regressor_dim=32)
    again = HMR(layers=(1, 1, 1, 1), width=8, regressor_dim=32)
    again.load_state_dict(small.state_dict())
    for (n, a), (_, b) in zip(small.state_dict().items(),
                              again.state_dict().items()):
        assert torch.equal(a, b), n


def test_refuses_other_devices():
    with pytest.raises(ValueError):
        kc.conv2d(torch.zeros((1, 4, 8, 8), device="meta"),
                  torch.zeros((4, 4, 1, 1), device="meta"))


def _conv_reader():
    return found.module("metrics", "conv_fprop_roofline.engine", ROOT)


def test_reader_counts_the_forwards_convolution_flops():
    """``conv_fprop_roofline.engine``'s numerator: the harness's FLOPs of
    one HMR forward without the regressor equal the convolutions' own
    2 * K * C*R*S * P*Q, summed by hooks over a full-width forward."""
    model = HMR()
    flops = []

    def hook(mod, args, out):
        K, C, R, S = mod.weight.shape
        flops.append(2 * K * C * R * S * out.shape[2] * out.shape[3])

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, Conv2d32)]
    with torch.no_grad():
        model(torch.zeros((1, 3, 224, 224)))
    for h in handles:
        h.remove()
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "dynaboa_3dpw.json")) as f:
        spec = json.load(f)
    assert sum(flops) == 8_174_272_512
    assert _conv_reader().conv_flops_per_row(spec["model"]) == sum(flops)
    assert work.hmr_forward_flops({**spec["model"], "n_iter": 0}) \
        == sum(flops)


@pytest.mark.parametrize("config", ["dynaboa_3dpw", "dynaboa_webcam"])
def test_reader_rows_are_group_norms(config):
    """The new reader's image rows a frame are the GroupNorm reader's (the
    same forwards run every convolution and every GroupNorm); that count is
    held to the engine's forwards in ``tests/test_torch_group_norm.py``."""
    with open(os.path.join(ROOT, "perfbench", "configs",
                           f"{config}.json")) as f:
        adapt = json.load(f)["adapt"]
    gn = found.module("metrics", "group_norm_roofline.engine", ROOT)
    for n in range(1, 9):
        assert _conv_reader().rows_per_frame(adapt, n) \
            == gn.rows_per_frame(adapt, n)


def test_reader_reads_the_kernels_time():
    """The share: FLOPs of the segment's rows over the summed time of the
    trace kernels named ``dynaboa_conv_fprop``, over 67 TFLOP/s; None
    without such kernels (a program without the kernel)."""
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "dynaboa_3dpw.json")) as f:
        cfg = json.load(f)
    reader = _conv_reader()
    updates = [1, 8, 1, 7, 2, 4, 2, 4]
    rows = sum(reader.rows_per_frame(cfg["adapt"], n) for n in updates)
    assert rows == 177
    kernels = {"void (anonymous namespace)::dynaboa_conv_fprop<64, 64, "
               "true>(ConvArgs)": [0.01, 0.02],
               "void (anonymous namespace)::dynaboa_conv_fprop<128, 32, "
               "false>(ConvArgs)": [0.03],
               "sm80_xmma_fprop_implicit_gemm_f32f32": [5.0]}
    r = {"trace": {"kernels": kernels, "updates": updates}}
    want = 100.0 * 8_174_272_512 * 177 / work.PEAK_FP32_FLOPS / 0.06
    assert reader.read(r, cfg) == pytest.approx(want, rel=1e-12)
    del kernels["void (anonymous namespace)::dynaboa_conv_fprop<64, 64, "
                "true>(ConvArgs)"]
    del kernels["void (anonymous namespace)::dynaboa_conv_fprop<128, 32, "
                "false>(ConvArgs)"]
    assert reader.read(r, cfg) is None
    assert reader.read({"trace": None}, cfg) is None


def _dgrad_reader(cell="engine"):
    return found.module("metrics", f"conv_dgrad_roofline.{cell}", ROOT)


def _config(name):
    with open(os.path.join(ROOT, "perfbench", "configs",
                           f"{name}.json")) as f:
        return json.load(f)


def test_dgrad_readers_count_every_convolution_but_the_first():
    """``conv_dgrad_roofline``'s numerators: a data gradient takes its
    convolution's FLOPs, for every convolution whose input is not the
    image: HMR's 52 (by hooks on a full-width forward, conv1's 236,027,904
    left out) and CLIFF's 324 (33,846,755,328 less the stem's first,
    42,467,328), counted from the configurations alone."""
    from perfbench.harness import cliff

    model = HMR()
    flops = []

    def hook(mod, args, out):
        K, C, R, S = mod.weight.shape
        flops.append(2 * K * C * R * S * out.shape[2] * out.shape[3])

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, Conv2d32)]
    with torch.no_grad():
        model(torch.zeros((1, 3, 224, 224)))
    for h in handles:
        h.remove()
    assert flops[0] == 236_027_904 and sum(flops[1:]) == 7_938_244_608
    hmr = _config("dynaboa_3dpw")["model"]
    assert _dgrad_reader().dgrad_flops_per_row(hmr) == 7_938_244_608
    cl = _config("cliff_hr48_3dpw")["model"]
    assert _dgrad_reader("cliff").dgrad_flops_per_row(cl) == 33_804_288_000
    assert cliff.conv_flops(cl) - 42_467_328 == 33_804_288_000


@pytest.mark.parametrize("config", ["dynaboa_3dpw", "cliff_hr48_3dpw",
                                    "dynaboa_webcam"])
def test_dgrad_reader_rows_are_the_gradient_evaluations(config):
    """The gradient rows a frame: the lower evaluation's rows once and the
    upper's per update, 2 + 3 n in 3DPW's protocol (the frame and an
    exemplar below; the frame, its history row and an exemplar above) and
    1 + 2 n in the webcam's (no exemplars)."""
    adapt = _config(config)["adapt"]
    per = (1, 2) if config == "dynaboa_webcam" else (2, 3)
    for n in range(0, 9):
        assert _dgrad_reader().grad_rows_per_frame(adapt, n) == \
            per[0] + per[1] * n
    updates = [1, 8, 1, 7, 2, 4, 2, 4]
    if config != "dynaboa_webcam":
        assert sum(_dgrad_reader().grad_rows_per_frame(adapt, n)
                   for n in updates) == 103


@pytest.mark.parametrize("cell,config,flops", [
    ("engine", "dynaboa_3dpw", 7_938_244_608),
    ("cliff", "cliff_hr48_3dpw", 33_804_288_000)])
def test_dgrad_reader_reads_the_kernels_time(cell, config, flops):
    """The share: the data-gradient FLOPs of the segment's 103 gradient
    rows over the summed time of the trace kernels named
    ``dynaboa_conv_dgrad`` (not the forward kernel's, nor cuDNN's), over
    67 TFLOP/s; None without them."""
    cfg = _config(config)
    reader = _dgrad_reader(cell)
    kernels = {"void (anonymous namespace)::dynaboa_conv_dgrad<64, 64, "
               "false>(DgradArgs)": [0.01, 0.02],
               "void (anonymous namespace)::dynaboa_conv_dgrad<128, 32, "
               "true>(DgradArgs)": [0.03],
               "void (anonymous namespace)::dynaboa_conv_fprop<64, 64, "
               "true>(ConvArgs)": [7.0],
               "void cudnn::detail::dgrad_engine<float, 512, 6>": [5.0]}
    r = {"trace": {"kernels": kernels, "updates": [1, 8, 1, 7, 2, 4, 2, 4]}}
    want = 100.0 * flops * 103 / work.PEAK_FP32_FLOPS / 0.06
    assert reader.read(r, cfg) == pytest.approx(want, rel=1e-12)
    for name in [k for k in kernels if "dynaboa_conv_dgrad" in k]:
        del kernels[name]
    assert reader.read(r, cfg) is None
    assert reader.read({"trace": None}, cfg) is None
    assert reader.read({}, cfg) is None
