"""The convolution wrapper ``kernels/conv.py`` and HMR's ``Conv2d32`` on the
CPU: a CPU tensor takes ``nnf.conv2d`` bit for bit, forward and backward,
and launches nothing; the plain version against ATen's convolution at every
convolution shape of ResNet-50; the autograd Function's backward wiring
with the plain version standing in for the kernel; the launcher's plan at
every shape; the bfloat16 arm staying on ATen's convolution; the parameter
names; and the benchmark's count of convolution FLOPs and image rows.  The
kernel itself runs in ``tests/test_torch_conv_cuda.py`` on a card."""

from __future__ import annotations

import json
import os

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as nnf

import torch_port_fixtures  # noqa: F401  (shares the cores among workers)
from test_torch_conv_cuda import SHAPES

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
    """``Conv2dFunction`` with the plain version standing in for the
    kernel: its gradients are ATen's convolution backward on the saved
    input and weight, bit for bit, with and without the input's."""
    monkeypatch.setattr(kc, "launch",
                        lambda x, w, stride, padding:
                        kc.conv2d_plain(x, w, stride, padding))
    shape = ((16, 9, 9), 8, 3, 2, 1)
    x, w = _inputs(2, shape, seed=4, grad=True)
    y = kc.Conv2dFunction.apply(x, w, (2, 2), (1, 1))
    dy = torch.randn_like(y)
    got = torch.autograd.grad(y, (x, w), dy)
    want = torch.autograd.grad(nnf.conv2d(x, w, None, 2, 1), (x, w), dy)
    for a, e in zip(got, want):
        assert torch.equal(a, e)
    x0 = x.detach()
    y = kc.Conv2dFunction.apply(x0, w, (2, 2), (1, 1))
    got_w, = torch.autograd.grad(y, (w,), dy)
    assert torch.equal(got_w, torch.autograd.grad(
        nnf.conv2d(x0, w, None, 2, 1), (w,), dy)[0])


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
