"""The GroupNorm wrapper ``kernels/group_norm.py`` on the CPU: a CPU tensor
takes ``nnf.group_norm`` bit for bit, forward and backward, and launches
nothing; the plain version against ATen's GroupNorm; the autograd
Function's backward wiring with the plain version standing in for the
kernel; the plain version's statistics against float64; the launcher's
plan at every GroupNorm shape of ResNet-50; and the benchmark's count of
GroupNorm rows against the rows the engine's forwards normalise.  The kernel itself runs in
``tests/test_torch_group_norm_cuda.py`` on a card."""

from __future__ import annotations

import json
import os

import pytest
import torch
import torch.nn.functional as nnf

import torch_port_fixtures  # noqa: F401  (shares the cores among workers)
from test_torch_group_norm_cuda import SHAPES

from dynaboa_tpu_torch.apps.common import build_system
from dynaboa_tpu_torch.config import AdaptConfig
from dynaboa_tpu_torch.engine.bilevel import Frame
from dynaboa_tpu_torch.kernels import group_norm as kgn
from dynaboa_tpu_torch.models.hmr import HMR, GroupNorm32
from perfbench.harness import found

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = 4


def _inputs(shape, seed, grad=False):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * 2.0 + 0.5
    C = shape[1]
    w = 1.0 + 0.5 * torch.randn((C,), generator=g)
    b = 0.5 * torch.randn((C,), generator=g)
    if grad:
        for t in (x, w, b):
            t.requires_grad_(True)
    return x, w, b


@pytest.mark.parametrize("shape,groups,channels_last", [
    ((2, 64, 56, 56), 4, False), ((2, 64, 56, 56), 4, True),
    ((3, 512, 7, 7), 4, False), ((3, 512, 7, 7), 4, True),
    ((1, 2048, 7, 7), 4, False), ((2, 6, 5, 3), 3, False),
    ((2, 6, 5, 3), 3, True), ((4, 8), 2, False)])
def test_cpu_takes_nnf_group_norm_bit_for_bit(shape, groups, channels_last):
    x, w, b = _inputs(shape, seed=sum(shape), grad=True)
    if channels_last:
        x = x.detach().to(memory_format=torch.channels_last)
        x.requires_grad_(True)
    before = kgn.group_norm.launches
    y = kgn.group_norm(x, groups, w, b, 1e-5)
    ref = nnf.group_norm(x, groups, w, b, 1e-5)
    assert torch.equal(y, ref) and y.stride() == ref.stride()
    dy = torch.randn_like(ref)
    got = torch.autograd.grad(y, (x, w, b), dy)
    want = torch.autograd.grad(ref, (x, w, b), dy)
    for a, e in zip(got, want):
        assert torch.equal(a, e)
    assert kgn.group_norm.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm32_on_the_cpu(dtype):
    m = GroupNorm32(GROUPS, 64, eps=1e-5)
    with torch.no_grad():
        m.weight.normal_()
        m.bias.normal_()
    x = _inputs((2, 64, 9, 9), seed=2)[0].to(dtype)
    assert torch.equal(m(x), nnf.group_norm(x.float(), GROUPS, m.weight,
                                            m.bias, 1e-5))


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("chw", SHAPES)
def test_plain_matches_aten(chw, n):
    """The kernel's arithmetic (two-pass statistics, (x - mean) * (rstd *
    gamma) + beta) against ATen's GroupNorm on the CPU: float32 sums in
    another order, a few ulp of each output's scale."""
    x, w, b = _inputs((n, *chw), seed=sum(chw) + n)
    y, mean, rstd = kgn.group_norm_plain(x, GROUPS, w, b, 1e-5)
    ref, ref_mean, ref_rstd = torch.ops.aten.native_group_norm(
        x, w, b, n, chw[0], chw[1] * chw[2], GROUPS, 1e-5)
    for a, e in ((y, ref), (mean, ref_mean), (rstd, ref_rstd)):
        assert a.shape == e.shape
        assert float((a - e).abs().max() / e.abs().max()) <= 1e-6


def test_function_backward_is_atens_on_the_kernels_statistics(monkeypatch):
    """``GroupNormFunction`` with the plain version standing in for the
    kernel: its gradients are ATen's backward fed the forward's mean and
    rstd, with and without a bias."""
    def plain_launch(x, num_groups, weight, bias, eps, stats=True):
        y, mean, rstd = kgn.group_norm_plain(x, num_groups, weight, bias, eps)
        return (y, mean, rstd) if stats else (y, None, None)

    monkeypatch.setattr(kgn, "launch", plain_launch)
    x, w, b = _inputs((2, 128, 14, 14), seed=4, grad=True)
    dy = torch.randn_like(x)
    y = kgn.GroupNormFunction.apply(x, w, b, GROUPS, 1e-5)
    assert torch.equal(y, kgn.group_norm_plain(x, GROUPS, w, b, 1e-5)[0])
    got = torch.autograd.grad(y, (x, w, b), dy)
    want = torch.autograd.grad(nnf.group_norm(x, GROUPS, w, b, 1e-5),
                               (x, w, b), dy)
    for a, e in zip(got, want):
        assert float((a - e).abs().max() / e.abs().max()) <= 1e-5
    w2 = w.detach()
    y = kgn.GroupNormFunction.apply(x, w2, None, GROUPS, 1e-5)
    gx, = torch.autograd.grad(y, (x,), dy)
    torch.testing.assert_close(
        gx, torch.autograd.grad(nnf.group_norm(x, GROUPS, w2, None, 1e-5),
                                (x,), dy)[0], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("chw", SHAPES)
def test_plan_covers_every_resnet_shape(chw, n):
    cluster, threads = kgn.plan(n, chw[0], GROUPS, chw[1] * chw[2])
    E = chw[0] // GROUPS * chw[1] * chw[2]
    assert cluster in (1, 2, 4, 8, 16)
    assert threads % 32 == 0 and 32 <= threads <= kgn.MAX_THREADS
    assert cluster * threads * kgn.PER_THREAD * 4 >= E
    # no fewer CTAs than the slice asks for, all resident
    assert cluster == min(kgn.MAX_CLUSTER, 2 ** max(
        0, (E - 1) // kgn.SLICE).bit_length())
    assert n * GROUPS * cluster <= kgn.RESIDENT_CTAS


def test_plan_refuses_a_group_the_kernel_cannot_hold():
    assert kgn.plan(1, 4, 4, kgn.MAX_GROUP)[0] == kgn.MAX_CLUSTER
    with pytest.raises(ValueError):
        kgn.plan(1, 4, 4, kgn.MAX_GROUP + 1)


def test_resnet_shapes_are_the_cards_tests():
    """The card's tests cover every GroupNorm of a full-width HMR forward,
    53 calls of 12 shapes."""
    model = HMR()
    seen = []
    handles = [m.register_forward_pre_hook(
        lambda mod, args: seen.append(tuple(args[0].shape[1:])))
        for m in model.modules() if isinstance(m, GroupNorm32)]
    with torch.no_grad():
        model(torch.zeros((1, 3, 224, 224)))
    for h in handles:
        h.remove()
    assert len(seen) == 53
    assert tuple(dict.fromkeys(seen)) == SHAPES


def test_refuses_other_devices():
    with pytest.raises(ValueError):
        kgn.group_norm(torch.zeros((1, 4, 2), device="meta"), 2)


@pytest.mark.parametrize("scale,offset", [(1e-3, 0.0), (1e-3, 1.0)])
def test_plain_statistics_against_float64(scale, offset):
    """The kernel's statistics (two passes, eps inside the rsqrt) where a
    group's variance is near eps, and where its mean lies far above its
    spread: a one-pass variance (E[x^2] - mean^2) loses the variance to
    cancellation there, and a dropped eps moves rstd by half."""
    x = _inputs((2, 64, 28, 28), seed=9)[0] * scale + offset
    _, mean, rstd = kgn.group_norm_plain(x, GROUPS, None, None, 1e-5)
    xr = x.double().reshape(2, GROUPS, -1)
    want_mean = xr.mean(-1)
    want_rstd = torch.rsqrt(xr.var(-1, unbiased=False) + 1e-5)
    assert float(((mean - want_mean).abs() / want_mean.abs()).max()) <= 1e-6
    assert float(((rstd - want_rstd).abs() / want_rstd).max()) <= 1e-6


@pytest.mark.parametrize("config", ["dynaboa_3dpw", "dynaboa_webcam"])
def test_rows_per_frame_match_the_engines_forwards(config):
    """``group_norm_roofline.engine`` counts 4 + 5 n GroupNorm rows a 3DPW
    frame (2 + 4 n a webcam frame): a hook on the network's first
    GroupNorm counts the images of every forward of one engine step on the
    CPU at fixed caps."""
    with open(os.path.join(ROOT, "perfbench", "configs",
                           f"{config}.json")) as f:
        spec = json.load(f)
    metric = found.module("metrics", "group_norm_roofline.engine", ROOT)
    system = build_system(AdaptConfig(**spec["adapt"]), None, "cpu",
                          compute_metrics=spec["compute_metrics"],
                          model_kwargs=dict(layers=(1, 1, 1, 1), width=16,
                                            regressor_dim=128),
                          num_vertices=256)
    rows = []
    system.model.bn1.register_forward_pre_hook(
        lambda mod, args: rows.append(args[0].shape[0]))
    g = torch.Generator().manual_seed(0)
    xy = torch.rand((1, 49, 2), generator=g) * 2 - 1
    frame = Frame(image=torch.randn((1, 224, 224, 3), generator=g),
                  j2d=torch.cat([xy, torch.ones((1, 49, 1))], -1),
                  pose=torch.zeros((1, 72)), betas=torch.zeros((1, 10)),
                  gender=torch.zeros((1,), dtype=torch.int32))
    engine = system.engine
    state = engine.init_state(system.params)
    for cap in (0, 2, 0):
        rows.clear()
        state, out = engine.step(state, frame, cos_sim_threshold=-1.0,
                                 extra_cap=cap)
        n = int(out["optim_steps"]) + 1
        assert n == cap + 1
        assert sum(rows) == metric.rows_per_frame(spec["adapt"], n)
