"""The Hopper GroupNorm kernel on the card against ATen's GroupNorm, at every
GroupNorm shape of HMR's ResNet-50 at 224^2 and N = 1, 2, 3.

These tests need a CUDA card and skip without one.  The file imports no jax
(the card's machine has none), so on the card it runs without the suite's
conftest:

  python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_group_norm_cuda.py
"""

import pytest
import torch
import torch.nn.functional as nnf

from dynaboa_tpu_torch.kernels import group_norm as kgn
from dynaboa_tpu_torch.models.hmr import HMR, GroupNorm32

# Each output's largest difference from ATen's over ATen's largest
# magnitude.  The forward takes the same float32 statistics with sums in
# another order (a CTA tree and a cluster of partials against ATen's
# Welford rows) and applies (x - mean) * (rstd * gamma) + beta where ATen
# applies a * x + b: a few ulp of the output's scale (the largest gap
# measured on the H100 over these shapes is 2.2e-7).  The gradients are
# ATen's own backward kernels fed those statistics.
FWD_TOL = 1e-6
STAT_TOL = 1e-6
GRAD_TOL = 2e-5
# (C, H, W) of ResNet-50's GroupNorms at 224^2 (conv1, then each stage's
# bn1 before and after its stride, bn2, bn3 and downsample), all 53 calls'
SHAPES = ((64, 112, 112), (64, 56, 56), (256, 56, 56), (128, 56, 56),
          (128, 28, 28), (512, 28, 28), (256, 28, 28), (256, 14, 14),
          (1024, 14, 14), (512, 14, 14), (512, 7, 7), (2048, 7, 7))
GROUPS = 4


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, device, seed, grad=False):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=device) * 2.0 + 0.5
    C = shape[1]
    w = 1.0 + 0.5 * torch.randn((C,), generator=g, device=device)
    b = 0.5 * torch.randn((C,), generator=g, device=device)
    if grad:
        for t in (x, w, b):
            t.requires_grad_(True)
    return x, w, b


def _gap(a, b) -> float:
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp(min=1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("chw", SHAPES)
def test_forward_matches_aten(cuda_device, chw, n):
    x, w, b = _inputs((n, *chw), cuda_device, seed=sum(chw) + n)
    before = kgn.group_norm.launches
    y = kgn.group_norm(x, GROUPS, w, b, 1e-5)
    assert kgn.group_norm.launches == before + 1
    ref = nnf.group_norm(x, GROUPS, w, b, 1e-5)
    _, mean, rstd = kgn.launch(x, GROUPS, w, b, 1e-5)
    _, ref_mean, ref_rstd = torch.ops.aten.native_group_norm(
        x, w, b, n, chw[0], chw[1] * chw[2], GROUPS, 1e-5)
    torch.cuda.synchronize()
    assert y.shape == ref.shape and y.stride() == ref.stride()
    assert _gap(y, ref) <= FWD_TOL
    assert _gap(mean, ref_mean) <= STAT_TOL
    assert _gap(rstd, ref_rstd) <= STAT_TOL
    # deterministic: a second launch gives the same bits
    assert torch.equal(kgn.group_norm(x, GROUPS, w, b, 1e-5), y)


@pytest.mark.cuda
@pytest.mark.parametrize("chw", [SHAPES[0], SHAPES[-1]])
def test_variance_near_eps_matches_aten(cuda_device, chw):
    """Inputs scaled by 1e-3, so that each group's variance (about 4e-6)
    is of eps's size: a dropped or misplaced eps moves rstd by far more
    than the tolerance."""
    x, w, b = _inputs((2, *chw), cuda_device, seed=sum(chw))
    x = x * 1e-3
    y, mean, rstd = kgn.launch(x, GROUPS, w, b, 1e-5)
    ref, ref_mean, ref_rstd = torch.ops.aten.native_group_norm(
        x, w, b, 2, chw[0], chw[1] * chw[2], GROUPS, 1e-5)
    assert _gap(y, ref) <= FWD_TOL
    assert _gap(mean, ref_mean) <= STAT_TOL
    assert _gap(rstd, ref_rstd) <= STAT_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("chw", [SHAPES[0], SHAPES[-1]])
def test_statistics_against_float64(cuda_device, chw):
    """A group whose mean (1) lies far above its spread (2e-3): the kernel's
    centred second pass keeps the variance, where a one-pass E[x^2] -
    mean^2 in float32 loses about 1 % of rstd to cancellation."""
    x = _inputs((2, *chw), cuda_device, seed=sum(chw) + 1)[0] * 1e-3 + 1.0
    _, mean, rstd = kgn.launch(x, GROUPS, None, None, 1e-5)
    xr = x.double().reshape(2, GROUPS, -1)
    want_rstd = torch.rsqrt(xr.var(-1, unbiased=False) + 1e-5)
    assert _gap(mean, xr.mean(-1)) <= STAT_TOL
    assert float(((rstd - want_rstd).abs() / want_rstd).max()) <= STAT_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("chw", SHAPES)
def test_gradients_match_aten(cuda_device, chw, n):
    x, w, b = _inputs((n, *chw), cuda_device, seed=7 * sum(chw) + n,
                      grad=True)
    dy = torch.randn_like(x)
    got = torch.autograd.grad(kgn.group_norm(x, GROUPS, w, b, 1e-5),
                              (x, w, b), dy)
    want = torch.autograd.grad(nnf.group_norm(x, GROUPS, w, b, 1e-5),
                               (x, w, b), dy)
    torch.cuda.synchronize()
    for name, a, r in zip(("x", "weight", "bias"), got, want):
        assert _gap(a, r) <= GRAD_TOL, name


@pytest.mark.cuda
def test_channels_last_input(cuda_device):
    """Made contiguous as ATen's GroupNorm makes it; the output has ATen's
    layout, so the convolutions after it see the same tensors."""
    x, w, b = _inputs((2, 256, 56, 56), cuda_device, seed=3, grad=True)
    xl = x.detach().to(memory_format=torch.channels_last).requires_grad_(True)
    y = kgn.group_norm(xl, GROUPS, w, b, 1e-5)
    ref = nnf.group_norm(xl, GROUPS, w, b, 1e-5)
    assert y.stride() == ref.stride()
    assert _gap(y, ref) <= FWD_TOL
    dy = torch.randn_like(ref)
    g = torch.autograd.grad(y, (xl, w, b), dy)
    r = torch.autograd.grad(ref, (xl, w, b), dy)
    for a, e in zip(g, r):
        assert a.stride() == e.stride()
        assert _gap(a, e) <= GRAD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups", [((2, 6, 5, 3), 3), ((1, 8, 7),
                                                              2)])
def test_element_wise_path(cuda_device, shape, groups):
    """A group whose size is no multiple of 4, and a row start that is not
    16-byte aligned: the kernel's element-wise loads and stores."""
    x, w, b = _inputs(shape, cuda_device, seed=11)
    torch.testing.assert_close(kgn.group_norm(x, groups, w, b, 1e-5),
                               nnf.group_norm(x, groups, w, b, 1e-5),
                               atol=1e-5, rtol=1e-5)
    buf = torch.randn(8 * 4 * 4 + 1, device=cuda_device)
    xo = buf[1:].view(8, 4, 4)         # 4 bytes past the allocation's start
    torch.testing.assert_close(kgn.group_norm(xo, 2, None, None, 1e-5),
                               nnf.group_norm(xo, 2, None, None, 1e-5),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_graph_replay_bit_equal_to_eager(cuda_device):
    shape = (3, 64, 112, 112)
    x, w, b = _inputs(shape, cuda_device, seed=5)
    src = x.clone()
    kgn.launch(src, GROUPS, w, b, 1e-5)             # loads the library
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = kgn.group_norm.launches
    with torch.cuda.graph(graph):
        y_g, mean_g, rstd_g = kgn.launch(src, GROUPS, w, b, 1e-5)
        z_g = kgn.group_norm(src, GROUPS, w, b, 1e-5)
    assert kgn.group_norm.launches == before + 1    # the capturing call
    for seed in (6, 7):
        src.copy_(_inputs(shape, cuda_device, seed=seed)[0])
        graph.replay()
        y, mean, rstd = kgn.launch(src, GROUPS, w, b, 1e-5)
        torch.cuda.synchronize()
        assert torch.equal(y_g, y) and torch.equal(z_g, y)
        assert torch.equal(mean_g, mean) and torch.equal(rstd_g, rstd)
    assert kgn.group_norm.launches == before + 1    # replays bypass it


@pytest.mark.cuda
def test_launches_per_hmr_forward(cuda_device):
    model = HMR().to(cuda_device)
    assert sum(isinstance(m, GroupNorm32) for m in model.modules()) == 53
    x = torch.randn((2, 3, 224, 224), device=cuda_device)
    for grad in (False, True):
        before = kgn.group_norm.launches
        with torch.set_grad_enabled(grad):
            model(x)
        assert kgn.group_norm.launches == before + 53


@pytest.mark.cuda
def test_refuses_what_it_does_not_take(cuda_device):
    x, w, b = _inputs((1, 64, 8, 8), cuda_device, seed=1)
    with pytest.raises(TypeError):
        kgn.group_norm(x.double(), GROUPS, w.double(), b.double())
    with pytest.raises(ValueError):
        kgn.group_norm(x, GROUPS, w.cpu(), b)
    with pytest.raises(ValueError):
        kgn.group_norm(x, 3, w, b)
