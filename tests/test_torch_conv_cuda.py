"""The Hopper forward-convolution kernel on the card against ATen's
convolution (cuDNN, TF32 off), at every convolution shape of HMR's
ResNet-50 at 224^2 and N = 1, 2, 3.

These tests need a CUDA card and skip without one.  The file imports no jax
(the card's machine has none), so on the card it runs without the suite's
conftest:

  python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_conv_cuda.py
"""

import pytest
import torch
import torch.nn.functional as nnf

from dynaboa_tpu_torch.kernels import conv as kc
from dynaboa_tpu_torch.models.hmr import HMR, Conv2d32

# Each output's largest difference from cuDNN's over cuDNN's largest
# magnitude.  Both sum the same float32 products in another order (the
# kernel: a CTA's share of the reduction by sequential FMAs, then the
# cluster's shares in rank order; cuDNN: its own tiling), over up to 4,608
# terms, each sum off the exact one by about sqrt(terms) ulp of the terms'
# scale: the largest gap measured on the H100 over these shapes is 3.5e-6.
FWD_TOL = 1e-5
# ((C, H, W), K, kernel, stride, padding) of ResNet-50's convolutions at
# 224^2 in the order of their first call: the 23 shapes of the 53 calls
SHAPES = (((3, 224, 224), 64, 7, 2, 3), ((64, 56, 56), 64, 1, 1, 0),
          ((64, 56, 56), 64, 3, 1, 1), ((64, 56, 56), 256, 1, 1, 0),
          ((256, 56, 56), 64, 1, 1, 0), ((256, 56, 56), 128, 1, 1, 0),
          ((128, 56, 56), 128, 3, 2, 1), ((128, 28, 28), 512, 1, 1, 0),
          ((256, 56, 56), 512, 1, 2, 0), ((512, 28, 28), 128, 1, 1, 0),
          ((128, 28, 28), 128, 3, 1, 1), ((512, 28, 28), 256, 1, 1, 0),
          ((256, 28, 28), 256, 3, 2, 1), ((256, 14, 14), 1024, 1, 1, 0),
          ((512, 28, 28), 1024, 1, 2, 0), ((1024, 14, 14), 256, 1, 1, 0),
          ((256, 14, 14), 256, 3, 1, 1), ((1024, 14, 14), 512, 1, 1, 0),
          ((512, 14, 14), 512, 3, 2, 1), ((512, 7, 7), 2048, 1, 1, 0),
          ((1024, 14, 14), 2048, 1, 2, 0), ((2048, 7, 7), 512, 1, 1, 0),
          ((512, 7, 7), 512, 3, 1, 1))


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(n, shape, device, seed, grad=False):
    (C, H, W), K, k, _, _ = shape
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, C, H, W), generator=g, device=device)
    w = torch.randn((K, C, k, k), generator=g, device=device) * (
        2.0 / (k * k * K)) ** 0.5
    if grad:
        x.requires_grad_(True)
        w.requires_grad_(True)
    return x, w


def _gap(a, b) -> float:
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp(min=1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_aten(cuda_device, shape, n):
    _, _, _, s, p = shape
    x, w = _inputs(n, shape, cuda_device, seed=sum(shape[0]) + n)
    before = kc.conv2d.launches
    y = kc.conv2d(x, w, None, (s, s), (p, p))
    assert kc.conv2d.launches == before + 1
    ref = nnf.conv2d(x, w, None, s, p)
    plain = kc.conv2d_plain(x, w, (s, s), (p, p))
    torch.cuda.synchronize()
    assert y.shape == ref.shape and y.stride() == ref.stride()
    assert _gap(y, ref) <= FWD_TOL
    assert _gap(y, plain) <= FWD_TOL
    # deterministic: a second launch gives the same bits
    assert torch.equal(kc.conv2d(x, w, None, (s, s), (p, p)), y)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("shape", SHAPES)
def test_gradients_are_atens(cuda_device, shape, n):
    """The backward is ATen's ``convolution_backward`` on the same saved
    input and weight: with cuDNN's deterministic algorithms, the gradients
    equal those of ``nnf.conv2d`` bit for bit, and a mask that leaves out
    the input's gradient is honoured."""
    _, _, _, s, p = shape
    x, w = _inputs(n, shape, cuda_device, seed=3 * sum(shape[0]) + n,
                   grad=True)
    dy = torch.randn_like(nnf.conv2d(x.detach(), w.detach(), None, s, p))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        got = torch.autograd.grad(kc.conv2d(x, w, None, (s, s), (p, p)),
                                  (x, w), dy)
        want = torch.autograd.grad(nnf.conv2d(x, w, None, s, p), (x, w), dy)
        x0 = x.detach()
        got_w, = torch.autograd.grad(kc.conv2d(x0, w, None, (s, s), (p, p)),
                                     (w,), dy)
        want_w, = torch.autograd.grad(nnf.conv2d(x0, w, None, s, p), (w,),
                                      dy)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for a, e in zip((*got, got_w), (*want, want_w)):
        assert a.stride() == e.stride() and torch.equal(a, e)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3])
def test_conv1_channels_last_input(cuda_device, n):
    """conv1 reads a channels_last view of the NHWC crop, as the engine
    gives it: the output is channels_last, as ATen's is, and so are the
    gradients."""
    shape = SHAPES[0]
    g = torch.Generator(device=cuda_device).manual_seed(n)
    nhwc = torch.randn((n, 224, 224, 3), generator=g, device=cuda_device)
    x = nhwc.permute(0, 3, 1, 2)
    w = _inputs(1, shape, cuda_device, seed=n)[1].requires_grad_(True)
    y = kc.conv2d(x, w, None, (2, 2), (3, 3))
    ref = nnf.conv2d(x, w, None, 2, 3)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert y.stride() == ref.stride()
    assert _gap(y, ref) <= FWD_TOL
    dy = torch.randn_like(ref)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        got, = torch.autograd.grad(y, (w,), dy)
        want, = torch.autograd.grad(ref, (w,), dy)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert got.stride() == want.stride() and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    ((2, 5, 9, 9), (6, 5, 3, 3), 2, 1),      # ragged tiles, odd sizes
    ((3, 7, 11, 13), (70, 7, 1, 1), 1, 0),   # K and P*Q no multiple of 4
    ((1, 3, 10, 10), (5, 3, 7, 7), 2, 3),    # conv1's kernel on odd K
    ((2, 16, 8, 8), (130, 16, 3, 3), 1, 1),  # a partial tile of channels
])
def test_ragged_shapes(cuda_device, case):
    """Shapes off the tile grid: the zero-filled loads at the edges and the
    element-wise stores, in both output layouts."""
    xs, ws, s, p = case
    g = torch.Generator(device=cuda_device).manual_seed(sum(xs))
    x = torch.randn(xs, generator=g, device=cuda_device)
    w = torch.randn(ws, generator=g, device=cuda_device)
    for xin in (x, x.to(memory_format=torch.channels_last)):
        y = kc.conv2d(xin, w, None, (s, s), (p, p))
        ref = nnf.conv2d(xin, w, None, s, p)
        assert y.stride() == ref.stride()
        assert _gap(y, ref) <= FWD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[2]])
def test_unaligned_operands(cuda_device, shape):
    """An input and a weight 4 bytes past a 16-byte boundary: the kernel
    takes them element by element, with the aligned case's results."""
    _, _, _, s, p = shape
    x, w = _inputs(2, shape, cuda_device, seed=9)
    xo = torch.empty(x.numel() + 1, device=cuda_device)[1:].view(x.shape)
    wo = torch.empty(w.numel() + 1, device=cuda_device)[1:].view(w.shape)
    xo.copy_(x)
    wo.copy_(w)
    y = kc.conv2d(xo, wo, None, (s, s), (p, p))
    assert _gap(y, nnf.conv2d(x, w, None, s, p)) <= FWD_TOL


@pytest.mark.cuda
def test_graph_replay_bit_equal_to_eager(cuda_device):
    shape = SHAPES[-1]
    x, w = _inputs(3, shape, cuda_device, seed=5)
    src = x.clone()
    kc.conv2d(src, w, None, (1, 1), (1, 1))           # loads the library
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = kc.conv2d.launches
    with torch.cuda.graph(graph):
        y_g = kc.conv2d(src, w, None, (1, 1), (1, 1))
    assert kc.conv2d.launches == before + 1           # the capturing call
    for seed in (6, 7):
        src.copy_(_inputs(3, shape, cuda_device, seed=seed)[0])
        graph.replay()
        y = kc.conv2d(src, w, None, (1, 1), (1, 1))
        torch.cuda.synchronize()
        assert torch.equal(y_g, y)
    assert kc.conv2d.launches == before + 3           # replays bypass it


@pytest.mark.cuda
def test_launches_per_hmr_forward(cuda_device):
    model = HMR().to(cuda_device)
    assert sum(isinstance(m, Conv2d32) for m in model.modules()) == 53
    x = torch.randn((2, 224, 224, 3), device=cuda_device).permute(0, 3, 1, 2)
    for grad in (False, True):
        before = kc.conv2d.launches
        with torch.set_grad_enabled(grad):
            model(x)
        assert kc.conv2d.launches == before + 53
    # the bfloat16 arm keeps ATen's convolution
    bf16 = HMR(compute_dtype="bfloat16").to(cuda_device)
    before = kc.conv2d.launches
    with torch.no_grad():
        bf16(x)
    assert kc.conv2d.launches == before


@pytest.mark.cuda
def test_refuses_what_it_does_not_take(cuda_device):
    x, w = _inputs(1, SHAPES[1], cuda_device, seed=1)
    with pytest.raises(TypeError):
        kc.conv2d(x.double(), w.double())
    with pytest.raises(ValueError):
        kc.conv2d(x, w.cpu())
    with pytest.raises(ValueError):
        kc.conv2d(x, w, torch.zeros(64, device=cuda_device))
    with pytest.raises(ValueError):
        kc.conv2d(x, w[:, :32].contiguous())
