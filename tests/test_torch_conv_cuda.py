"""The Hopper forward-convolution kernel on the card against ATen's
convolution (cuDNN, TF32 off), and the data-gradient kernel against a
float64 ``convolution_backward``, at every convolution shape of HMR's
ResNet-50 at 224^2 and N = 1, 2, 3 (the data gradient at every shape but
conv1's, whose input is the image).

These tests need a CUDA card and skip without one.  The file imports no jax
(the card's machine has none), so on the card it runs without the suite's
conftest:

  python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_conv_cuda.py
"""

import pytest
import torch
import torch.nn.functional as nnf

from torch_conv_shapes import RESNET50_SHAPES as SHAPES

from dynaboa_tpu_torch.kernels import conv as kc
from dynaboa_tpu_torch.models.hmr import HMR, Conv2d32

# Each output's largest difference from cuDNN's over cuDNN's largest
# magnitude.  Both sum the same float32 products in another order (the
# kernel: a CTA's share of the reduction by sequential FMAs, then the
# cluster's shares in rank order; cuDNN: its own tiling), over up to 4,608
# terms, each sum off the exact one by about sqrt(terms) ulp of the terms'
# scale: the largest gap measured on the H100 over these shapes is 3.5e-6.
FWD_TOL = 1e-5
# The data gradient's largest difference from a float64
# ``convolution_backward`` over its largest magnitude.  The kernel sums the
# same float32 products as cuDNN in another order (a CTA's share of the
# reduction K * taps by sequential FMAs, then the cluster's shares in rank
# order), over up to 4,608 terms: held to the forward's tolerance.
DGRAD_TOL = FWD_TOL


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
    """The weight's gradient is ATen's ``convolution_backward`` on the same
    saved input and weight: with cuDNN's deterministic algorithms it equals
    that of ``nnf.conv2d`` bit for bit, with and without the input's.  The
    input's gradient is the data-gradient kernel's, in ATen's layout and
    within ``DGRAD_TOL`` of ATen's (the same float32 products summed in
    another order)."""
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
    for a, e in zip((got[1], got_w), (want[1], want_w)):
        assert a.stride() == e.stride() and torch.equal(a, e)
    assert got[0].stride() == want[0].stride()
    assert _gap(got[0], want[0]) <= DGRAD_TOL


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


def dgrad_inputs(n, shape, device, seed, channels_last=False):
    """An input (its shape and layout are what the kernel reads), a weight
    and an output gradient for the data gradient of ``shape``."""
    (C, H, W), K, k, s, p = shape
    g = torch.Generator(device=device).manual_seed(seed)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x = torch.empty((n, C, H, W), device=device, memory_format=fmt)
    w = torch.randn((K, C, k, k), generator=g, device=device) * (
        2.0 / (k * k * K)) ** 0.5
    dy = torch.randn((n, K, kc.out_size(H, k, s, p), kc.out_size(W, k, s, p)),
                     generator=g, device=device).contiguous(memory_format=fmt)
    return x, w, dy


def check_dgrad(x, w, dy, s, p):
    """One launch against a float64 ``convolution_backward``, the plain
    version and ATen's float32 layout; a second launch gives the same
    bits."""
    before = kc.conv2d_dgrad.launches
    dx = kc.conv2d_dgrad(dy, w, x, (s, s), (p, p))
    assert kc.conv2d_dgrad.launches == before + 1
    args = ([s, s], [p, p], [1, 1], False, [0, 0], 1, [True, False, False])
    ref = torch.ops.aten.convolution_backward(
        dy.double(), x.double(), w.double(), None, *args)[0]
    aten = torch.ops.aten.convolution_backward(dy, x, w, None, *args)[0]
    plain = kc.conv2d_dgrad_plain(dy, w, x, (s, s), (p, p))
    torch.cuda.synchronize()
    assert dx.shape == ref.shape and dx.stride() == aten.stride()
    assert _gap(dx, ref) <= DGRAD_TOL
    assert _gap(dx, plain) <= DGRAD_TOL
    assert torch.equal(kc.conv2d_dgrad(dy, w, x, (s, s), (p, p)), dx)
    return dx


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("shape", SHAPES[1:])
def test_dgrad_matches_float64(cuda_device, shape, n):
    _, _, _, s, p = shape
    check_dgrad(*dgrad_inputs(n, shape, cuda_device, seed=sum(shape[0]) + n),
                s, p)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    ((2, 5, 9, 7), 6, 1, 2, 0),     # 1x1 stride 2: odd sizes, zeroed pixels
    ((3, 7, 11, 13), 70, 1, 1, 0),  # C and H * W no multiple of 4
    ((2, 130, 9, 11), 9, 3, 2, 1),  # a partial tile of channels, 4 phases
    ((1, 6, 8, 10), 5, 3, 2, 1),    # even sizes: a tap beyond dy's edge
    ((2, 16, 8, 8), 130, 3, 1, 1),  # a long reduction of few channels
])
def test_dgrad_ragged_shapes(cuda_device, case):
    """Shapes off the tile grid, in both layouts: the zero-filled loads at
    the edges, the element-wise stores and the phases' own pixel counts."""
    (n, C, H, W), K, k, s, p = case
    for cl in (False, True):
        dx = check_dgrad(*dgrad_inputs(n, ((C, H, W), K, k, s, p),
                                       cuda_device, seed=C + K, channels_last=cl),
                         s, p)
        assert dx.is_contiguous(memory_format=torch.channels_last if cl
                                else torch.contiguous_format)
        if k == 1 and s == 2:
            assert not dx[:, :, 1::2].any() and not dx[:, :, :, 1::2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [SHAPES[2], SHAPES[6], SHAPES[8]])
def test_dgrad_channels_last_and_strided(cuda_device, shape):
    """A channels_last input gives a channels_last gradient, as ATen's;
    an output gradient of any strides (a transposed view) is read as it
    is."""
    _, _, _, s, p = shape
    check_dgrad(*dgrad_inputs(2, shape, cuda_device, seed=3,
                              channels_last=True), s, p)
    x, w, dy = dgrad_inputs(2, shape, cuda_device, seed=4)
    view = dy.transpose(2, 3).contiguous().transpose(2, 3)
    assert not view.is_contiguous()
    assert torch.equal(kc.conv2d_dgrad(view, w, x, (s, s), (p, p)),
                       kc.conv2d_dgrad(dy, w, x, (s, s), (p, p)))


@pytest.mark.cuda
def test_dgrad_graph_replay_bit_equal_to_eager(cuda_device):
    shape = SHAPES[18]     # 3x3, stride 2: four phases
    x, w, dy = dgrad_inputs(3, shape, cuda_device, seed=5)
    src = dy.clone()
    kc.conv2d_dgrad(src, w, x, (2, 2), (1, 1))        # loads the library
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = kc.conv2d_dgrad.launches
    with torch.cuda.graph(graph):
        dx_g = kc.conv2d_dgrad(src, w, x, (2, 2), (1, 1))
    assert kc.conv2d_dgrad.launches == before + 1
    for seed in (6, 7):
        src.copy_(dgrad_inputs(3, shape, cuda_device, seed=seed)[2])
        graph.replay()
        dx = kc.conv2d_dgrad(src, w, x, (2, 2), (1, 1))
        torch.cuda.synchronize()
        assert torch.equal(dx_g, dx)
    assert kc.conv2d_dgrad.launches == before + 3     # replays bypass it


@pytest.mark.cuda
def test_dgrad_launches_per_hmr_backward(cuda_device):
    """52 data-gradient launches a backward: every convolution but conv1,
    whose input (the image) needs no gradient; none in bfloat16."""
    model = HMR().to(cuda_device)
    x = torch.randn((2, 224, 224, 3), device=cuda_device).permute(0, 3, 1, 2)
    before = kc.conv2d_dgrad.launches
    out = model(x)
    torch.autograd.grad(sum(t.float().square().mean() for t in out[:3]),
                        list(model.parameters()), allow_unused=True)
    assert kc.conv2d_dgrad.launches == before + 52
    bf16 = HMR(compute_dtype="bfloat16").to(cuda_device)
    before = kc.conv2d_dgrad.launches
    out = bf16(x)
    torch.autograd.grad(sum(t.float().square().mean() for t in out[:3]),
                        list(bf16.parameters()), allow_unused=True)
    assert kc.conv2d_dgrad.launches == before
