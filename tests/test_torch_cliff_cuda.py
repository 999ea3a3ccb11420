"""CLIFF on a card: the three Hopper kernels at every convolution and
GroupNorm shape of its HRNet-W48 trunk at 256x192 and N = 1, 2, 3 against
ATen with TF32 off (the tolerances of ``test_torch_conv_cuda.py`` and
``test_torch_group_norm_cuda.py``; the data gradient against float64), the
launches of one forward and one backward, and CLIFF
at the published widths through ``BilevelEngine.step``: the CUDA graphs of
its gradient evaluations against the same engine run eagerly, over 8
frames at the per-frame caps of the benchmark's traced segment (0, 7, 0, 6,
1, 3, 1, 3; threshold -1), with the configuration, the seeded inputs and
the boxed frames of ``perfbench/configs/cliff_hr48_3dpw.json`` and its
traffic mix.

These tests need a CUDA card and skip without one.  The file imports no jax
(the card's machine has none), so on the card it runs without the suite's
conftest:

  python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cliff_cuda.py
"""

import json
import math
import os

import pytest
import torch
import torch.nn.functional as nnf

from test_torch_conv_cuda import FWD_TOL as CONV_TOL
from test_torch_conv_cuda import check_dgrad, dgrad_inputs
from test_torch_graphs_cuda import TOL, WARM_FRAMES, eager_twin, run_pair
from test_torch_group_norm_cuda import FWD_TOL as GN_TOL
from test_torch_group_norm_cuda import GRAD_TOL as GN_GRAD_TOL
from test_torch_group_norm_cuda import STAT_TOL
from torch_conv_shapes import HRNET_SHAPES as CONV_SHAPES

from dynaboa_tpu_torch.engine.bilevel import Frame
from dynaboa_tpu_torch.kernels import conv as kc
from dynaboa_tpu_torch.kernels import group_norm as kgn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 8
GROUPS = 4
# (C, H, W) of CLIFF's GroupNorms: the 22 shapes of the 325 calls
GN_SHAPES = (
    (64, 128, 96), (64, 64, 48), (256, 64, 48), (48, 64, 48), (96, 32, 24),
    (48, 32, 24), (192, 16, 12), (48, 16, 12), (96, 16, 12), (384, 8, 6),
    (48, 8, 6), (96, 8, 6), (192, 8, 6), (32, 64, 48), (128, 64, 48),
    (64, 32, 24), (256, 32, 24), (128, 16, 12), (512, 16, 12), (256, 8, 6),
    (1024, 8, 6), (2048, 8, 6))


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels and CUDA graphs have no "
                    "CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gap(a, b) -> float:
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp(min=1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_kernel_matches_aten(cuda_device, shape, n):
    (C, H, W), K, k, s, p = shape
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape[0]) + n)
    x = torch.randn((n, C, H, W), generator=g, device=cuda_device)
    w = torch.randn((K, C, k, k), generator=g, device=cuda_device) * (
        2.0 / (k * k * K)) ** 0.5
    before = kc.conv2d.launches
    y = kc.conv2d(x, w, None, (s, s), (p, p))
    assert kc.conv2d.launches == before + 1
    ref = nnf.conv2d(x, w, None, s, p)
    torch.cuda.synchronize()
    assert y.shape == ref.shape and y.stride() == ref.stride()
    assert _gap(y, ref) <= CONV_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("shape", CONV_SHAPES[1:])
def test_dgrad_kernel_matches_float64(cuda_device, shape, n):
    """The data gradient at every shape but the stem's first (whose input
    is the image), within ``DGRAD_TOL`` of a float64
    ``convolution_backward``, in ATen's layout, and the same bits twice."""
    _, _, _, s, p = shape
    check_dgrad(*dgrad_inputs(n, shape, cuda_device,
                              seed=sum(shape[0]) + shape[1] + n), s, p)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3])
def test_conv_kernel_on_the_sliced_nhwc_crop(cuda_device, n):
    """The stem's first convolution reads the 256^2 NHWC crop's columns
    32:-32 as a strided channels_last view; the output keeps ATen's
    layout."""
    g = torch.Generator(device=cuda_device).manual_seed(n)
    crop = torch.randn((n, 256, 256, 3), generator=g, device=cuda_device)
    x = crop.permute(0, 3, 1, 2)[..., 32:224]
    w = torch.randn((64, 3, 3, 3), generator=g, device=cuda_device) * 0.2
    y = kc.conv2d(x, w, None, (2, 2), (1, 1))
    ref = nnf.conv2d(x, w, None, 2, 1)
    assert y.stride() == ref.stride()
    assert _gap(y, ref) <= CONV_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("chw", GN_SHAPES)
def test_group_norm_kernel_matches_aten(cuda_device, chw, n):
    g = torch.Generator(device=cuda_device).manual_seed(sum(chw) + n)
    x = torch.randn((n, *chw), generator=g, device=cuda_device,
                    requires_grad=True)
    w = (1.0 + 0.1 * torch.randn((chw[0],), generator=g,
                                 device=cuda_device)).requires_grad_(True)
    b = (0.1 * torch.randn((chw[0],), generator=g,
                           device=cuda_device)).requires_grad_(True)
    y = kgn.group_norm(x, GROUPS, w, b, 1e-5)
    ref = nnf.group_norm(x, GROUPS, w, b, 1e-5)
    _, mean, rstd = kgn.launch(x.detach(), GROUPS, w.detach(), b.detach(),
                               1e-5)
    _, ref_mean, ref_rstd = torch.ops.aten.native_group_norm(
        x.detach(), w.detach(), b.detach(), n, chw[0], chw[1] * chw[2],
        GROUPS, 1e-5)
    assert _gap(y, ref) <= GN_TOL
    assert _gap(mean, ref_mean) <= STAT_TOL
    assert _gap(rstd, ref_rstd) <= STAT_TOL
    dy = torch.randn_like(ref)
    got = torch.autograd.grad(y, (x, w, b), dy)
    want = torch.autograd.grad(ref, (x, w, b), dy)
    for name, a, r in zip(("x", "weight", "bias"), got, want):
        assert _gap(a, r) <= GN_GRAD_TOL, name


def _config():
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "cliff_hr48_3dpw.json")) as f:
        return json.load(f)


@pytest.mark.cuda
def test_launches_per_cliff_forward(cuda_device):
    """325 convolution and 325 GroupNorm kernel launches a forward, with
    and without gradients, and 324 data-gradient launches a backward."""
    from dynaboa_tpu_torch.models.cliff import CLIFF

    model = CLIFF(**_config()["model"]).to(cuda_device).eval()
    x = torch.randn((2, 256, 256, 3), device=cuda_device).permute(0, 3, 1, 2)
    box = torch.tensor([[540.0, 960.0, 1000.0, 1080.0, 1920.0]] * 2,
                       device=cuda_device)
    for grad in (False, True):
        conv0, gn0 = kc.conv2d.launches, kgn.group_norm.launches
        with torch.set_grad_enabled(grad):
            model(x, box)
        assert kc.conv2d.launches - conv0 == 325
        assert kgn.group_norm.launches - gn0 == 325
    # the backward: a data gradient for every convolution but the stem's
    # first, whose input (the crop) needs none
    dgrad0 = kc.conv2d_dgrad.launches
    out = model(x, box)
    torch.autograd.grad(sum(t.float().square().mean() for t in out[:3]),
                        list(model.parameters()), allow_unused=True)
    assert kc.conv2d_dgrad.launches - dgrad0 == 324


@pytest.fixture(scope="module")
def runs(cuda_device):
    """CLIFF adapting over 8 boxed frames through its graphs, against an
    eager twin stepped from a copy of its state at each frame."""
    import sys

    sys.path.insert(0, ROOT)
    from perfbench.harness import found

    entry = found.module("entries", "cliff_step", ROOT)
    cfg = _config()
    with open(os.path.join(ROOT, "perfbench", "traffic",
                           "cliff_geo_updates.json")) as f:
        spec = dict(json.load(f)["frames"], pool=N_FRAMES)
    seed = 20261019
    inp = entry.make_inputs(cfg, seed, cuda_device)
    system = entry.build_system(cfg, inp, cuda_device)
    engine = system.engine.engine
    frames = [Frame(**f) for f in found.module(
        "sources", "boxed_crops", ROOT).make(seed, spec, cfg, cuda_device)]
    torch.cuda.reset_peak_memory_stats(cuda_device)
    graphed = run_pair(engine, eager_twin(system, system.cfg, True),
                       system.params, frames)
    graphed["peak_bytes"] = torch.cuda.max_memory_allocated(cuda_device)
    return graphed


@pytest.mark.cuda
def test_graphed_steps_equal_eager(runs):
    """Losses and their terms, predictions and Adam's moments of each
    graphed step against the eager step from the same state, to the
    HMR configurations' ``TOL``."""
    gaps = runs["gaps"]
    print(f"\ncliff: graphed against eager {gaps}; peak "
          f"{runs['peak_bytes']} B with the eager twin")
    assert all(math.isfinite(v) and v <= TOL[k] for k, v in gaps.items()), \
        gaps
    assert all("cam_full" in o for o in runs["outs"])


@pytest.mark.cuda
def test_three_keys_captured_in_the_warm_up_and_none_after(runs):
    stats = runs["stats"]
    warm = stats[WARM_FRAMES - 1]
    assert warm["eager"] == warm["captures"] == runs["keys"] == 3
    last = stats[-1]
    assert (last["eager"], last["captures"]) == (warm["eager"],
                                                 warm["captures"])
    evaluations = sum(1 + int(o["optim_steps"]) + 1
                      for o in runs["outs"][WARM_FRAMES:])
    assert last["replays"] - warm["replays"] == evaluations
    print(f"\ncliff graph_stats after the warm-up {warm}, after 8 frames "
          f"{last}")
