"""The port's bf16 HMR (autocast backbone) against the JAX
``HMR(compute_dtype="bfloat16")`` on the same params and input.

bf16 rounding is not bitwise across the two packages (XLA and oneDNN
round the convolutions' outputs at other points), so the port's bf16
outputs are held to the JAX package's own bf16-vs-fp32 gap:
``max|port16 - jax16| <= max(2 * max|jax16 - jax32|, 1e-3)``.  Measured at
these sizes on the CPU: the ratio ``max|port16 - jax16| / max|jax16 -
jax32|`` is 0 for taps 0-1, 0.26-0.52 for taps 2-14, 0.57 for shape, 0.53
for cam and 1.33 for rotmat, under the bound's 2."""

import numpy as np
import pytest
import torch

from dynaboa_tpu.models.hmr import HMR as JHMR
from dynaboa_tpu_torch.models.hmr import HMR as THMR, GroupNorm32
from dynaboa_tpu_torch.models.hmr import params_from_jax
from tests import torch_port_fixtures as F


@pytest.fixture(scope="module")
def run():
    jm32, jparams = F.jax_hmr(seed=1)
    jm16 = JHMR(layers=F.LAYERS, width=F.WIDTH, regressor_dim=F.RDIM,
                compute_dtype="bfloat16")
    x = np.random.default_rng(0).normal(size=(2, F.IMG, F.IMG, 3)).astype(
        np.float32)
    j32 = jm32.apply({"params": jparams}, x)
    j16 = jm16.apply({"params": jparams}, x)
    net = THMR(layers=F.LAYERS, width=F.WIDTH, regressor_dim=F.RDIM,
               compute_dtype="bfloat16")
    net.load_state_dict(params_from_jax(jparams), strict=False)
    net.eval()
    with torch.no_grad():
        t16 = net(torch.as_tensor(x).permute(0, 3, 1, 2))
    return dict(j32=j32, j16=j16, t16=t16, net=net, x=x)


def _nhwc(a: torch.Tensor) -> np.ndarray:
    a = a.float().numpy()
    return a.transpose(0, 2, 3, 1) if a.ndim == 4 else a


def test_tap_dtypes_match_jax(run):
    jdt = [str(f.dtype) for f in run["j16"][3]]
    tdt = [str(f.dtype).removeprefix("torch.") for f in run["t16"][3]]
    assert tdt == jdt
    assert tdt[0] == "bfloat16" and set(tdt[1:]) == {"float32"}
    for t in run["t16"][:3]:
        assert t.dtype == torch.float32


@pytest.mark.parametrize("name", [f"tap{i}" for i in range(15)]
                         + ["rotmat", "shape", "cam"])
def test_within_jax_bf16_gap(run, name):
    if name.startswith("tap"):
        i = int(name[3:])
        port, j16, j32 = (run["t16"][3][i], run["j16"][3][i],
                          run["j32"][3][i])
        port = _nhwc(port)
    else:
        i = ("rotmat", "shape", "cam").index(name)
        port, j16, j32 = (run["t16"][i].numpy(), run["j16"][i],
                          run["j32"][i])
    j16 = np.asarray(j16, np.float32)
    gap = float(np.abs(j16 - np.asarray(j32, np.float32)).max())
    err = float(np.abs(port - j16).max())
    assert err <= max(2.0 * gap, 1e-3), (err, gap)


def test_params_and_grads_stay_fp32(run):
    net = run["net"]
    x = torch.as_tensor(run["x"]).permute(0, 3, 1, 2)
    rotmat, shape, cam, _ = net(x)
    (rotmat.sum() + shape.sum() + cam.sum()).backward()
    for k, p in net.named_parameters():
        assert p.dtype == torch.float32, k
        assert p.grad is not None and p.grad.dtype == torch.float32, k
    net.zero_grad(set_to_none=True)


def test_groupnorm_and_regressor_outputs_fp32_under_bf16(run):
    net = run["net"]
    seen = {}

    def hook(name):
        def f(_, __, out):
            seen[name] = out.dtype
        return f

    hooks = [m.register_forward_hook(hook(n)) for n, m in net.named_modules()
             if isinstance(m, (GroupNorm32, torch.nn.Linear, torch.nn.Conv2d))]
    try:
        with torch.no_grad():
            net(torch.as_tensor(run["x"]).permute(0, 3, 1, 2))
    finally:
        for h in hooks:
            h.remove()
    gn = [n for n, m in net.named_modules() if isinstance(m, GroupNorm32)]
    dense = ["fc1", "fc2", "decpose", "decshape", "deccam"]
    convs = [n for n, m in net.named_modules()
             if isinstance(m, torch.nn.Conv2d)]
    assert gn and convs
    assert {seen[n] for n in gn} == {torch.float32}
    assert {seen[n] for n in dense} == {torch.float32}
    assert {seen[n] for n in convs} == {torch.bfloat16}


def test_fp32_model_unchanged_by_groupnorm32(run):
    """In float32 the GroupNorm's cast is a no-op: the module equals
    ``nn.GroupNorm`` bit for bit."""
    gn = GroupNorm32(4, 16, eps=1e-5)
    ref = torch.nn.GroupNorm(4, 16, eps=1e-5)
    ref.load_state_dict(gn.state_dict())
    x = torch.randn(2, 16, 5, 5, generator=torch.Generator().manual_seed(0))
    assert torch.equal(gn(x), ref(x))


def test_unknown_compute_dtype_raises():
    with pytest.raises(ValueError, match="compute_dtype"):
        THMR(layers=F.LAYERS, width=F.WIDTH, regressor_dim=F.RDIM,
             compute_dtype="float16")
