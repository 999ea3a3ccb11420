"""The dual-head BatchNorm HMRISO of the port against the flax HMRISO, on
the flax variables (params and random running statistics) carried across
with ``iso_params_from_jax``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dynaboa_tpu.models.hmr import HMRISO as JHMRISO
from dynaboa_tpu_torch.models import hmr as thmr
from tests import torch_port_fixtures as F

RDIM = 64
# test_torch_hmr.py's tolerances (fp32 convolutions in another summation
# order); measured worst gap 1.1e-5 (rotmats), 7.5e-9 (shape and cam)
RTOL = 1e-4
ATOL = 1e-4


@pytest.fixture(scope="module")
def nets():
    jmodel = JHMRISO(layers=F.LAYERS, width=F.WIDTH, regressor_dim=RDIM)
    variables = jax.jit(lambda r: jmodel.init(
        r, jnp.zeros((1, F.IMG, F.IMG, 3))))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    stats = {}
    for name, s in variables["batch_stats"].items():
        n = s["mean"].shape[0]
        stats[name] = {"mean": jnp.asarray(rng.normal(scale=0.1, size=n),
                                           jnp.float32),
                       "var": jnp.asarray(rng.uniform(0.5, 2.0, size=n),
                                          jnp.float32)}
    variables = {"params": variables["params"], "batch_stats": stats}
    tnet = thmr.HMRISO(layers=F.LAYERS, width=F.WIDTH, regressor_dim=RDIM)
    missing, unexpected = tnet.load_state_dict(
        thmr.iso_params_from_jax(variables), strict=False)
    return jmodel, variables, tnet.eval(), missing, unexpected


def test_every_flax_variable_is_carried_across(nets):
    _, variables, _, missing, unexpected = nets
    assert not unexpected
    assert {k.rsplit(".", 1)[-1] for k in missing} <= {
        "init_pose", "init_shape", "init_cam", "num_batches_tracked"}
    n_flax = sum(np.asarray(a).size
                 for a in jax.tree.leaves(variables))
    sd = thmr.iso_params_from_jax(variables)
    assert sum(v.numel() for v in sd.values()) == n_flax
    assert "layer1.0.downsample.1.running_var" in sd
    assert "ssl.decpose.weight" in sd and "fsl.fc1.bias" in sd


@pytest.mark.parametrize("batch,n_iter", [(1, None), (2, 2)])
def test_forward_matches_flax(nets, batch, n_iter):
    jmodel, variables, tnet, _, _ = nets
    x = np.random.default_rng(batch).normal(
        size=(batch, F.IMG, F.IMG, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, n_iter=n_iter))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = tnet(torch.as_tensor(x).permute(0, 3, 1, 2), n_iter=n_iter)
    assert len(got) == len(want) == 6
    shapes = [(batch, 24, 3, 3), (batch, 10), (batch, 3)] * 2
    for i, (a, b, shape) in enumerate(zip(got, want, shapes)):
        assert a.shape == shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=f"output {i}")
    # the heads are separate: fsl and ssl differ
    assert not np.allclose(got[2].numpy(), got[5].numpy())


def test_seeded_init_covers_batchnorm():
    a = thmr.init_weights_(thmr.HMRISO(layers=F.LAYERS, width=F.WIDTH,
                                       regressor_dim=RDIM),
                           torch.Generator().manual_seed(3))
    b = thmr.init_weights_(thmr.HMRISO(layers=F.LAYERS, width=F.WIDTH,
                                       regressor_dim=RDIM),
                           torch.Generator().manual_seed(3))
    for (k, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), k
    assert torch.equal(a.bn1.weight, torch.ones(F.WIDTH))
    assert float(a.ssl.decpose.weight.detach().abs().max()) < 0.01
