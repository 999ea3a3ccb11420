"""HMR of the port against the flax HMR: the weights converter round trip,
the 15-tap forward, the reference-checkpoint load path and the seeded
initialization."""

import numpy as np
import jax
import pytest
import torch

from dynaboa_tpu.models.hmr import convert_torch_state_dict
from dynaboa_tpu_torch.models import hmr as thmr
from tests import torch_port_fixtures as F

# fp32 convolutions and GroupNorm in another summation order
TAP_RTOL = 1e-4
TAP_ATOL = 1e-4


@pytest.fixture(scope="module")
def nets():
    jmodel, jparams = F.jax_hmr(seed=1)
    return jmodel, jparams, F.torch_hmr_from(jparams)


def test_params_from_jax_round_trips_exactly(nets):
    _, jparams, _ = nets
    back, _ = convert_torch_state_dict(thmr.params_from_jax(jparams))
    jl, jdef = jax.tree.flatten(jparams)
    bl, bdef = jax.tree.flatten(back)
    assert jdef == bdef
    for a, b in zip(jl, bl):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_state_dict_names_are_the_reference_names(nets):
    _, jparams, tnet = nets
    sd = thmr.params_from_jax(jparams)
    params = dict(tnet.named_parameters())
    assert set(sd) == set(params)
    assert "layer1.0.downsample.0.weight" in sd and "bn1.weight" in sd
    assert {"init_pose", "init_shape", "init_cam"} <= set(tnet.state_dict())


def test_forward_matches_flax_all_taps(nets, rng):
    jmodel, jparams, tnet = nets
    x = rng.normal(size=(2, F.IMG, F.IMG, 3)).astype(np.float32)
    jr, js, jc, jf = jmodel.apply({"params": jparams}, x)
    with torch.no_grad():
        tr, ts, tc, tf = tnet(torch.as_tensor(x).permute(0, 3, 1, 2))
    assert len(tf) == len(jf) == 15
    for i, (a, b) in enumerate(zip(tf, jf)):
        a = a.numpy()
        if i <= 4:          # conv taps: NCHW -> NHWC
            a = a.transpose(0, 2, 3, 1)
        np.testing.assert_allclose(a, np.asarray(b), rtol=TAP_RTOL,
                                   atol=TAP_ATOL, err_msg=f"tap {i}")
    for a, b in ((tr, jr), (ts, js), (tc, jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TAP_RTOL,
                                   atol=TAP_ATOL)


def test_load_basemodel_module_prefixed(nets, tmp_path, rng):
    """A reference checkpoint: {'model': state_dict} with DataParallel's
    'module.' prefix and the mean-parameter buffers."""
    _, jparams, tnet = nets
    sd = {f"module.{k}": v for k, v in thmr.params_from_jax(jparams).items()}
    mean_pose = rng.normal(size=(1, thmr.NPOSE)).astype(np.float32)
    sd["module.init_pose"] = torch.as_tensor(mean_pose)
    sd["module.init_shape"] = torch.zeros(1, 10)
    sd["module.init_cam"] = torch.tensor([[0.8, 0.1, 0.0]])
    path = tmp_path / "basemodel.pt"
    torch.save({"model": sd}, path)

    net = thmr.load_basemodel(str(path), torch.device("cpu"))
    assert net.layers_cfg == F.LAYERS and net.width == F.WIDTH
    assert net.regressor_dim == F.RDIM
    np.testing.assert_array_equal(net.init_pose.numpy(), mean_pose)
    for k, v in tnet.named_parameters():
        assert torch.equal(dict(net.named_parameters())[k], v), k


def test_load_basemodel_rejects_missing_weights(nets, tmp_path):
    _, jparams, _ = nets
    sd = thmr.params_from_jax(jparams)
    del sd["fc1.weight"]
    path = tmp_path / "broken.pt"
    torch.save({"model": sd}, path)
    with pytest.raises(KeyError, match="fc1.weight"):
        thmr.load_basemodel(str(path), torch.device("cpu"))


def test_seeded_init_is_deterministic():
    a = thmr.init_weights_(thmr.HMR(layers=F.LAYERS, width=F.WIDTH,
                                    regressor_dim=F.RDIM),
                           torch.Generator().manual_seed(3))
    b = thmr.init_weights_(thmr.HMR(layers=F.LAYERS, width=F.WIDTH,
                                    regressor_dim=F.RDIM),
                           torch.Generator().manual_seed(3))
    for (k, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), k
    # xavier-small heads start the regressor near the mean parameters
    assert float(a.decpose.weight.detach().abs().max()) < 0.01
