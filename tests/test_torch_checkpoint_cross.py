"""Checkpoints cross-load between the packages: a state saved by the JAX
package loads into the port, and one saved by the port loads into the JAX
``load_state`` on a JAX template.  Every leaf but the rng key must be equal;
the parameter layouts are held with the JAX package's own converter
(``convert_torch_state_dict``), not with the port's mapping."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynaboa_tpu import engine as jeng
from dynaboa_tpu.config import AdaptConfig
from dynaboa_tpu.engine import checkpoint as jck
from dynaboa_tpu_torch.engine import checkpoint as tck
from tests import torch_port_fixtures as F

CFG = AdaptConfig(retrieval=False, seed=22)


@pytest.fixture(scope="module")
def engines():
    store = jeng.synthetic_store(seed=6, img_res=F.IMG, feat_dim=F.XF)
    tstore = F.t_store(6, F.CPU, img_res=F.IMG, feat_dim=F.XF)
    return F.build_engines(CFG, store, tstore)


def _flax(named: dict):
    return F.port_params_as_flax(named)


def _assert_trees_equal(jtree, ttree):
    a, b = jax.tree.leaves(jtree), jax.tree.leaves(ttree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _port_adam(tstate, key):
    return {k: tstate.optimizer.state[p][key]
            for k, p in tstate.params.items()}


def _assert_same_state(jstate, tstate):
    _assert_trees_equal(jstate.params, _flax(tstate.params))
    _assert_trees_equal(jstate.teacher_params, _flax(tstate.teacher_params))
    adam = jstate.opt_state[0]
    steps = {float(s["step"]) for s in tstate.optimizer.state.values()}
    assert steps == {float(adam.count)}
    _assert_trees_equal(adam.mu, _flax(_port_adam(tstate, "exp_avg")))
    _assert_trees_equal(adam.nu, _flax(_port_adam(tstate, "exp_avg_sq")))
    np.testing.assert_array_equal(tstate.hist_images.numpy(),
                                  np.asarray(jstate.hist_images))
    np.testing.assert_array_equal(tstate.hist_j2d.numpy(),
                                  np.asarray(jstate.hist_j2d))
    assert tstate.step == int(jstate.step)


def test_jax_checkpoint_loads_into_the_port(engines, tmp_path):
    rng = np.random.default_rng(11)

    def rand(a):
        if jnp.issubdtype(a.dtype, jnp.floating):
            return jnp.asarray(rng.standard_normal(a.shape), a.dtype)
        return a

    jstate = engines["jengine"].init_state(engines["jparams"], img_res=F.IMG)
    jstate = jax.tree.map(rand, jstate)
    adam = jstate.opt_state[0]._replace(count=jnp.int32(5))
    jstate = jstate._replace(opt_state=(adam,) + jstate.opt_state[1:],
                             step=jnp.int32(3))
    p = str(tmp_path / "jax.npz")
    jck.save_state(p, jstate)

    template = engines["tengine"].init_state(engines["tparams"],
                                             img_res=F.IMG)
    tstate = tck.load_state(p, template)
    _assert_same_state(jstate, tstate)
    # no generator entry in a JAX file: reseeded from the template's seed
    assert tstate.rng.initial_seed() == CFG.seed
    assert all(p.requires_grad for p in tstate.params.values())


def test_port_checkpoint_loads_into_jax(engines, tmp_path):
    g = torch.Generator().manual_seed(12)
    tstate = engines["tengine"].init_state(engines["tparams"], img_res=F.IMG)
    with torch.no_grad():
        for k, p in tstate.params.items():
            p.copy_(torch.randn(p.shape, generator=g))
            tstate.teacher_params[k].copy_(torch.randn(p.shape, generator=g))
            tstate.optimizer.state[p] = {
                "step": torch.tensor(4.0),
                "exp_avg": torch.randn(p.shape, generator=g),
                "exp_avg_sq": torch.rand(p.shape, generator=g)}
        tstate.hist_images.copy_(torch.randn(tstate.hist_images.shape,
                                             generator=g))
        tstate.hist_j2d.copy_(torch.randn(tstate.hist_j2d.shape,
                                          generator=g))
    tstate.step = 4
    p = str(tmp_path / "port.npz")
    tck.save_state(p, tstate)

    template = engines["jengine"].init_state(engines["jparams"],
                                             img_res=F.IMG)
    jstate = jck.load_state(p, template)
    _assert_same_state(jstate, tstate)
    # the rng leaf is PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(jstate.rng),
                                  np.asarray(jax.random.PRNGKey(CFG.seed)))
    # and the port's own loader restores the generator from its entry
    again = tck.load_state(p, engines["tengine"].init_state(
        engines["tparams"], img_res=F.IMG))
    assert torch.equal(again.rng.get_state(), tstate.rng.get_state())


def test_structure_mismatch_is_refused(engines, tmp_path):
    tstate = engines["tengine"].init_state(engines["tparams"], img_res=F.IMG)
    p = str(tmp_path / "w1.npz")
    tck.save_state(p, tstate)
    wider = engines["tengine"].init_state(engines["tparams"], batch_size=2,
                                          img_res=F.IMG)
    with pytest.raises(ValueError, match="does not match"):
        tck.load_state(p, wider)
