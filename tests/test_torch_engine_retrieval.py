"""Composed per-frame step, retrieval on: the port against the JAX engine
(``use_pallas_lbs``, Pallas interpret mode on the CPU) with a store of one
exemplar per cluster, so both packages' within-cluster draws are
deterministic and only the cluster choice — the retrieval semantics,
including update 0 keying off the pre-inner features — is under test.
Matching losses imply both sides drew the same exemplar every time."""

import numpy as np
import pytest

from dynaboa_tpu.config import AdaptConfig
from tests import torch_port_fixtures as F

CFG = AdaptConfig(interval=2, optim_steps=2, cos_sim_threshold=-1.0,
                  retrieval=True, use_pallas_lbs=True)
N_FRAMES = 3


@pytest.fixture(scope="module")
def stores():
    return F.singleton_stores()


@pytest.fixture(scope="module")
def run(stores):
    engines = F.build_engines(CFG, *stores)
    return F.run_both(engines, F.make_frames(N_FRAMES, seed=13))


def test_retrieval_picks_same_cluster(stores):
    """The nearest-centre choice on random features, one exemplar per
    cluster: the drawn exemplar must be the same on both sides."""
    import jax
    import jax.numpy as jnp
    import torch

    from dynaboa_tpu.engine import retrieve as jretrieve
    from dynaboa_tpu_torch.engine.retrieval import retrieve as tretrieve

    jstore, tstore = stores
    feats = np.random.default_rng(2).normal(size=(8, F.XF)).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    for i, f in enumerate(feats):
        jb = jretrieve(jstore, jnp.asarray(f), jax.random.PRNGKey(i), 1)
        tb = tretrieve(tstore, torch.as_tensor(f), gen, 1)
        np.testing.assert_array_equal(tb.pose.numpy(), np.asarray(jb.pose))


def test_step_counts_identical(run):
    F.assert_step_counts(run)


def test_losses_match(run):
    F.assert_losses(run)


def test_metrics_match(run):
    F.assert_metrics(run)


def test_params_within_adam_drift_bound(run):
    assert F.max_tree_diff(run["jstate"].params, run["tstate"].params) < \
        F.adam_drift_bound(CFG, run)


def test_teacher_within_adam_drift_bound(run):
    assert F.max_tree_diff(run["jstate"].teacher_params,
                           run["tstate"].teacher_params) < \
        F.adam_drift_bound(CFG, run)
