"""Composed per-frame step with two inner (lower-level) steps: the port's
BilevelEngine against the JAX BilevelEngine with ``inner_step=2``, retrieval
off, over 3 frames.  Inner step 1 differentiates at the clone of inner step
0, so this arm checks the chained first-order MAML clone and the second
lower-level record."""

import numpy as np
import pytest

from dynaboa_tpu import engine as jeng
from dynaboa_tpu.config import AdaptConfig
from tests import torch_port_fixtures as F

CFG = AdaptConfig(interval=2, optim_steps=2, cos_sim_threshold=-1.0,
                  retrieval=False, inner_step=2)
N_FRAMES = 3


@pytest.fixture(scope="module")
def run():
    jstore = jeng.synthetic_store(seed=6, img_res=F.IMG, feat_dim=F.XF)
    tstore = F.t_store(6, F.CPU, img_res=F.IMG, feat_dim=F.XF)
    engines = F.build_engines(CFG, jstore, tstore)
    return F.run_both(engines, F.make_frames(N_FRAMES, seed=4))


def test_step_counts_identical(run):
    F.assert_step_counts(run)


def test_losses_match(run):
    F.assert_losses(run)


def test_both_lower_level_records_match(run):
    for jo, to in zip(run["jouts"], run["touts"]):
        for i in (0, 1):
            for m in ("mpjpe", "pampjpe"):
                k = f"lower_{i}_{m}"
                np.testing.assert_allclose(to[k], jo[k], rtol=0,
                                           atol=F.METRIC_ATOL_MM, err_msg=k)
        assert "lower_2_mpjpe" not in to
    F.assert_metrics(run)


def test_params_within_adam_drift_bound(run):
    bound = F.adam_drift_bound(CFG, run)
    assert F.max_tree_diff(run["jstate"].params, run["tstate"].params) < bound
    assert F.max_tree_diff(run["jstate"].teacher_params,
                           run["tstate"].teacher_params) < bound
