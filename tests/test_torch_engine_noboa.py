"""Plain single-level online adaptation (``use_boa=False``, the CLI's
``--use_boa 0``): the port's step against the JAX step, skinning kernel on."""

import numpy as np
import pytest

from dynaboa_tpu import engine as jeng
from dynaboa_tpu.config import AdaptConfig
from tests import torch_port_fixtures as F

CFG = AdaptConfig(use_boa=False, interval=2, retrieval=False,
                  use_pallas_lbs=True)
N_FRAMES = 4


@pytest.fixture(scope="module")
def run():
    jstore = jeng.synthetic_store(seed=6, img_res=F.IMG, feat_dim=F.XF)
    tstore = F.t_store(6, F.CPU, img_res=F.IMG, feat_dim=F.XF)
    engines = F.build_engines(CFG, jstore, tstore)
    return F.run_both(engines, F.make_frames(N_FRAMES, seed=5))


def test_lower_losses_match(run):
    for jo, to in zip(run["jouts"], run["touts"]):
        assert jo["lower"].keys() == to["lower"].keys()
        for k in jo["lower"]:
            np.testing.assert_allclose(to["lower"][k], jo["lower"][k],
                                       rtol=F.LOSS_RTOL, atol=F.LOSS_ATOL,
                                       err_msg=k)


def test_metrics_and_weights_match(run):
    for jo, to in zip(run["jouts"], run["touts"]):
        for k in ("mpjpe", "pampjpe", "pve"):
            np.testing.assert_allclose(to[k], jo[k], rtol=0,
                                       atol=F.METRIC_ATOL_MM, err_msg=k)
    bound = N_FRAMES * CFG.lr      # one Adam update per frame
    assert F.max_tree_diff(run["jstate"].params, run["tstate"].params) < bound
    assert F.max_tree_diff(run["jstate"].teacher_params,
                           run["tstate"].teacher_params) < bound
