"""The JAX package's two worst-case latency experiments in the port's
engine, against the JAX engine: ``fast_extra_updates`` (the extra updates
drop the retrieved exemplar row and its labeled loss) and
``probe_res_factor=2`` (the post-update probe forward on the image
average-pooled by 2, one full-resolution forward for the prediction).

Retrieval is on through a store of one exemplar per cluster (both packages'
draws are then deterministic), every update is taken (threshold -1,
``optim_steps=2``) and the lower-level record is off, as in the JAX
package's own tests of the flags (``tests/test_engine.py``
``TestWorstCaseExperiments``).  One JAX engine per flag, built once."""

import numpy as np
import pytest
import torch

from dynaboa_tpu.config import AdaptConfig
from dynaboa_tpu_torch.engine import bilevel as teng
from tests import torch_port_fixtures as F

BASE = AdaptConfig(interval=2, optim_steps=2, cos_sim_threshold=-1.0,
                   retrieval=True, record_lowerlevel=False,
                   use_pallas_lbs=True)
FLAGS = {"fast_extra_updates": dict(fast_extra_updates=True),
         "probe_res_factor": dict(probe_res_factor=2)}
N_FRAMES = 3
METRICS = ("mpjpe", "pampjpe", "pve", "per_step_mpjpe", "per_step_pampjpe",
           "per_step_pve")


@pytest.fixture(scope="module")
def stores():
    return F.singleton_stores()


@pytest.fixture(scope="module")
def frames():
    return F.make_frames(N_FRAMES, seed=17)


@pytest.fixture(scope="module", params=list(FLAGS))
def arm(request, stores, frames):
    cfg = BASE.replace(**FLAGS[request.param])
    engines = F.build_engines(cfg, *stores)
    run = F.run_both(engines, frames)
    return dict(cfg=cfg, engines=engines, run=run)


def _port_run(engine, frames):
    state = engine.init_state({k: v.detach()
                               for k, v in engine.model.named_parameters()},
                              img_res=F.IMG)
    outs = []
    for fr in frames:
        state, o = engine.step(state, F.torch_frame(fr))
        outs.append(F._to_numpy(o))
    return outs


def _port_engine(arm, **flags):
    """The arm's port engine under another configuration."""
    t = arm["engines"]["tengine"]
    return teng.BilevelEngine(BASE.replace(**flags), t.model, t.prior,
                              t.smpls, t.store)


def test_step_counts_identical(arm):
    F.assert_step_counts(arm["run"])
    assert [int(o["optim_steps"]) for o in arm["run"]["touts"]] == \
        [BASE.optim_steps] * N_FRAMES


def test_per_step_losses_match(arm):
    for jo, to in zip(arm["run"]["jouts"], arm["run"]["touts"]):
        np.testing.assert_allclose(to["per_step_loss"], jo["per_step_loss"],
                                   rtol=F.LOSS_RTOL, atol=F.LOSS_ATOL)
        np.testing.assert_allclose(to["lower"]["loss"], jo["lower"]["loss"],
                                   rtol=F.LOSS_RTOL, atol=F.LOSS_ATOL)
        for k in jo["upper"]:
            np.testing.assert_allclose(to["upper"][k], jo["upper"][k],
                                       rtol=F.LOSS_RTOL, atol=F.LOSS_ATOL,
                                       err_msg=k)


def test_metrics_match(arm):
    for jo, to in zip(arm["run"]["jouts"], arm["run"]["touts"]):
        for k in METRICS:
            np.testing.assert_allclose(to[k], jo[k], rtol=0,
                                       atol=F.METRIC_ATOL_MM, err_msg=k)
        np.testing.assert_allclose(to["verts"], jo["verts"], rtol=0,
                                   atol=F.VERTS_ATOL_M)


def test_params_and_teacher_within_adam_drift_bound(arm):
    run = arm["run"]
    bound = F.adam_drift_bound(arm["cfg"], run)
    assert F.max_tree_diff(run["jstate"].params, run["tstate"].params) < bound
    assert F.max_tree_diff(run["jstate"].teacher_params,
                           run["tstate"].teacher_params) < bound


def test_fast_extra_updates_keeps_first_update(stores, frames):
    """Update 0 takes the full 3-row loss as in the default mode; the extra
    updates drop the labeled term, so their losses differ."""
    cfg = BASE.replace(fast_extra_updates=True)
    _, jparams = F.jax_hmr()
    net = F.torch_hmr_from(jparams)
    outs = {}
    for label, c in (("fast", cfg), ("default", BASE)):
        eng = teng.BilevelEngine(c, net, F.t_prior(4, F.CPU),
                                 F.torch_smpls(), stores[1])
        outs[label] = _port_run(eng, frames[:1])[0]
    np.testing.assert_allclose(outs["fast"]["per_step_loss"][0],
                               outs["default"]["per_step_loss"][0], rtol=1e-5)
    assert not np.allclose(outs["fast"]["per_step_loss"][1:],
                           outs["default"]["per_step_loss"][1:])
    for k in ("mpjpe", "pampjpe", "pve"):
        assert np.isfinite(outs["fast"][k]).all()


@pytest.mark.parametrize("arm", ["probe_res_factor"], indirect=True)
def test_half_res_probe_final_prediction_is_full_res(arm):
    for o in arm["run"]["touts"]:
        sims = o["feat_sim"]
        assert sims.shape == (15,) and np.isfinite(sims).all()
        for k in ("mpjpe", "pampjpe", "pve", "verts"):
            assert np.isfinite(o[k]).all(), k


@pytest.mark.parametrize("arm", ["probe_res_factor"], indirect=True)
def test_probe_res_factor_must_divide_the_image(arm, frames):
    eng = _port_engine(arm, probe_res_factor=3)
    state = eng.init_state({k: v.detach()
                            for k, v in eng.model.named_parameters()},
                           img_res=F.IMG)
    before = {k: v.clone() for k, v in state.params.items()}
    with pytest.raises(ValueError, match="probe_res_factor=3 must divide"):
        eng.step(state, F.torch_frame(frames[0]))
    for k, v in state.params.items():
        assert torch.equal(v, before[k]), k
