"""Windowed adaptation: the port's StreamRunner against the JAX StreamRunner
on the same 7 synthetic frames with ``window_size`` 2 and 3 (a masked tail
window in both), from the same weights, bodies, prior and store.  One JAX
engine serves both window sizes (it traces once per window batch)."""

import json

import numpy as np
import pytest

from dynaboa_tpu import engine as jeng
from dynaboa_tpu.config import AdaptConfig
from dynaboa_tpu.data import SyntheticStream as JStream
from dynaboa_tpu.engine.runner import StreamRunner as JRunner
from dynaboa_tpu_torch.data.streams import SyntheticStream as TStream
from dynaboa_tpu_torch.engine.runner import StreamRunner as TRunner
from tests import torch_port_fixtures as F

# every update taken (thr = -1), so the per-update records of the window
# rows are compared too; interval 2 turns the motion loss on at window 3
CFG = AdaptConfig(interval=2, optim_steps=2, cos_sim_threshold=-1.0,
                  retrieval=False)
N_FRAMES = 7


@pytest.fixture(scope="module")
def engines():
    jstore = jeng.synthetic_store(seed=6, img_res=F.IMG, feat_dim=F.XF)
    tstore = F.t_store(6, F.CPU, img_res=F.IMG, feat_dim=F.XF)
    return F.build_engines(CFG, jstore, tstore)


def _scalars(path):
    with open(path / "scalars.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module", params=[2, 3])
def runs(request, engines, tmp_path_factory):
    W = request.param
    d = tmp_path_factory.mktemp(f"w{W}")
    jr = JRunner(engines["jengine"], str(d / "jax"), log_every=1000,
                 defer_window=1)
    jstate, jsum = jr.run(
        JStream(N_FRAMES, img_res=F.IMG, seed=8),
        engines["jengine"].init_state(engines["jparams"], batch_size=W,
                                      img_res=F.IMG),
        window_size=W)
    tr = TRunner(engines["tengine"], str(d / "port"), log_every=1000)
    tstate, tsum = tr.run(
        TStream(N_FRAMES, F.IMG, 8),
        engines["tengine"].init_state(engines["tparams"], batch_size=W,
                                      img_res=F.IMG),
        window_size=W)
    tr.close()
    return dict(W=W, jr=jr, tr=tr, jstate=jstate, tstate=tstate, jsum=jsum,
                tsum=tsum, jrows=_scalars(d / "jax"),
                trows=_scalars(d / "port"))


def test_every_frame_recorded_and_steps_per_window(runs):
    W = runs["W"]
    n_windows = -(-N_FRAMES // W)
    assert runs["tsum"]["frames"] == runs["jsum"]["frames"] == N_FRAMES
    assert runs["tstate"].step == int(runs["jstate"].step) == n_windows
    assert [r["step"] for r in runs["trows"]] == list(range(N_FRAMES))


def test_step_counts_identical(runs):
    assert runs["tr"].optim_step_record == runs["jr"].optim_step_record
    assert len(runs["tr"].optim_step_record) == N_FRAMES


def test_losses_match(runs):
    for j, t in zip(runs["jrows"], runs["trows"]):
        for k in j:
            if k.startswith(("ll/", "ul/", "teacher/")):
                np.testing.assert_allclose(t[k], j[k], rtol=F.LOSS_RTOL,
                                           atol=F.LOSS_ATOL,
                                           err_msg=f"frame {j['step']} {k}")


def test_metrics_match(runs):
    jr, tr = runs["jr"], runs["tr"]
    for a, b in ((tr.mpjpe_all, jr.mpjpe_all), (tr.pampjpe_all,
                                                 jr.pampjpe_all),
                 (tr.pve_all, jr.pve_all)):
        np.testing.assert_allclose(a, b, rtol=0, atol=F.METRIC_ATOL_MM)
    assert len(set(np.round(tr.mpjpe_all, 6))) > 1    # per-frame values
    for i in jr.step_stats:
        for a, b in zip(tr.step_stats[i], jr.step_stats[i]):
            np.testing.assert_allclose(a, b, rtol=0, atol=F.METRIC_ATOL_MM)


def test_params_within_adam_drift_bound(runs):
    n_updates = -(-N_FRAMES // runs["W"]) * (1 + CFG.optim_steps)
    bound = n_updates * CFG.lr
    assert F.max_tree_diff(runs["jstate"].params,
                           runs["tstate"].params) < bound
    assert F.max_tree_diff(runs["jstate"].teacher_params,
                           runs["tstate"].teacher_params) < bound


def test_history_ring_matches(runs):
    np.testing.assert_array_equal(runs["tstate"].hist_j2d.numpy(),
                                  np.asarray(runs["jstate"].hist_j2d))
    np.testing.assert_allclose(runs["tstate"].hist_images.numpy(),
                               np.asarray(runs["jstate"].hist_images),
                               rtol=0, atol=0)
