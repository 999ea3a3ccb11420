"""Composed per-frame step, retrieval off: the port's BilevelEngine against
the JAX BilevelEngine with the skinning kernel on (``use_pallas_lbs``; the
JAX kernel runs in Pallas interpret mode on the CPU), over 3 frames with
interval 2 so the motion loss turns on at frame 3."""

import numpy as np
import pytest

from dynaboa_tpu import engine as jeng
from dynaboa_tpu.config import AdaptConfig
from tests import torch_port_fixtures as F

CFG = AdaptConfig(interval=2, optim_steps=2, cos_sim_threshold=-1.0,
                  retrieval=False, use_pallas_lbs=True)
N_FRAMES = 4


@pytest.fixture(scope="module")
def engines():
    jstore = jeng.synthetic_store(seed=6, img_res=F.IMG, feat_dim=F.XF)
    tstore = F.t_store(6, F.CPU, img_res=F.IMG, feat_dim=F.XF)
    return F.build_engines(CFG, jstore, tstore)


@pytest.fixture(scope="module")
def capped(engines):
    """thr = -1: the gate never stops early, every frame takes 1 + 2
    updates; the numerics of the whole composed step are isolated."""
    return F.run_both(engines, F.make_frames(N_FRAMES, seed=3))


def test_step_counts_identical(capped):
    F.assert_step_counts(capped)
    assert [int(o["optim_steps"]) for o in capped["touts"]] == [2] * N_FRAMES


def test_losses_match(capped):
    F.assert_losses(capped)


def test_motion_loss_gated_by_interval(capped):
    # active strictly after `interval` frames: off at steps 0-2, on at 3
    motion = [float(o["upper"]["motion_loss"]) for o in capped["touts"]]
    assert motion[:3] == [0.0, 0.0, 0.0] and motion[3] > 0.0, motion
    jmotion = [float(o["upper"]["motion_loss"]) for o in capped["jouts"]]
    np.testing.assert_allclose(motion, jmotion, rtol=F.LOSS_RTOL,
                               atol=F.LOSS_ATOL)
    assert capped["tstate"].step == N_FRAMES


def test_metrics_match(capped):
    F.assert_metrics(capped)


def test_params_within_adam_drift_bound(capped):
    bound = F.adam_drift_bound(CFG, capped)
    assert F.max_tree_diff(capped["jstate"].params,
                           capped["tstate"].params) < bound


def test_teacher_within_adam_drift_bound(capped):
    bound = F.adam_drift_bound(CFG, capped)
    assert F.max_tree_diff(capped["jstate"].teacher_params,
                           capped["tstate"].teacher_params) < bound


def test_history_ring_matches(capped):
    np.testing.assert_array_equal(capped["tstate"].hist_images.numpy(),
                                  np.asarray(capped["jstate"].hist_images))
    np.testing.assert_array_equal(capped["tstate"].hist_j2d.numpy(),
                                  np.asarray(capped["jstate"].hist_j2d))


def test_dynamic_gate_parity(engines, capped):
    """A threshold inside the widest gap of the capped run's 1 - cos values:
    both engines must stop after the same number of extra updates."""
    gaps = sorted(1.0 - float(s) for o in capped["jouts"]
                  for s in o["per_step_sims"])
    widest = int(np.argmax(np.diff(gaps)))
    thr = float(np.sqrt(gaps[widest] * gaps[widest + 1]))
    run = F.run_both(engines, F.make_frames(N_FRAMES, seed=3), thr=thr)
    F.assert_step_counts(run)
    counts = [int(o["optim_steps"]) for o in run["jouts"]]
    assert 0 < sum(counts) < N_FRAMES * CFG.optim_steps, counts
    F.assert_losses(run)
