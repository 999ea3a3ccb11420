"""Composed per-frame step with ``keypoint_source="openpose"`` (the stream
app's path): the port's BilevelEngine against the JAX BilevelEngine, the
skinning kernel on (the JAX kernel in Pallas interpret mode), retrieval off,
over 4 frames with interval 2, so the motion loss over the 25 OpenPose
joints turns on at frame 3.  Every update is taken (threshold -1)."""

import numpy as np
import pytest

from dynaboa_tpu import engine as jeng
from dynaboa_tpu.config import AdaptConfig
from tests import torch_port_fixtures as F

CFG_STEP = AdaptConfig(interval=2, optim_steps=2, cos_sim_threshold=-1.0,
                       retrieval=False, use_pallas_lbs=True,
                       keypoint_source="openpose")
N_FRAMES = 4


@pytest.fixture(scope="module")
def openpose_run():
    """4 frames, motion on at interval 2 (active at frame 3), every update
    taken: both engines on the same weights and frames."""
    jstore = jeng.synthetic_store(seed=6, img_res=F.IMG, feat_dim=F.XF)
    tstore = F.t_store(6, F.CPU, img_res=F.IMG, feat_dim=F.XF)
    engines = F.build_engines(CFG_STEP, jstore, tstore)
    frames = F.make_frames(N_FRAMES, seed=8)
    for fr in frames:
        fr["j2d"][:, :25, 2] = (np.arange(25) % 4 != 0)   # some joints unseen
        fr["j2d"][:, 25:] = 0.0          # the stream app's GT half is empty
    return F.run_both(engines, frames)


def test_openpose_step_counts_identical(openpose_run):
    F.assert_step_counts(openpose_run)
    assert [int(o["optim_steps"]) for o in openpose_run["touts"]] == \
        [2] * N_FRAMES


def test_openpose_losses_match(openpose_run):
    F.assert_losses(openpose_run)
    touts = openpose_run["touts"]
    motion = [float(o["upper"]["motion_loss"]) for o in touts]
    assert motion[:3] == [0.0, 0.0, 0.0] and motion[3] > 0.0, motion
    # the OpenPose half carries the keypoint loss
    assert all(float(o["upper"]["s2dloss"]) > 0 for o in touts)


def test_openpose_weights_within_adam_drift_bound(openpose_run):
    bound = F.adam_drift_bound(CFG_STEP, openpose_run)
    assert F.max_tree_diff(openpose_run["jstate"].params,
                           openpose_run["tstate"].params) < bound
    assert F.max_tree_diff(openpose_run["jstate"].teacher_params,
                           openpose_run["tstate"].teacher_params) < bound
