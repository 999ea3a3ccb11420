"""The port's runner modes on the CPU at the tiny size: chunked equals
sequential bit for bit, checkpoints round-trip and resume bit-exactly
(frames and windows), the async checkpointer skips while busy and surfaces
a failure once, auto-reset recovers from divergence, and an unlabeled
stream runs without metrics."""

import os.path as osp
import threading

import numpy as np
import pytest
import torch

from dynaboa_tpu.config import AdaptConfig
from dynaboa_tpu_torch.data.streams import SyntheticStream
from dynaboa_tpu_torch.engine import bilevel as teng
from dynaboa_tpu_torch.engine import checkpoint as ck
from dynaboa_tpu_torch.engine.runner import StreamRunner
from dynaboa_tpu_torch.models.hmr import HMR, init_weights_
from tests import torch_port_fixtures as F

CFG = AdaptConfig(interval=2, optim_steps=2, retrieval=False)


def _engine(cfg=CFG, compute_metrics=True):
    net = HMR(layers=F.LAYERS, width=F.WIDTH, regressor_dim=F.RDIM)
    init_weights_(net, torch.Generator().manual_seed(0))
    store = F.t_store(6, F.CPU, img_res=F.IMG, feat_dim=F.XF)
    eng = teng.BilevelEngine(cfg, net.eval(), F.t_prior(4, F.CPU),
                             F.torch_smpls(), store,
                             compute_metrics=compute_metrics)
    return eng, {k: v.detach() for k, v in net.named_parameters()}


@pytest.fixture(scope="module")
def engine():
    return _engine()


def _run(engine, path, n, seed, W=1, **kw):
    eng, params = engine
    runner = StreamRunner(eng, str(path), log_every=1000,
                          checkpoint_every=kw.pop("checkpoint_every", 0))
    state = eng.init_state(params, batch_size=W, img_res=F.IMG)
    state, summary = runner.run(SyntheticStream(n, F.IMG, seed), state,
                                window_size=W, **kw)
    runner.close()
    return state, summary, runner


def _assert_states_equal(a, b):
    assert a.step == b.step
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
        assert torch.equal(a.teacher_params[k], b.teacher_params[k]), k
    for x, y in zip(ck._state_leaves(a), ck._state_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert torch.equal(a.rng.get_state(), b.rng.get_state())


@pytest.mark.parametrize("W", [1, 2])
def test_chunked_equals_sequential_bit_for_bit(engine, tmp_path, W):
    seq, s_sum, s_run = _run(engine, tmp_path / "seq", 5, 1, W=W)
    chk, c_sum, c_run = _run(engine, tmp_path / "chk", 5, 1, W=W,
                             chunk_size=2)
    _assert_states_equal(seq, chk)
    assert s_run.mpjpe_all == c_run.mpjpe_all
    assert s_run.optim_step_record == c_run.optim_step_record
    assert s_sum["frames"] == c_sum["frames"] == 5
    assert len(c_run.step_times) == 5


def test_checkpoint_round_trip_bit_exact(engine, tmp_path):
    state, _, _ = _run(engine, tmp_path / "a", 2, 2)
    p = str(tmp_path / "ck.npz")
    ck.save_state(p, state)
    eng, params = engine
    restored = ck.load_state(p, eng.init_state(params, img_res=F.IMG))
    _assert_states_equal(state, restored)
    adam = restored.optimizer.state[restored.params["fc1.weight"]]
    assert adam["step"] == state.optimizer.state[
        state.params["fc1.weight"]]["step"] >= 2


def test_read_groups_splits_the_state(engine, tmp_path):
    state, _, _ = _run(engine, tmp_path / "a", 2, 2)
    p = str(tmp_path / "ck.npz")
    ck.save_state(p, state)
    groups = ck.read_groups(p)
    order = ck._flax_order(state.params)
    for (k, kind), a, t in zip(order, groups["params"], groups["teacher"]):
        np.testing.assert_array_equal(
            a, ck._to_flax(state.params[k].detach(), kind).numpy())
        np.testing.assert_array_equal(
            t, ck._to_flax(state.teacher_params[k], kind).numpy())
    adam = state.optimizer.state[state.params[order[0][0]]]
    np.testing.assert_array_equal(
        groups["mu"][0], ck._to_flax(adam["exp_avg"], order[0][1]).numpy())
    np.testing.assert_array_equal(
        groups["nu"][-1], ck._to_flax(state.optimizer.state[
            state.params[order[-1][0]]]["exp_avg_sq"], order[-1][1]).numpy())
    np.testing.assert_array_equal(groups["hist_images"][0],
                                  state.hist_images.numpy())
    np.testing.assert_array_equal(groups["hist_j2d"][0],
                                  state.hist_j2d.numpy())
    assert int(groups["count"][0]) == int(adam["step"]) == 2
    assert int(groups["step"][0]) == state.step == 2
    assert groups["rng"][0].dtype == np.uint32
    assert len(groups["mu"]) == len(groups["nu"]) == len(order)


@pytest.mark.parametrize("W,n,stop", [(1, 4, 2), (2, 6, 4)])
def test_resume_bit_exact(engine, tmp_path, W, n, stop):
    """Resume after 2 of 4 frames, and after 2 of 3 windows, against the
    uninterrupted run."""
    full, _, _ = _run(engine, tmp_path / "full", n, 3, W=W)
    _run(engine, tmp_path / "half", n, 3, W=W, max_frames=stop,
         checkpoint_every=2)
    ckpt = str(tmp_path / "half" / "checkpoint.npz")
    assert osp.exists(ckpt) and not osp.exists(ckpt + ".tmp")
    resumed, summary, _ = _run(engine, tmp_path / "res", n, 3, W=W,
                               resume_from=ckpt)
    assert summary["frames"] == n - stop
    _assert_states_equal(full, resumed)


def test_final_checkpoint_holds_the_final_state(engine, tmp_path):
    # 5 frames, every 2: periodic writes at frames 2 and 4, a final at 5
    state, _, _ = _run(engine, tmp_path / "x", 5, 4, checkpoint_every=2)
    eng, params = engine
    restored = ck.load_state(str(tmp_path / "x" / "checkpoint.npz"),
                             eng.init_state(params, img_res=F.IMG))
    assert restored.step == 5
    _assert_states_equal(state, restored)


def test_async_checkpointer_skips_while_busy(engine, tmp_path, monkeypatch):
    eng, params = engine
    state = eng.init_state(params, img_res=F.IMG)
    release = threading.Event()
    real_write = ck._write_packed

    def slow_write(*a):
        release.wait(timeout=30)
        real_write(*a)

    monkeypatch.setattr(ck, "_write_packed", slow_write)
    c = ck.AsyncCheckpointer()
    p = str(tmp_path / "ck.npz")
    assert c.submit(p, state, block=False) is True
    assert c.busy
    assert c.submit(p, state, block=False) is False
    release.set()
    c.wait()
    assert c.submit(p, state, block=False) is True
    c.wait()
    c.close()
    assert osp.exists(p)


def test_async_checkpointer_surfaces_a_failure_once(engine, tmp_path):
    eng, params = engine
    state = eng.init_state(params, img_res=F.IMG)
    c = ck.AsyncCheckpointer()
    (tmp_path / "blocker").write_text("")     # a file where a dir must go
    c.submit(str(tmp_path / "blocker" / "ck.npz"), state)
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        c.wait()
    c.wait()                                  # raised once, then cleared
    good = str(tmp_path / "ok.npz")
    c.submit(good, state)                     # the worker is still alive
    c.wait()
    c.close()
    _assert_states_equal(state, ck.load_state(good, state))


def test_runner_counts_checkpoint_failures_and_completes(engine, tmp_path):
    exp = tmp_path / "x"
    exp.mkdir()
    (exp / "checkpoint.npz.tmp").mkdir()      # every write fails
    _, summary, _ = _run(engine, exp, 4, 3, checkpoint_every=2)
    assert summary["frames"] == 4
    assert summary["checkpoint_failures"] >= 1
    assert np.isfinite(summary["mpjpe"])


def test_auto_reset_on_divergence(tmp_path):
    cfg = AdaptConfig(lr=1e12, dynamic_boa=False, use_meanteacher=False,
                      use_motion=False, retrieval=False,
                      lower_level_mixtrain=False, upper_level_mixtrain=False,
                      record_lowerlevel=False)
    eng, params = _engine(cfg)
    runner = StreamRunner(eng, str(tmp_path), log_every=1000)
    state = eng.init_state(params, img_res=F.IMG)
    live = state.params
    state, summary = runner.run(SyntheticStream(6, F.IMG, 2), state,
                                auto_reset=True)
    assert runner.reset_count >= 1 and summary["reset_count"] >= 1
    assert summary["frames"] == 6             # the run completes regardless
    assert state.params is live               # reset in place
    assert state.step == 6                    # step and history are kept


def test_unlabeled_stream_without_metrics(tmp_path, monkeypatch):
    """compute_metrics=False: internet items carry gender -1 and zero GT;
    the GT targets are never computed and the metrics are zeros."""
    eng, params = _engine(compute_metrics=False)

    def no_targets(*a):
        raise AssertionError("gt_targets called with compute_metrics off")

    monkeypatch.setattr(teng, "gt_targets", no_targets)
    items = [dict(it, gender=np.int32(-1), pose=np.zeros(72, np.float32),
                  betas=np.zeros(10, np.float32))
             for it in SyntheticStream(3, F.IMG, 5)]
    runner = StreamRunner(eng, str(tmp_path), save_predictions=True,
                          log_every=1000)
    state = eng.init_state(params, img_res=F.IMG)
    _, summary = runner.run(items, state)
    assert summary["frames"] == 3
    assert runner.mpjpe_all == [0.0] * 3 and runner.pve_all == [0.0] * 3
    assert not runner.step_stats              # no per-update records
    for i in range(3):
        pred = np.load(tmp_path / "result" / f"Pred_{i}.npz")
        assert np.isfinite(pred["verts"]).all()


def test_extra_cap_bounds_the_updates(engine):
    eng, params = engine
    frame = F.torch_frame(F.make_frames(1, seed=3)[0])
    state = eng.init_state(params, img_res=F.IMG)
    _, out = eng.step(state, frame, cos_sim_threshold=-1.0, extra_cap=1)
    assert out["optim_steps"] == 1
    with pytest.raises(ValueError, match="extra_cap"):
        eng.step(state, frame, extra_cap=CFG.optim_steps + 1)
