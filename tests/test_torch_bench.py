"""The port's headline benchmark (``dynaboa_tpu_torch/tools/bench.py``)
against the root ``bench.py`` on the CPU at the tiny size: the frames, the
streaming, realistic-gate and curve arms step for step against the JAX
bench's own functions on the same weights, every arm of ``--full``, and
the JSON key sets against the JAX bench's committed records (read, never
written)."""

import importlib.util
import inspect
import json
import os
import types

import numpy as np
import pytest
import torch

from dynaboa_tpu.config import AdaptConfig
from dynaboa_tpu_torch.tools import bench as tbench
from tests import torch_port_fixtures as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC_ATOL_MM = 0.05     # per-frame MPJPE, port against JAX
# a few frames per arm: enough to cross the motion loss's interval
STREAM_FRAMES, ARM_FRAMES = 3, 2


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jbench = _load("jax_root_bench", os.path.join(REPO, "bench.py"))


class Recorder:
    """An engine whose ``step`` also keeps every frame's extra-update count
    and mean MPJPE on the host, in call order."""

    def __init__(self, engine):
        self.engine = engine
        self.steps: list[int] = []
        self.mpjpe: list[float] = []

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def step(self, state, frame, **kw):
        state, out = self.engine.step(state, frame, **kw)
        self.steps.append(int(np.asarray(out["optim_steps"])))
        self.mpjpe.append(float(np.asarray(out["mpjpe"]).mean()))
        return state, out

    def take(self):
        out = (self.steps, np.asarray(self.mpjpe))
        self.steps, self.mpjpe = [], []
        return out


@pytest.fixture(scope="module")
def systems():
    """The JAX and the port's tiny engines on the same weights, SMPL
    bodies, prior and singleton exemplar store, at the bench's 224^2."""
    cfg = AdaptConfig(record_lowerlevel=False, optim_steps=3, interval=2)
    jstore, tstore = F.singleton_stores(img_res=224)
    e = F.build_engines(cfg, jstore, tstore)
    jsys = types.SimpleNamespace(engine=Recorder(e["jengine"]),
                                 params=e["jparams"])
    tsys = types.SimpleNamespace(engine=Recorder(e["tengine"]),
                                 params=e["tparams"], device=F.CPU)
    return jsys, tsys, jbench.make_frames(8), tbench.make_frames(8, F.CPU)


def _assert_same_run(jsys, tsys, what):
    jsteps, jm = jsys.engine.take()
    tsteps, tm = tsys.engine.take()
    assert tsteps == jsteps, (what, tsteps, jsteps)
    np.testing.assert_allclose(tm, jm, rtol=0, atol=METRIC_ATOL_MM,
                               err_msg=what)


def test_make_frames_equal_jax():
    jf = jbench.make_frames(8)
    tf = tbench.make_frames(8, F.CPU)
    assert len(tf) == len(jf) == 8
    for a, b in zip(jf, tf):
        assert a._fields == b._fields
        for k in a._fields:
            x, y = np.asarray(getattr(a, k)), getattr(b, k).numpy()
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert np.array_equal(x, y), k


def test_streaming_matches_jax(systems):
    jsys, tsys, jframes, tframes = systems
    j = jbench.measure_streaming(jsys, jframes, STREAM_FRAMES, "jax")
    t = tbench.measure_streaming(tsys, tframes, STREAM_FRAMES, "port")
    _assert_same_run(jsys, tsys, "streaming")
    assert t[1] == j[1] and t[4] == j[4]      # mean and warm-up extras
    np.testing.assert_allclose(t[3], j[3], rtol=0, atol=METRIC_ATOL_MM)


def test_realistic_gate_matches_jax(systems):
    jsys, tsys, jframes, tframes = systems
    j = jbench.measure_realistic(jsys, jframes, "jax", means=(1, 3),
                                 n_frames=ARM_FRAMES)
    t = tbench.measure_realistic(tsys, tframes, "port", means=(1, 3),
                                 n_frames=ARM_FRAMES)
    _assert_same_run(jsys, tsys, "realistic")
    assert {k: v["realized_mean_extras"] for k, v in t.items()} == \
        {k: v["realized_mean_extras"] for k, v in j.items()}


def test_curve_matches_jax(systems):
    jsys, tsys, jframes, tframes = systems
    caps = (0, 1, 3)
    # one cap per call: with one point the JAX curve has no pair to find
    # non-monotone, so it never re-measures (a timing-dependent extra run)
    for cap in caps:
        jbench.measure_curve(jsys, jframes, "jax", caps=(cap,),
                             n_frames=ARM_FRAMES)
    t = tbench.measure_curve(tsys, tframes, "port", caps=caps,
                             n_frames=ARM_FRAMES)
    assert sorted(t) == list(caps)
    _assert_same_run(jsys, tsys, "curve")


def test_chaos_controls_and_rule_are_jax_s():
    src = inspect.getsource(jbench.qualify_bf16_trajectory)
    assert "for j, eps in enumerate((1.2e-7, 2.4e-7, -1.2e-7))" in src
    assert tbench.CHAOS_EPS == (1.2e-7, 2.4e-7, -1.2e-7)
    # bench.py:492-494 on both sides of each bound
    for rel, ctl, drift, want in ((0.019, 0.0, 0.5, True),
                                  (0.021, 0.0, 0.5, False),
                                  (0.05, 0.03, 1.0, True),
                                  (0.05, 0.03, 1.01, False),
                                  (0.07, 0.03, 0.1, False)):
        assert tbench.bf16_qualifies(dict(rel=rel, rel_chaos_control=ctl,
                                          drift_vs_bound=drift)) is want


COUNTS = ["--stream_frames", "2", "--worst_frames", "1",
          "--realistic_frames", "1", "--curve_frames", "1",
          "--runner_frames", "3", "--chunks", "1", "--window_steps", "1",
          "--parallel_frames", "1"]


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    """``main --full`` on the CPU at the tiny size, every count at its
    least; returns (the printed lines, the --out file)."""
    import contextlib
    import io

    out = tmp_path_factory.mktemp("bench") / "full.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = tbench.main(["--device", "cpu", "--tiny", "1", "--full",
                           "--repeats", "1", "--out", str(out), *COUNTS])
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    with open(out) as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(ret))
    return lines, written


def _finite(x):
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, list):
        return all(_finite(v) for v in x)
    if isinstance(x, float):
        return np.isfinite(x)
    return True


def test_every_arm_runs_finite(full_run):
    lines, res = full_run
    assert len(lines) == 2
    assert _finite(res)
    assert res["backend"] == "cpu" and res["power_limit"] is None
    assert res["repeats"] == 1 and len(res["streaming_fps_runs"]) == 1
    assert res["streaming_fps"] == res["streaming_fps_runs"][0]
    assert res["bf16_traj_weight_drift_vs_adam_bound"] <= 1.0
    assert len(res["bf16_traj_mpjpe_rel_chaos_controls"]) == 3
    assert res["worst_case_extra_steps"] == 7.0     # optim_steps
    assert sorted(res["fps_vs_extra_steps"]) == ["0", "1", "3", "5", "7"]
    assert sorted(res["realistic_gate_fps"]) == ["1", "2", "3"]
    assert sorted(res["worst_case_experiments_fps"]) == [
        "fast_extra", "fast_extra+half_res_probe", "half_res_probe"]
    for arm in ("chunked_fps", "windowed8_aggregate_fps",
                "parallel_1dev_fps", "worst_case_streaming_fps"):
        assert len(res["runs"][arm]) == 1, arm
    # the CPU takes the kernel's plain version: no launch
    assert res["skin_kernel_launches"] == 0


def test_repeats_report_the_median():
    runs = [{1: {"fps": 3.0, "realized_mean_extras": 1.0}, 3: 9.0},
            {1: {"fps": 1.0, "realized_mean_extras": 1.0}, 3: 5.0},
            {1: {"fps": 2.0, "realized_mean_extras": 1.0}, 3: 7.0}]
    assert tbench._median_table(runs) == {
        "1": {"fps": 2.0, "realized_mean_extras": 1.0}, "3": 7.0}
    assert tbench._runs_table(runs) == {"1": [3.0, 1.0, 2.0],
                                        "3": [9.0, 5.0, 7.0]}


def test_key_sets_equal_jax_records(full_run):
    lines, res = full_run
    with open(os.path.join(REPO, "BENCH_r05.json")) as f:
        headline = set(json.load(f)["parsed"]) - {"supplementary_full_run"}
    with open(os.path.join(REPO, "BENCH_FULL.json")) as f:
        full = set(json.load(f)) - {"git_rev"}
    port = set(tbench.PORT_KEYS)
    assert set(lines[0]) == headline | port
    assert set(tbench.FULL_KEYS) == full - headline
    assert set(tbench.FULL_KEYS) <= set(lines[1])
    assert set(res) == full | headline | port
    with open(os.path.join(REPO, "BENCH_r05.json")) as f:
        parsed = json.load(f)["parsed"]
    for k in ("realistic_gate_fps",):
        assert set(res[k]["1"]) == set(parsed[k]["1"])


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.main(["--device", "cuda"])
    assert capsys.readouterr().out == ""
