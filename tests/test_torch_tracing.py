"""The port's spans (``dynaboa_tpu_torch/tracing.py``) on the CPU at the tiny
size: outside a profiler a span is one shared no-op that never builds a
``record_function``; under ``torch.profiler`` the step, the stream app's
main loop and the runner record their phases, nested as the code nests
them; the profiler leaves the step's numbers bit-equal; the stream app
reports the pipeline's wait."""

import json
import math
import os
import tempfile

import pytest
import torch

from dynaboa_tpu_torch import tracing
from dynaboa_tpu_torch.apps import stream as tstream
from dynaboa_tpu_torch.apps.common import build_system
from dynaboa_tpu_torch.config import AdaptConfig, Paths
from dynaboa_tpu_torch.data.streams import SyntheticStream
from dynaboa_tpu_torch.engine import bilevel as teng
from dynaboa_tpu_torch.engine.runner import StreamRunner
from dynaboa_tpu_torch.models.hmr import HMR, init_weights_
from tests import torch_port_fixtures as F
from tests.test_torch_stream import CFG_OPENPOSE, _frames_and_kps, _Provider

CFG = AdaptConfig(interval=2, optim_steps=2, retrieval=False)
PHASES = ("step.targets", "step.init_forward", "step.retrieve",
          "step.grad.lower", "step.inner_update", "step.grad.upper",
          "step.optim", "step.probe", "step.record", "step.gate_read",
          "step.decode")


@pytest.fixture(scope="module")
def engine():
    net = HMR(layers=F.LAYERS, width=F.WIDTH, regressor_dim=F.RDIM)
    init_weights_(net, torch.Generator().manual_seed(0))
    store = F.t_store(6, F.CPU, img_res=F.IMG, feat_dim=F.XF)
    eng = teng.BilevelEngine(CFG, net.eval(), F.t_prior(4, F.CPU),
                             F.torch_smpls(), store)
    return eng, {k: v.detach() for k, v in net.named_parameters()}


@pytest.fixture(scope="module")
def system():
    """The stream app's tiny system, as ``tests/test_torch_stream.py``
    builds it."""
    return build_system(AdaptConfig(**CFG_OPENPOSE, optim_steps=1), Paths(),
                        "cpu", compute_metrics=False,
                        model_kwargs=dict(layers=F.LAYERS, width=F.WIDTH,
                                          regressor_dim=F.RDIM),
                        num_vertices=F.NV)


def _frames(n):
    return [F.torch_frame(f) for f in F.make_frames(n, seed=3)]


def _annotations(prof) -> list[dict]:
    """The trace's user spans, in start order."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return sorted((e for e in events if e.get("cat") == "user_annotation"),
                  key=lambda e: (e["ts"], -e["dur"]))


def _inside(child, parent) -> bool:
    return (child["tid"] == parent["tid"] and parent["ts"] <= child["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"])


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _annotations(prof)


def test_span_outside_a_profiler_is_one_shared_noop(engine, system,
                                                    monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function built outside a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert tracing.span("engine.step") is tracing.span("step.optim")
    with tracing.span("x"):
        pass
    eng, params = engine
    state = eng.init_state(params, img_res=F.IMG)
    state, out = eng.step(state, _frames(1)[0], cos_sim_threshold=-1.0)
    assert int(out["optim_steps"]) == CFG.optim_steps
    frames, kps = _frames_and_kps(4)
    summary = tstream.run(system, iter(frames), _Provider(kps),
                          lambda img: None)
    assert summary["records"] == 4


@pytest.mark.parametrize("cap", [0, 1, 2])
def test_step_spans_nest_in_engine_step(engine, cap):
    eng, params = engine
    state = eng.init_state(params, img_res=F.IMG)
    frames = _frames(2)
    state, _ = eng.step(state, frames[0])

    def one():
        return eng.step(state, frames[1], cos_sim_threshold=-1.0,
                        extra_cap=cap)

    (_, out), spans = _profiled(one)
    assert int(out["optim_steps"]) == cap
    steps = [s for s in spans if s["name"] == "engine.step"]
    assert len(steps) == 1
    # no program span takes the benchmark's name for the step
    assert not any(s["name"] == "BilevelEngine.step" for s in spans)
    phases = [s for s in spans if s["name"].startswith("step.")]
    assert phases and all(_inside(s, steps[0]) for s in phases)
    assert {s["name"] for s in phases} <= set(PHASES)
    # lower gradients, then each update's gradient, optimizer and probe
    order = [s["name"] for s in phases if s["name"] in (
        "step.grad.lower", "step.grad.upper", "step.optim", "step.probe",
        "step.gate_read")]
    upd = ["step.grad.upper", "step.optim", "step.probe"]
    want = ["step.grad.lower"] * CFG.inner_step + upd
    for _ in range(cap):
        want += ["step.gate_read"] + upd
    assert order == want
    names = [s["name"] for s in phases]
    assert names[0] == "step.targets" and names[-1] == "step.decode"
    # torch's own optimizer spans sit inside the step's optimizer span
    optim = [s for s in phases if s["name"] == "step.optim"]
    adam = [s for s in spans if s["name"].startswith("Optimizer.step")]
    assert len(adam) == 1 + cap
    assert all(any(_inside(a, o) for o in optim) for a in adam)


def test_single_level_step_has_its_spans(engine):
    eng, params = engine
    plain = teng.BilevelEngine(CFG.replace(use_boa=False), eng.model,
                               eng.prior, eng.smpls, eng.store)
    state = plain.init_state(params, img_res=F.IMG)
    (_, _), spans = _profiled(lambda: plain.step(state, _frames(1)[0]))
    names = [s["name"] for s in spans if s["name"].startswith("step.")]
    assert names == ["step.targets", "step.init_forward", "step.retrieve",
                     "step.grad.lower", "step.optim", "step.decode"]


def _tree_equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k])
                                            for k in a)
    return a == b


def test_profiler_leaves_the_step_bit_equal(engine):
    eng, params = engine
    frames = _frames(3)

    def three():
        state = eng.init_state(params, img_res=F.IMG)
        outs = []
        for f in frames:
            state, out = eng.step(state, f, cos_sim_threshold=-1.0)
            outs.append(out)
        return state, outs

    s_off, o_off = three()
    (s_on, o_on), spans = _profiled(three)
    assert sum(s["name"] == "engine.step" for s in spans) == 3
    for a, b in zip(o_off, o_on):
        assert _tree_equal(a, b)
    assert _tree_equal(s_off.params, s_on.params)
    assert _tree_equal(s_off.teacher_params, s_on.teacher_params)
    for p_off, p_on in zip(s_off.params.values(), s_on.params.values()):
        assert _tree_equal(s_off.optimizer.state[p_off],
                           s_on.optimizer.state[p_on])
    assert torch.equal(s_off.hist_images, s_on.hist_images)
    assert torch.equal(s_off.rng.get_state(), s_on.rng.get_state())


@pytest.mark.parametrize("synchronous", [False, True])
def test_stream_reports_the_pipeline_wait(system, synchronous):
    n = 7
    frames, kps = _frames_and_kps(n)
    summary = tstream.run(system, iter(frames), _Provider(kps),
                          lambda img: None, synchronous=synchronous)
    assert summary["steady_frames"] == n - 3
    assert set(summary["wait_ms"]) == {"pipeline"}
    wait = summary["wait_ms"]["pipeline"]
    assert math.isfinite(wait) and wait > 0.0


def test_stream_reports_its_gradient_evaluations(system):
    """The summary counts the call's own gradient evaluations by how they
    ran; on the CPU every one is eager."""
    frames, kps = _frames_and_kps(5)
    system.engine.graph_stats["eager"] += 100    # an earlier call's
    summary = tstream.run(system, iter(frames), _Provider(kps),
                          lambda img: None)
    stats = summary["graph_stats"]
    assert set(stats) == {"eager", "captures", "replays", "capture_ms"}
    # a lower and at least one upper evaluation per adapted frame
    assert 2 * summary["adapted"] <= stats["eager"] < 100
    assert stats["captures"] == stats["replays"] == stats["capture_ms"] == 0


def test_stream_main_loop_spans(system):
    n = 5
    frames, kps = _frames_and_kps(n)
    _, spans = _profiled(lambda: tstream.run(
        system, iter(frames), _Provider(kps), lambda img: None))
    count = {k: sum(s["name"] == f"stream.{k}" for s in spans)
             for k in tstream.MAIN_PHASES}
    # the read that ends the stream is a span too; one frame passes through
    assert count == {"read": n + 1, "kp": n, "prep": n - 1, "submit": n,
                     "deliver": n - 2}
    steps = [s for s in spans if s["name"] == "engine.step"]
    submits = [s for s in spans if s["name"] == "stream.submit"]
    assert len(steps) == n - 1
    assert all(any(_inside(s, u) for u in submits) for s in steps)


def test_runner_spans(engine, tmp_path):
    eng, params = engine
    runner = StreamRunner(eng, str(tmp_path / "exp"), log_every=1000,
                          checkpoint_every=2,
                          profile_dir=str(tmp_path / "prof"))
    state = eng.init_state(params, img_res=F.IMG)
    runner.run(SyntheticStream(3, F.IMG, 5), state, chunk_size=1)
    runner.close()
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    count = {k: sum(s["name"] == f"runner.{k}" for s in spans)
             for k in ("build_frame", "chunk", "to_host", "record",
                       "checkpoint")}
    # a checkpoint after frame 2 and the final one after frame 3
    assert count == {"build_frame": 3, "chunk": 3, "to_host": 3,
                     "record": 3, "checkpoint": 2}
    chunks = [s for s in spans if s["name"] == "runner.chunk"]
    steps = [s for s in spans if s["name"] == "engine.step"]
    assert len(steps) == 3
    assert all(any(_inside(s, c) for c in chunks) for s in steps)
