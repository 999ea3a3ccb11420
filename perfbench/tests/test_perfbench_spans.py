"""The readers of the program's spans: each step phase's idle time per
``step`` call from a trace put through ``trace.reduce``, ``None`` where the
program has no step spans; ``step_calls`` still counts the harness's span
alone with the program's spans inside it; the pipeline's wait from the
stream app's summary; and every new name under its cell only."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from perfbench.harness import cli, trace

import tiny

ROOT = tiny.ROOT
WEBCAM, PW3D = "webcam.video_vga", "pw3d.geo_updates"
STEP_READERS = ("step.grad_idle_ms", "step.optim_idle_ms",
                "step.gate_idle_ms", "step.decode_idle_ms")
NEW = STEP_READERS + tuple(f"{m}.engine" for m in STEP_READERS) + (
    "stream.pipeline_wait_ms",)

# one frame's host spans and device gaps, in microseconds from its start:
# (name, start, end); gaps as (start, end)
SPANS = [("engine.step", 10, 990), ("step.targets", 20, 60),
         ("step.grad.lower", 100, 300), ("step.grad.upper", 300, 500),
         ("step.optim", 500, 600), ("Optimizer.step#Adam.step", 520, 580),
         ("step.probe", 600, 700), ("step.gate_read", 700, 720),
         ("step.record", 720, 760), ("step.decode", 800, 980)]
OPS = [("aten::mm", 310, 330)]
GAPS = [(30, 50), (120, 180), (312, 318), (320, 400), (505, 515),
        (530, 570), (610, 690), (705, 715), (730, 750), (760, 790),
        (820, 960), (992, 998)]
# idle per frame by reader, in ms
WANT = {"step.grad_idle_ms": (60 + 80) / 1e3,
        "step.optim_idle_ms": (10 + 40) / 1e3,
        "step.gate_idle_ms": (80 + 10) / 1e3,
        "step.decode_idle_ms": (20 + 20 + 140) / 1e3}
FRAME_US, N_FRAMES = 10_000, 3


def events(program_spans: bool = True, gaps: list = GAPS) -> list:
    """``N_FRAMES`` frames, each in the harness's ``BilevelEngine.step``
    span, with kernels filling all but ``gaps``."""
    ev = []

    def add(cat, name, a, b):
        ev.append({"cat": cat, "name": name, "ts": float(a),
                   "dur": float(b - a), "tid": 1, "pid": 1})

    for f in range(N_FRAMES):
        o = f * FRAME_US
        add("user_annotation", trace.STEP_SPAN, o, o + 1000)
        for name, a, b in SPANS:
            if program_spans or not name.startswith(("engine.", "step.")):
                add("user_annotation", name, o + a, o + b)
        for name, a, b in OPS:
            add("cpu_op", name, o + a, o + b)
        edges = [0] + [t for g in gaps for t in g] + [1000]
        for a, b in zip(edges[::2], edges[1::2]):
            add("kernel", "k", o + a, o + b)
    return ev


def read(name, r):
    return cli.reader(name)(r, {})


def test_readers_give_ms_per_step_call():
    r = {"trace": trace.reduce(events())}
    assert r["trace"]["step_calls"] == N_FRAMES
    idle = r["trace"]["idle_by_host_op"]
    assert idle["aten::mm"] == pytest.approx(N_FRAMES * 6e-6)
    assert idle["engine.step"] == pytest.approx(N_FRAMES * 30e-6)
    assert idle[trace.STEP_SPAN] == pytest.approx(N_FRAMES * 6e-6)
    for name, want in WANT.items():
        assert read(name, r) == pytest.approx(want)
        assert read(f"{name}.engine", r) == pytest.approx(want)


def test_readers_give_none_without_the_programs_spans():
    """As on a program before its spans: torch's own ``Optimizer.*`` spans
    are there, the step's are not."""
    r = {"trace": trace.reduce(events(program_spans=False))}
    assert r["trace"]["step_calls"] == N_FRAMES
    assert "Optimizer.step#Adam.step" in r["trace"]["idle_by_host_op"]
    for name in STEP_READERS:
        assert read(name, r) is None
        assert read(f"{name}.engine", r) is None
    assert read("step.grad_idle_ms", {}) is None


def test_a_phase_without_idle_reads_zero_beside_the_others():
    gate = {(610, 690), (705, 715)}
    r = {"trace": trace.reduce(events(gaps=[g for g in GAPS
                                             if g not in gate]))}
    assert read("step.gate_idle_ms", r) == 0.0
    assert read("step.grad_idle_ms", r) == pytest.approx(
        WANT["step.grad_idle_ms"])


def test_pipeline_wait_reads_the_summary():
    assert read("stream.pipeline_wait_ms", {}) is None
    s = {"main_ms": {}, "emit_ms": {}}
    assert read("stream.pipeline_wait_ms", {"summary": s}) is None
    s["wait_ms"] = {"pipeline": 12.5}
    assert read("stream.pipeline_wait_ms", {"summary": s}) == 12.5


def test_harness_span_counts_steps_with_the_programs_spans_inside():
    """A CPU ``trace.profile`` of the harness-wrapped step: the program's
    ``engine.step`` and phase spans do not add to ``step_calls``."""
    from dynaboa_tpu_torch.apps.common import build_system
    from dynaboa_tpu_torch.config import AdaptConfig, Paths
    from dynaboa_tpu_torch.engine.bilevel import Frame

    torch.set_num_threads(2)
    system = build_system(
        AdaptConfig(interval=2, optim_steps=2, retrieval=False), Paths(),
        "cpu", img_res=32, model_kwargs=dict(layers=(1, 1, 1, 1), width=8,
                                             regressor_dim=32),
        num_vertices=256)
    rng = np.random.default_rng(0)

    def frame():
        return Frame(
            image=torch.as_tensor(rng.normal(size=(1, 32, 32, 3)),
                                  dtype=torch.float32),
            j2d=torch.as_tensor(np.concatenate(
                [rng.uniform(-1, 1, (1, 49, 2)), np.ones((1, 49, 1))], -1),
                dtype=torch.float32),
            pose=torch.zeros((1, 72)), betas=torch.zeros((1, 10)),
            gender=torch.zeros((1,), dtype=torch.int32))

    engine = system.engine
    state = engine.init_state(system.params, img_res=32)
    frames = [frame() for _ in range(3)]

    def body():
        nonlocal state
        for f in frames:
            with torch.profiler.record_function(trace.STEP_SPAN):
                state, _ = engine.step(state, f, cos_sim_threshold=-1.0,
                                       extra_cap=1)

    tr = trace.profile(body, torch.device("cpu"))
    assert tr["step_calls"] == len(frames)


def test_every_new_name_is_under_its_cell_only():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for name in NEW:
        m = per_layer[name]
        cell = PW3D if name.endswith(".engine") else WEBCAM
        assert m["workloads"] == [cell], name
        assert cell in e2e[m["moves"]]["workloads"], name
        assert m["better"] == "lower" and m["unit"] == "ms/frame"
        assert os.path.isfile(os.path.join(ROOT, "perfbench", "metrics",
                                           f"{name}.py"))
    assert per_layer["stream.pipeline_wait_ms"]["moves"] == \
        "frame_latency_ms_p95"
    # new entries come last, after every accepted one
    assert {m["name"] for m in bench["per_layer"][-len(NEW):]} == set(NEW)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.make_tree(str(tmp_path_factory.mktemp("tree")))


def test_traced_webcam_run_reads_the_pipeline_wait(tree):
    root, bench = tree
    res, r, _, _ = tiny.run(root, bench, WEBCAM, traced=True)
    assert res["correct"]
    assert r["summary"]["wait_ms"]["pipeline"] > 0.0
    assert res["metrics"]["stream.pipeline_wait_ms"]["value"] == \
        r["summary"]["wait_ms"]["pipeline"]
    # no device on the CPU: no idle gap to put down to a phase
    assert not set(STEP_READERS) & set(res["metrics"])
