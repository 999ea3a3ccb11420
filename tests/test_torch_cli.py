"""The port's benchmark CLI end to end on the CPU at the tiny size."""

import json
import os

import numpy as np
import pytest

from dynaboa_tpu_torch.apps import benchmark


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("exp")
    summary = benchmark.main(["--device", "cpu", "--tiny", "1",
                              "--synthetic", "4", "--expdir", str(d),
                              "--expname", "run", "--use_pallas_lbs", "1",
                              "--save_res", "1", "--interval", "2",
                              "--optim_steps", "2"])
    return summary, d / "run"


def test_cli_writes_artifacts(cli_run):
    summary, path = cli_run
    assert (path / "res.txt").read_text().startswith("MPJPE:")
    lines = [json.loads(x) for x in open(path / "scalars.jsonl")]
    assert [r["step"] for r in lines] == [0, 1, 2, 3]
    for key in ("metrics/mpjpe", "ll/loss", "ul/loss", "teacher/loss",
                "dynamic/optim_steps", "feat_sim/tap12"):
        assert key in lines[0], key
    assert sorted(os.listdir(path / "result")) == [
        f"Pred_{i}.npz" for i in range(4)]
    pred = np.load(path / "result" / "Pred_0.npz")
    assert pred["verts"].shape == (1, 256, 3) and pred["cam"].shape == (1, 3)
    for f in ("res.npz", "optim_step_record.npz", "feat_sims.npz",
              "steps_statistic_res.npz", "setting.txt"):
        assert (path / f).exists(), f


def test_cli_summary_finite(cli_run):
    summary, _ = cli_run
    assert summary["frames"] == 4
    for k in ("mpjpe", "pampjpe", "pve"):
        assert np.isfinite(summary[k]), k
    assert len(summary["optim_steps"]) == 4
    assert all(0 <= n <= 2 for n in summary["optim_steps"])


@pytest.mark.parametrize("flags", [
    ["--chunk_size", "2"], ["--window_size", "2"],
    ["--fused_preprocess", "1"], ["--parallel_streams", "2"],
    ["--resume", "ckpt.npz"], ["--checkpoint_every", "5"],
    [],   # no --synthetic: a real 3DPW stream
])
def test_cli_refuses_unported_flags(flags, tmp_path):
    base = ["--device", "cpu", "--tiny", "1", "--expdir", str(tmp_path)]
    if flags:
        base += ["--synthetic", "2"]
    with pytest.raises(SystemExit, match="not ported"):
        benchmark.main(base + flags)


def test_cli_bf16_not_implemented(tmp_path):
    with pytest.raises(NotImplementedError):
        benchmark.main(["--device", "cpu", "--tiny", "1", "--synthetic", "2",
                        "--expdir", str(tmp_path), "--compute_dtype",
                        "bfloat16"])


def test_cli_defaults_to_cuda():
    assert benchmark.build_parser().parse_args([]).device == "cuda"


def test_profile_device_busy_is_the_union_of_device_intervals(tmp_path):
    """The profile's idle share: overlapping kernels count once, host events
    not at all, and the span runs from the first device start to the last
    device end."""
    from dynaboa_tpu_torch.apps.profile import device_busy

    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"traceEvents": [
        {"cat": "kernel", "ts": 0, "dur": 10},
        {"cat": "kernel", "ts": 5, "dur": 10},
        {"cat": "kernel", "ts": 6, "dur": 2},
        {"cat": "gpu_memcpy", "ts": 20, "dur": 5},
        {"cat": "cpu_op", "ts": 0, "dur": 100},
        {"ph": "M", "name": "process_name"}]}))
    assert device_busy(str(trace)) == (3, 20.0, 25)
