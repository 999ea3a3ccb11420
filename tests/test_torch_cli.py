"""The port's benchmark CLI end to end on the CPU at the tiny size."""

import json
import os

import numpy as np
import pytest

from dynaboa_tpu_torch.apps import benchmark
from tests import torch_port_fixtures  # noqa: F401  (shares the cores)


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


def _tiny(tmp_path, *flags):
    return benchmark.main(["--device", "cpu", "--tiny", "1", "--expdir",
                           str(tmp_path), "--expname", "run",
                           "--optim_steps", "1", *flags])


def _check_chunk(tmp_path):
    summary = _tiny(tmp_path, "--synthetic", "3", "--chunk_size", "2")
    assert summary["frames"] == 3 and len(summary["optim_steps"]) == 3


def _check_window(tmp_path):
    summary = _tiny(tmp_path, "--synthetic", "3", "--window_size", "2")
    rows = [json.loads(x) for x in open(tmp_path / "run" / "scalars.jsonl")]
    assert [r["step"] for r in rows] == [0, 1, 2]   # the pad row is dropped
    # one shared update count per window
    assert summary["optim_steps"][0] == summary["optim_steps"][1]


def _check_fused(tmp_path):
    summary = _tiny(tmp_path, "--synthetic", "2", "--fused_preprocess", "1")
    assert summary["frames"] == 2 and np.isfinite(summary["mpjpe"])


def _check_checkpoint(tmp_path):
    # fewer frames than the interval: the final checkpoint is still written
    _tiny(tmp_path, "--synthetic", "2", "--checkpoint_every", "5")
    ckpt = tmp_path / "run" / "checkpoint.npz"
    assert ckpt.exists() and not (tmp_path / "run" / "checkpoint.npz.tmp"
                                  ).exists()


def _check_resume(tmp_path):
    _tiny(tmp_path, "--synthetic", "2", "--checkpoint_every", "1",
          "--max_frames", "1")
    ckpt = str(tmp_path / "run" / "checkpoint.npz")
    summary = benchmark.main(["--device", "cpu", "--tiny", "1", "--expdir",
                              str(tmp_path), "--expname", "resumed",
                              "--optim_steps", "1", "--synthetic", "2",
                              "--resume", ckpt])
    assert summary["frames"] == 1     # frame 0 came from the checkpoint


def _check_auto_reset(tmp_path):
    summary = _tiny(tmp_path, "--synthetic", "2", "--auto_reset", "1")
    assert summary["frames"] == 2 and summary["reset_count"] == 0


def _check_profile(tmp_path):
    _tiny(tmp_path, "--synthetic", "1", "--profile_dir",
          str(tmp_path / "prof"))
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]


def _check_real_stream(tmp_path):
    # no --synthetic: the 3DPW archives, which are not in the repository
    with pytest.raises(FileNotFoundError, match="3dpw"):
        _tiny(tmp_path)


PORTED = {"chunk_size": _check_chunk, "window_size": _check_window,
          "fused_preprocess": _check_fused,
          "checkpoint_every": _check_checkpoint, "resume": _check_resume,
          "auto_reset": _check_auto_reset, "profile_dir": _check_profile,
          "real_3dpw_stream": _check_real_stream}


@pytest.mark.parametrize("flag", list(PORTED))
def test_cli_runs_ported_flags(flag, tmp_path):
    PORTED[flag](tmp_path)


def test_cli_refuses_unported_flags(tmp_path):
    with pytest.raises(SystemExit, match="not ported"):
        benchmark.main(["--device", "cpu", "--tiny", "1", "--expdir",
                        str(tmp_path), "--synthetic", "2",
                        "--parallel_streams", "2"])


def test_internet_cli_writes_every_prediction(tmp_path):
    from dynaboa_tpu_torch.apps import internet

    summary = internet.main(["--device", "cpu", "--tiny", "1",
                             "--synthetic", "4", "--expdir", str(tmp_path),
                             "--optim_steps", "1"])
    path = tmp_path / "internet"
    assert sorted(os.listdir(path / "result")) == [
        f"Pred_{i}.npz" for i in range(4)]
    for i in range(4):
        pred = np.load(path / "result" / f"Pred_{i}.npz")
        assert pred["verts"].shape == (1, 256, 3)
        assert np.isfinite(pred["verts"]).all()
    # unlabeled: no metric is computed, the records are zeros
    assert summary["mpjpe"] == summary["pve"] == 0.0
    assert "shape_prior_weight : 0.0002" in (path / "setting.txt").read_text()


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
