"""The port's soak (``dynaboa_tpu_torch/tools/soak.py``) on the CPU at the
tiny size: the sequential arm's kill, resume, injected NaN and bit-exact
control, a planted fault that the bit-exact check must catch, the parallel
arm's lazy partition and RSS bounds, and the result keys against the JAX
soak's committed records (read, never written)."""

import json
import os

import numpy as np
import pytest
import torch

from dynaboa_tpu_torch.engine import runner as trunner
from dynaboa_tpu_torch.tools import soak as tsoak
from tests import torch_port_fixtures  # noqa: F401  (shares the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_record(arm: str) -> dict:
    with open(os.path.join(REPO, "SOAK_r05.json")) as f:
        return json.load(f)[arm]


def _sequential(tmp_path, frames, every):
    return tsoak.main(["sequential", "--device", "cpu", "--tiny",
                       "--bitexact", "--frames", str(frames),
                       "--checkpoint_every", str(every), "--rss_every", "4",
                       "--log_every", "1000", "--expdir",
                       str(tmp_path / "exp"), "--out",
                       str(tmp_path / "soak.json")])


@pytest.fixture(scope="module")
def sequential(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("soak")
    return _sequential(tmp, 48, 8), tmp


def test_sequential_bitexact_resume(sequential):
    res, _ = sequential
    assert res["every_frame_seen_once"]
    assert res["phase_a_frames"] == res["resumed_at"] == 24
    assert res["phase_b_frames"] == 24
    assert res["injected_nan_frames"] == [16]
    assert res["auto_resets"] >= 1
    assert res["compute_dtype"] == "bfloat16" and res["backend"] == "cpu"
    b = res["bitexact_resume"]
    assert b["exact"] and b["resets_match"], b
    assert b["mismatched_leaves"] == 0 and b["max_abs_diff"] == 0.0


def test_sequential_keys_equal_jax_record(sequential):
    res, tmp = sequential
    want = _jax_record("sequential_bitexact")
    assert set(res) == set(want)
    assert set(res["bitexact_resume"]) == set(want["bitexact_resume"])
    assert set(res["rss_mb"]) == set(want["rss_mb"])
    with open(tmp / "soak.json") as f:
        written = json.load(f)
    assert written["sequential_bitexact"] == res and written["card"] is None


def test_planted_fault_fails_bitexact(tmp_path, monkeypatch):
    """One parameter moved in the checkpoint the resume loads: the resumed
    run's final state must no longer equal the straight run's.  Both resets
    (the NaN frame 12, and frame 17, whose motion loss reads it from the
    history) fall before the resume at 18: a reset after it would restore
    the initial weights and erase the fault."""
    load = trunner.load_state

    def moved(path, template):
        state = load(path, template)
        with torch.no_grad():
            next(iter(state.params.values())).view(-1)[0] += 1e-3
        return state

    monkeypatch.setattr(trunner, "load_state", moved)
    with pytest.raises(RuntimeError, match="differs from the straight run"):
        _sequential(tmp_path, 36, 6)


def test_compare_states_names_each_leaf():
    s, _ = tsoak.build_tiny_system("cpu", "float32")
    a = s.engine.init_state(s.params)
    b = s.engine.init_state(s.params)
    assert tsoak.compare_states(a, b) == {
        "exact": True, "mismatched_leaves": 0, "max_abs_diff": 0.0}
    with torch.no_grad():
        b.teacher_params["fc1.weight"][0, 0] += 0.5
    b.hist_j2d[0, 0, 0, 0] = float("nan")
    out = tsoak.compare_states(a, b)
    assert not out["exact"] and out["mismatched_leaves"] == 2
    assert out["max_abs_diff"] == pytest.approx(0.5)


@pytest.fixture(scope="module")
def parallel(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("soakp")
    res = tsoak.main(["parallel", "--device", "cpu", "--tiny", "--frames",
                      "64", "--streams", "4", "--out",
                      str(tmp / "soak.json")])
    return res, tmp


def test_parallel_runs_every_frame_within_rss_bounds(parallel):
    res, _ = parallel
    assert res["frames_run"] == res["frames_total"] == 64
    assert res["streams"] == 4 and np.isfinite(res["mpjpe"])
    rss = res["rss_mb"]
    assert rss["end"] - rss["after_warmup"] < 2048.0


def test_parallel_keys_equal_jax_record(parallel):
    res, tmp = parallel
    want = _jax_record("parallel_tpu")
    assert set(res) == set(want)
    assert set(res["rss_mb"]) == set(want["rss_mb"]) | {"after_warmup"}
    with open(tmp / "soak.json") as f:
        assert json.load(f)["parallel"] == res


def test_parallel_rss_bound_is_held(tmp_path, monkeypatch):
    # host RSS that grows by 1 GB at every reading: the run adds more than
    # the 2 GB bound over the warmed system
    readings = iter(range(0, 1 << 20, 1024))
    monkeypatch.setattr(tsoak, "rss_mb", lambda: float(next(readings)))
    with pytest.raises(RuntimeError, match="lazy partition is leaking"):
        tsoak.main(["parallel", "--device", "cpu", "--tiny", "--frames",
                    "8", "--streams", "2", "--out",
                    str(tmp_path / "soak.json")])


def test_no_card_no_result(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsoak.main(["parallel", "--out", str(tmp_path / "soak.json")])
    assert capsys.readouterr().out == ""
    assert not (tmp_path / "soak.json").exists()
