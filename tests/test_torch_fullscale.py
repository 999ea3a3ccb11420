"""The full-width parity harness (``dynaboa_tpu_torch/tools/
fullscale_parity.py``) and its committed JAX record.

At the tiny size (the fixtures' IMG 32, width 16, V = 256, 4 frames) the
golden generator's ``record`` runs the three arms through the JAX engine
(each also from every weight one ulp up or down, and the other way: the
reference's own spread), the port's ``run_all`` through the port's, and
``compare`` must pass every bound.  A record with a loss, a step count or
a weight coordinate moved past its bound, and a run with a fault planted
from frame 1, in the last vertices or in one weight, must fail and name the
field; the gate arm's margin rule must excuse a count that differs only at
a near-threshold frame; a check's allowance must follow the recorded
spread from the frame it grows on, and not before.  The committed
``assets/fullscale_jax.npz`` must hold the three arms at full width, drawn
from the recipe the port draws on the CPU, with the spread of every check.
The full-width comparison on the CPU is ``slow`` (opt in with
``-m slow``)."""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

from dynaboa_tpu_torch.tools import fullscale_parity as fp
from tests import torch_fullscale_golden as golden
from tests import torch_port_fixtures  # noqa: F401  (shares the cores)

TINY_FRAMES = 4
RECORD_MAX_BYTES = 4 * 2 ** 20


@pytest.fixture(scope="module")
def tiny():
    record = golden.record("tiny", TINY_FRAMES, log=lambda s: None)
    run = fp.run_all("cpu", "tiny", TINY_FRAMES, centers=record["centers"])
    return record, run


@pytest.mark.parametrize("arm", list(fp.ARMS))
def test_tiny_harness_passes(tiny, arm):
    record, run = tiny
    result = fp.compare(record, run)
    a = result["arms"][arm]
    assert [f"{arm}/{c['field']}" for c in a["checks"] if not c["ok"]] == []
    assert a["compared_frames"] == TINY_FRAMES and a["split_at"] is None
    fields = {c["field"] for c in a["checks"]}
    assert {"optim_steps", "lower_loss", "upper/loss", "per_step_sims",
            "pampjpe", "verts_last", "params_at", "teacher_at",
            "update_norm", "recipe/init_checksum"} <= fields
    assert len(fp.report_lines(result)) == len(fp.ARMS)


def _perturb(record, arm, field, index, fn):
    rec = copy.deepcopy(record)
    a = rec["arms"][arm][field]
    a[index] = fn(a[index])
    return rec


@pytest.mark.parametrize("field,index,fn", [
    ("upper/loss", 1, lambda v: v * 1.1 + 1e-3),
    ("optim_steps", 0, lambda v: v + 1),
    ("params_at", 5, lambda v: v + 1e-3),       # far past 4 * n * lr
])
def test_perturbed_record_fails_naming_the_field(tiny, field, index, fn):
    record, run = tiny
    result = fp.compare(_perturb(record, "base", field, index, fn), run)
    assert not result["ok"]
    assert f"base/{field}" in fp.failures(result)
    if field == "params_at":
        check = next(c for c in result["arms"]["base"]["checks"]
                     if c["field"] == field)
        assert check["leaf"] in record["meta"]["leaves"]


def _plant(run, arm, field, index, fn):
    run = copy.deepcopy(run)
    a = run["arms"][arm][field]
    a[index] = fn(a[index])
    return run


@pytest.mark.parametrize("field,index,fn", [
    ("upper/loss", slice(1, None), lambda v: v * 1.1),
    ("verts_last", 0, lambda v: v + 1e-2),
    ("params_at", 5, lambda v: v + 1e-3),       # far past 4 * n * lr
])
def test_fault_in_the_run_fails_naming_the_field(tiny, field, index, fn):
    """A fault of the run, not of the record: it must fail although the
    record's spread widens the allowance of the later frames."""
    record, run = tiny
    result = fp.compare(record, _plant(run, "base", field, index, fn))
    assert fp.failures(result) == [f"base/{field}"]


@pytest.mark.parametrize("near", [True, False])
def test_gate_margin_rule(tiny, near):
    """A gate-arm frame whose count differs is excused only where a JAX
    gate margin lies within 10x the other arms' largest sim gap; the runs
    have split there, so no later frame and no weight is compared."""
    record, run = tiny
    rec = _perturb(record, "gate_live", "optim_steps", 0,
                   lambda v: v + 1)
    if near:
        rec["arms"]["gate_live"]["per_step_sims"][0, 0] = 1.0 - fp.THRESHOLD
    result = fp.compare(rec, run)
    a = result["arms"]["gate_live"]
    assert a["split_at"] == 0 and a["compared_frames"] == 0
    assert [x["frame"] for x in a["near_threshold"]] == ([0] if near else [])
    assert result["ok"] is near
    assert ("gate_live/optim_steps" in fp.failures(result)) is not near
    assert "params_at" not in {c["field"] for c in a["checks"]}


@pytest.mark.parametrize("frame,delta,ok", [
    (3, 0.36, True), (3, 0.44, False), (1, 0.1, False)])
def test_allowance_follows_the_reference_spread(tiny, frame, delta, ok):
    """With the reference's own PVE spread 0.1 mm at frame 2 the allowance
    is SPREAD_FACTOR x 0.1 = 0.4 mm from frame 2 on (the spread's running
    maximum), and the bound 0.05 mm before it."""
    record, run = tiny
    rec = copy.deepcopy(record)
    rec["arms"]["base"]["spread/pve"][:] = 0.0
    rec["arms"]["base"]["spread/pve"][2] = 0.1
    rec["arms"]["base"]["pve"][frame] += delta
    result = fp.compare(rec, run)
    check = next(c for c in result["arms"]["base"]["checks"]
                 if c["field"] == "pve")
    assert check["widened_from"] == 2
    assert check["allowance"] == pytest.approx(fp.SPREAD_FACTOR * 0.1)
    assert check["ok"] is ok and result["ok"] is ok
    assert ("base/pve" in fp.failures(result)) is not ok


def test_reference_misses_the_output_bounds_against_itself():
    """Why the record holds the spread: in the committed record the JAX
    engine from every weight one ulp up or down ends farther from itself
    than the last frame's vertex bound and the PVE bound after 12 frames,
    while the weights' spread stays inside the Adam drift bound, so that
    they are held to that bound."""
    record = fp.load_record()
    for arm, R in record["arms"].items():
        lr = record["meta"]["arms"][arm]["config"]["lr"]
        drift = fp.DRIFT_FACTOR * int(np.sum(R["optim_steps"] + 1)) * lr
        assert R["spread/verts_last"].max() > fp.VERTS_ATOL_M
        assert R["spread/pve"].max() > fp.METRIC_ATOL_MM
        assert fp.SPREAD_FACTOR * R["spread/params_at"].max() < drift
        assert fp.SPREAD_FACTOR * R["spread/teacher_at"].max() < drift


CHECK_FIELDS = ("lower_loss", "per_step_loss", "per_step_sims",
                *fp.METRIC_KEYS, "verts_first", "verts_last", "params_at",
                "teacher_at", "update_norm")


@pytest.fixture(scope="module")
def full_recipe():
    S = fp.SIZES["full"]
    weights = fp.draw_weights(S)
    return weights, fp.cluster_centers(S, weights, fp.N_FRAMES)


def test_committed_record_holds_the_recipe_at_full_width(full_recipe):
    weights, centers = full_recipe
    assert os.path.getsize(fp.RECORD) <= RECORD_MAX_BYTES
    record = fp.load_record()
    meta = record["meta"]
    assert meta["recipe_version"] == fp.RECIPE_VERSION
    assert meta["size"] == "full" and meta["n_frames"] == fp.N_FRAMES
    assert meta["backend"] == "cpu"
    assert sorted(record["arms"]) == sorted(fp.ARMS)
    assert meta["leaves"] == sorted(weights)
    np.testing.assert_allclose(np.asarray(meta["init_checksum"]),
                               fp.checksums(weights), rtol=fp.CHECKSUM_RTOL)
    # the centres amplify the features' rounding (which follows the CPU's
    # thread count): CENTER_GAIN times |mean| over the exemplars' small
    # spread about their mean
    np.testing.assert_allclose(record["centers"], centers, rtol=0,
                               atol=1e-3 * np.abs(centers).max())
    np.testing.assert_allclose(np.asarray(meta["centers_checksum"]),
                               fp.checksums({"c": record["centers"]}),
                               rtol=fp.CHECKSUM_RTOL)
    n_coords = sum(meta["coord_counts"])
    for arm, arrays in record["arms"].items():
        cfg, thr = fp.arm_config(arm)
        assert meta["arms"][arm]["thr"] == thr
        assert meta["arms"][arm]["config"] == dataclasses.asdict(cfg)
        assert arrays["optim_steps"].shape == (fp.N_FRAMES,)
        assert arrays["verts_last"].shape == (1, 6890, 3)
        assert arrays["params_at"].shape == (n_coords,)
        assert np.isfinite(arrays["per_step_loss"]).all()
        # the reference's spread: every check, on one trajectory
        upper = [k for k in arrays if k.startswith("upper/")]
        for field in (*CHECK_FIELDS, *upper):
            assert np.isfinite(arrays[f"spread/{field}"]).all(), field
        assert (arrays["spread_steps"] == arrays["optim_steps"]).all()


def test_record_varies_the_gate_and_the_retrieval():
    """The gate opens on some frames of the gate arm and not on others,
    and retrieval takes other exemplars than ``base``'s."""
    record = fp.load_record()
    steps = record["arms"]["gate_live"]["optim_steps"]
    assert 0 < np.count_nonzero(steps) < fp.N_FRAMES
    assert not np.allclose(record["arms"]["retrieval_on"]["upper/loss"],
                           record["arms"]["base"]["upper/loss"], rtol=1e-3)


def test_retrieval_argmax_moves_across_frames(full_recipe):
    """At the initial weights the frames' pooled features pick at least
    three of the record's clusters, each by a cosine margin far above the
    rounding of two devices."""
    weights, _ = full_recipe
    S = fp.SIZES["full"]
    net = fp.hmr_for(S)
    net.load_state_dict({k: torch.as_tensor(v) for k, v in weights.items()},
                        strict=False)
    images = np.concatenate(
        [f["image"] for f in fp.make_frames(fp.N_FRAMES, S.img)])
    with torch.no_grad():
        f5 = net.eval()(torch.as_tensor(images).permute(0, 3, 1, 2))[3][5]
    f = f5.double().numpy()
    c = fp.load_record()["centers"].astype(np.float64)
    cos = (f / np.linalg.norm(f, axis=1, keepdims=True)) @ (
        c / np.linalg.norm(c, axis=1, keepdims=True)).T
    top = np.sort(cos, 1)
    assert len(set(cos.argmax(1).tolist())) >= 3
    assert (top[:, -1] - top[:, -2]).min() > 1e-5


@pytest.mark.slow
def test_fullscale_port_on_cpu_matches_the_record():
    record = fp.load_record()
    run = fp.run_all("cpu", "full", record["meta"]["n_frames"],
                     centers=record["centers"])
    result = fp.compare(record, run)
    print("\n".join(fp.report_lines(result)))
    assert result["ok"], fp.failures(result)
