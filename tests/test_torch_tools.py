"""The port's offline tools against the JAX package's: the retrieval store
builder (k-means, tap-5 features, the CLI on a joblib exemplar bank), the
SMPL pickle converter, and the cold-start timer and the flag-grid sweep
over the benchmark CLI."""

import json

import os
import pickle
import sys

import joblib
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dynaboa_tpu_torch.models import hmr as thmr
from dynaboa_tpu_torch.tools import bench_coldstart as tcold
from dynaboa_tpu_torch.tools import build_retrieval as tbr
from dynaboa_tpu_torch.tools import convert_smpl as tconv
from dynaboa_tpu_torch.tools import sweep as tsweep
from tests import torch_port_fixtures as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import build_retrieval as jbr  # noqa: E402
import convert_smpl as jconv  # noqa: E402
import sweep as jsweep  # noqa: E402

# test_torch_hmr.py's tap tolerance; measured worst tap-5 gap 4.9e-6 on 32^2
# noise images and 5.5e-6 on 224^2 ones (features up to 5 in size)
TAP_RTOL = TAP_ATOL = 1e-4


@pytest.fixture(scope="module")
def nets():
    jmodel, jparams = F.jax_hmr(seed=2)
    return jmodel, jparams, F.torch_hmr_from(jparams)


def _jax_tap5(jmodel, jparams, images):
    feat = jax.jit(lambda x: jmodel.apply({"params": jparams}, x)[3][5])
    return np.concatenate([np.asarray(feat(jnp.asarray(images[i:i + 8])))
                           for i in range(0, len(images), 8)])


def test_kmeans_bit_equal_on_jax_features(nets):
    jmodel, jparams, _ = nets
    images = np.random.default_rng(0).normal(
        size=(20, F.IMG, F.IMG, 3)).astype(np.float32)
    feats = _jax_tap5(jmodel, jparams, images)
    for k, seed in ((3, 0), (5, 1)):
        tc, ta = tbr.kmeans(feats, k, seed=seed)
        jc, ja = jbr.kmeans(feats, k, seed=seed)
        assert tc.tobytes() == jc.tobytes() and ta.tobytes() == ja.tobytes()


def test_tap5_features_match_jax(nets):
    jmodel, jparams, tnet = nets
    images = np.random.default_rng(1).normal(
        size=(12, F.IMG, F.IMG, 3)).astype(np.float32)
    centers, assign, feats = tbr.features_and_clusters(
        torch.as_tensor(images), tnet, 3)
    want = _jax_tap5(jmodel, jparams, images)
    assert feats.shape == want.shape == (12, F.XF)
    np.testing.assert_allclose(feats, want, rtol=TAP_RTOL, atol=TAP_ATOL)
    np.testing.assert_allclose(np.linalg.norm(centers, axis=1), 1.0,
                               atol=1e-5)
    assert assign.shape == (12,) and set(assign.tolist()) <= {0, 1, 2}


@pytest.fixture
def exemplar_bank(tmp_path, nets):
    """A joblib exemplar archive of 10 crops of cv2-written images (the
    recipe of test_torch_streams.py) and the tiny HMR as a basemodel.pt."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(3)
    M = 10
    names = [f"e{i}.png" for i in range(M)]
    for name in names:
        assert cv2.imwrite(str(tmp_path / name), rng.integers(
            0, 256, (48, 64, 3), np.uint8))
    joblib.dump(dict(
        imgname=names,
        center=rng.uniform([20, 15], [44, 33], size=(M, 2)).astype(np.float32),
        scale=rng.uniform(0.15, 0.3, size=M).astype(np.float32),
        pose=rng.normal(size=(M, 72)), shape=rng.normal(size=(M, 10)),
        S=rng.normal(size=(M, 24, 4)),
        part=rng.uniform(0, 1, size=(M, 24, 3)).astype(np.float32)),
        tmp_path / "source.pt")
    torch.save({"model": thmr.params_from_jax(nets[1])},
               tmp_path / "basemodel.pt")
    return tmp_path


def test_cli_matches_the_jax_tool(exemplar_bank, monkeypatch):
    d = exemplar_bank
    args = ["--source", str(d / "source.pt"), "--h36m-root", str(d),
            "--basemodel", str(d / "basemodel.pt"), "--clusters", "3"]
    tbr.main(args + ["--out", str(d / "t.npz"), "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["build_retrieval.py", *args, "--out",
                                      str(d / "j.npz")])
    jbr.main()
    t, j = np.load(d / "t.npz"), np.load(d / "j.npz")
    assert sorted(t.files) == sorted(j.files) == ["assignments", "centers",
                                                  "feats"]
    assert t["feats"].shape == (10, F.XF)
    np.testing.assert_allclose(t["feats"], j["feats"], rtol=TAP_RTOL,
                               atol=TAP_ATOL)
    np.testing.assert_array_equal(t["assignments"], j["assignments"])
    np.testing.assert_allclose(t["centers"], j["centers"], rtol=0, atol=1e-5)


def test_cli_needs_the_card_it_names(exemplar_bank, monkeypatch):
    """--device defaults to cuda and raises without a CUDA device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = exemplar_bank
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbr.main(["--source", str(d / "source.pt"), "--h36m-root", str(d),
                  "--basemodel", str(d / "basemodel.pt"), "--out",
                  str(d / "t.npz")])


def test_convert_smpl_matches_the_jax_tool(tmp_path):
    """A pickle in the official layout (plain arrays; the chumpy shim is
    the same code in both) converts to the same npz."""
    rng = np.random.default_rng(4)
    V = 30
    kintree = np.stack([np.arange(24) - 1, np.arange(24)])
    data = dict(v_template=rng.normal(size=(V, 3)),
                shapedirs=rng.normal(size=(V, 3, 300)),
                posedirs=rng.normal(size=(V, 3, 207)),
                J_regressor=rng.uniform(size=(24, V)),
                weights=rng.uniform(size=(V, 24)), kintree_table=kintree,
                f=rng.integers(0, V, size=(40, 3)))
    with open(tmp_path / "SMPL_MALE.pkl", "wb") as f:
        pickle.dump(data, f)
    np.save(tmp_path / "extra.npy", rng.normal(size=(9, V)))
    for mod, out in ((tconv, "t.npz"), (jconv, "j.npz")):
        mod.convert_one(str(tmp_path / "SMPL_MALE.pkl"), str(tmp_path / out),
                        str(tmp_path / "extra.npy"))
    t, j = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert sorted(t.files) == sorted(j.files)
    for k in j.files:
        assert t[k].dtype == j[k].dtype and t[k].tobytes() == j[k].tobytes()
    assert t["posedirs"].shape == (207, V * 3) and t["kintree_parents"][0] == -1


def test_coldstart_child_reports_its_times():
    res = tcold.main(["--device", "cpu", "--tiny", "1", "--runs", "1"])
    assert res["backend"] == "cpu" and res["with_kernel_build"] is None
    (run,) = res["runs"]
    assert run["nvcc_s"] == 0.0        # the CPU takes the plain version
    for k in ("build_s", "first_step_s", "process_wall_s"):
        assert 0.0 < run[k] < 600.0, (k, run[k])
    assert run["build_s"] + run["first_step_s"] < run["process_wall_s"]


@pytest.mark.parametrize("specs", [
    ["lr=1e-6,3e-6", "interval=2,5,7"],
    ["optim_steps=3"],
    ["a=1,2", "b=x", "c=3,4"],
    ["cos_sim_threshold=-1,3.1e-4,1e-3"],
])
def test_parse_grid_equals_jax(specs):
    assert tsweep.parse_grid(specs) == jsweep.parse_grid(specs)


def test_parse_grid_refuses_a_bare_name():
    for parse in (tsweep.parse_grid, jsweep.parse_grid):
        with pytest.raises(ValueError, match="needs name=v1,v2"):
            parse(["lr"])


def test_sweep_writes_one_record_per_combination(tmp_path):
    path = tsweep.main(["--grid", "interval=2,5", "--base",
                        "--device cpu --tiny 1 --synthetic 2 --optim_steps 1",
                        "--out", str(tmp_path)])
    rows = [json.loads(x) for x in open(path)]
    assert [r["combo"] for r in rows] == [{"interval": "2"},
                                          {"interval": "5"}]
    for r in rows:
        assert (tmp_path / r["expname"] / "res.txt").exists()
        assert r["frames"] == 2 and len(r["optim_steps"]) == 2
        for k in ("mpjpe", "pampjpe", "pve", "fps", "wall_s"):
            assert np.isfinite(r[k]), k
