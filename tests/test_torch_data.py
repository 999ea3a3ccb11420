"""The port's stream, retrieval store and scalar writer against the JAX
package's, and the rule that the port never imports jax."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dynaboa_tpu.data import SyntheticStream as JStream
from dynaboa_tpu.engine import synthetic_store as j_store
from dynaboa_tpu.metrics.writer import ScalarWriter as JWriter
from dynaboa_tpu_torch.data.streams import SyntheticStream as TStream
from dynaboa_tpu_torch.engine import retrieval as tret
from dynaboa_tpu_torch.engine.runner import frame_from_item
from dynaboa_tpu_torch.metrics.writer import ScalarWriter as TWriter
from tests import torch_port_fixtures  # noqa: F401  (shares the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed,img_res", [(0, 32), (22, 224)])
def test_synthetic_stream_items_identical(seed, img_res):
    js, ts = JStream(5, img_res=img_res, seed=seed), TStream(5, img_res, seed)
    assert len(js) == len(ts) == 5
    for i in (0, 3, 4):
        a, b = js[i], ts[i]
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                    b[k].tobytes(), k
            else:
                assert a[k] == b[k], k


def test_frame_from_item_layout():
    item = TStream(2, 32, seed=1)[1]
    fr = frame_from_item(item, torch.device("cpu"))
    assert fr.image.shape == (1, 32, 32, 3)      # NHWC at the public API
    assert fr.j2d.shape == (1, 49, 3) and fr.gender.tolist() == [1]
    np.testing.assert_array_equal(fr.image[0].numpy(), item["image"])
    op = frame_from_item(item, torch.device("cpu"), keypoint_source="openpose")
    np.testing.assert_array_equal(op.j2d[0].numpy(), item["op_j2d"])


def test_synthetic_store_identical():
    js = j_store(seed=6, img_res=32, feat_dim=64)
    ts = tret.synthetic_store(6, torch.device("cpu"), img_res=32, feat_dim=64)
    for a, b in zip(ts.bank, js.bank):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(ts.centers.numpy(), np.asarray(js.centers))
    np.testing.assert_array_equal(ts.members.numpy(), np.asarray(js.members))
    np.testing.assert_array_equal(ts.member_mask.numpy(),
                                  np.asarray(js.member_mask))


def test_retrieve_draws_within_nearest_cluster_without_replacement():
    store = tret.synthetic_store(6, torch.device("cpu"), img_res=8,
                                 feat_dim=64)
    gen = torch.Generator().manual_seed(0)
    for c in range(store.centers.shape[0]):
        feat = store.centers[c] * 3.0       # exactly on centre c
        bank = tret.retrieve(store, feat, gen, sample_num=3)
        picked = {int(i) for i in range(store.bank.pose.shape[0])
                  for row in bank.pose if torch.equal(store.bank.pose[i], row)}
        assert len(picked) == 3
        assert picked <= set(store.members[c].tolist())


def test_retrieve_is_uniform_over_members():
    store = tret.synthetic_store(6, torch.device("cpu"), img_res=8,
                                 feat_dim=64)
    gen = torch.Generator().manual_seed(1)
    counts = np.zeros(4)
    members = store.members[0].tolist()
    for _ in range(800):
        bank = tret.retrieve(store, store.centers[0], gen, sample_num=1)
        i = [m for m in members if torch.equal(store.bank.pose[m],
                                               bank.pose[0])][0]
        counts[members.index(i)] += 1
    assert counts.min() > 150, counts        # 200 expected per member


def test_scalar_writer_matches_jax_writer(tmp_path):
    rows = [(0, {"a": 1.5, "b": np.float32(2.0), "skip": "text"}),
            (7, {"metrics/mpjpe": 42.0})]
    for cls, d in ((JWriter, tmp_path / "j"), (TWriter, tmp_path / "t")):
        w = cls(str(d))
        for step, sc in rows:
            w.write(step, sc)
        w.close()
    load = [[{k: v for k, v in json.loads(line).items() if k != "t"}
             for line in open(tmp_path / d / "scalars.jsonl")]
            for d in ("j", "t")]
    assert load[0] == load[1]


def test_port_never_imports_jax():
    """Import every module of the port in a fresh interpreter (the test
    process has jax loaded already) and check that jax and every module of
    the JAX package stayed out."""
    pkg = os.path.join(REPO, "dynaboa_tpu_torch")
    mods = []
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    code = ("import importlib, sys\n"
            f"for m in {sorted(mods)!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m in ('jax', 'dynaboa_tpu') or "
            "m.startswith(('jax.', 'jaxlib', 'flax', 'optax', "
            "'dynaboa_tpu.'))]\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(mods) >= 20


def test_chip_smoke_names_no_jax_module():
    """chip_smoke.py drives the port alone: it names no module of the JAX
    package and no jax."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    assert "dynaboa_tpu_torch" in src
    assert not re.findall(r"\bdynaboa_tpu\.|import dynaboa_tpu\b|"
                          r"from dynaboa_tpu\s+import", src)
    assert not re.findall(r"^\s*(?:import|from)\s+(?:jax|flax|optax)\b", src,
                          re.M)
