"""The harness end to end on the CPU at a tiny size: each cell runs, its
check holds a sound run correct and comes out false under each fault the
cell can have, a cell added as files is found by name, nothing imports
JAX, and the command refuses to run without the cell's cards.

The runs skip the harness's look for a chip by calling ``run_cell``
directly; the limits are the cells' own (``perfbench/limits``)."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench.harness import cli

import tiny

CELLS = ("pw3d.geo_updates", "webcam.video_vga")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.make_tree(str(tmp_path_factory.mktemp("tree")))


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(tree, workload):
    root, bench = tree
    res, r, nums, _ = tiny.run(root, bench, workload)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] == r["frames"] > 2
    assert nums["compared_frames"] >= 3
    # no device on the CPU: no metric taken from the device's trace is read
    assert set(res["metrics"]) == {m["name"] for m in cli.cell_metrics(
        bench, workload, "end_to_end") if m["source"] != "device_trace"}
    assert list(res)[-1] == "checks"
    if workload.startswith("webcam"):
        # the overlay really covers pixels of the frame
        assert r["records"] == r["frames"]


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reads_per_layer_metrics(tree, workload):
    root, bench = tree
    res, r, _, _ = tiny.run(root, bench, workload, traced=True)
    assert res["correct"]
    names = set(res["metrics"])
    if workload.startswith("pw3d"):
        assert {"engine.adapted_fps", "model.launches.engine",
                "step.host_syncs.engine"} <= names
    else:
        assert {"model.launches", "step.host_syncs", "step.mfu"} <= names
    # no device on the CPU: no device time, device share or kernel roofline
    assert not {"lbs_skin_roofline", "lbs_skin_roofline.engine",
                "step.mfu.engine"} & names
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def _fault_unchanged_state(monkeypatch):
    from dynaboa_tpu_torch.engine.bilevel import BilevelEngine

    monkeypatch.setattr(BilevelEngine, "_outer_update",
                        staticmethod(lambda grads, state: None))


def _fault_altered_answer(monkeypatch):
    from dynaboa_tpu_torch.engine.bilevel import BilevelEngine

    step = BilevelEngine.step

    def altered(self, *a, **kw):
        state, out = step(self, *a, **kw)
        out["verts"] = out["verts"].clone()
        out["verts"][:, 0] += 0.01          # one vertex off by 1 cm
        return state, out

    monkeypatch.setattr(BilevelEngine, "step", altered)


def _fault_altered_overlay(monkeypatch):
    from dynaboa_tpu_torch.viz.renderer import Renderer

    render = Renderer.render

    def altered(self, *a, **kw):
        img = render(self, *a, **kw)
        img[:16, :16] = 255 - img[:16, :16]     # 256 pixels off
        return img

    monkeypatch.setattr(Renderer, "render", altered)


def _fault_lr(monkeypatch):
    return {"lr": 3e-6 * 1.1}            # the learning rate 10 % high


def _fault_alpha(monkeypatch):
    return {"alpha": 0.9}                # the EMA's alpha swapped


FAULTS = [("pw3d.geo_updates", _fault_unchanged_state),
          ("pw3d.geo_updates", _fault_altered_answer),
          ("pw3d.geo_updates", _fault_lr),
          ("pw3d.geo_updates", _fault_alpha),
          ("webcam.video_vga", _fault_unchanged_state),
          ("webcam.video_vga", _fault_altered_answer),
          ("webcam.video_vga", _fault_altered_overlay),
          ("webcam.video_vga", _fault_lr),
          ("webcam.video_vga", _fault_alpha)]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__[7:]}" for w, f in FAULTS])
def test_fault_is_not_correct(tree, monkeypatch, workload, fault):
    """A step that leaves its state unchanged, an answer altered where it
    is produced, an overlay altered where it is rendered, a learning rate
    10 % high, the teacher's alpha swapped: ``correct`` is false.  (Each
    step takes one frame, so there is no batch to halve, and one chip, so
    there is no exchange to drop.)"""
    root, bench = tree
    overrides = fault(monkeypatch)
    res, _, _, _ = tiny.run(root, bench, workload, overrides=overrides)
    assert not res["correct"], res["checks"]


DUMMY_SOURCE = """
import torch

CALLS = []


def make(seed, spec, cfg, device):
    CALLS.append(seed)
    n, res = spec["pool"], cfg["model"]["img_res"]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    img = 0.5 * torch.randn((n, 1, res, res, 3), generator=g, device=device)
    kp = torch.cat([torch.rand((n, 1, 49, 2), generator=g, device=device)
                    - 0.5, torch.ones((n, 1, 49, 1), device=device)], -1)
    return [{"image": img[i], "j2d": kp[i],
             "pose": torch.zeros((1, 72), device=device),
             "betas": torch.zeros((1, 10), device=device),
             "gender": torch.zeros((1,), dtype=torch.int32, device=device)}
            for i in range(n)]
"""

DUMMY_ENTRY = """
import os

from perfbench.harness import found

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_base = found.module("entries", "engine_step", ROOT)
program_side = _base.program_side
reference_side = _base.reference_side


def drive(run):
    r = _base.drive(run)
    r["dummy_entry"] = True
    return r
"""


def _add(root, sub, name, text):
    with open(os.path.join(root, "perfbench", sub, name), "w") as f:
        f.write(text)


def test_cell_added_as_files_is_found_by_name(tree, tmp_path):
    """A configuration, a traffic mix, an entry, a frame source, a metric
    reader and the cell's limits, each a new file, make a new cell with no
    edit to a file that is there."""
    import shutil

    from perfbench.harness import found

    root, bench = tree
    new = str(tmp_path / "tree")
    shutil.copytree(root, new)
    pb = os.path.join(new, "perfbench")
    with open(os.path.join(pb, "configs", "dynaboa_3dpw.json")) as f:
        cfg = json.load(f)
    cfg["adapt"]["optim_steps"] = 3
    _add(new, "configs", "dummy_cfg.json", json.dumps(cfg))
    with open(os.path.join(pb, "traffic", "geo_updates.json")) as f:
        mix = json.load(f)
    mix["entry"] = "dummy_entry"
    mix["frames"] = {"source": "dummy_frames", "pool": 5}
    mix["updates"]["caps"] = {"dist": "geometric_blocks", "p": 0.5, "max": 3,
                              "block": 8}
    mix["warmup_frames"] = 3
    mix["trace"]["caps"] = [0, 3, 1, 2]
    _add(new, "traffic", "dummy_mix.json", json.dumps(mix))
    _add(new, "entries", "dummy_entry.py", DUMMY_ENTRY)
    _add(new, "sources", "dummy_frames.py", DUMMY_SOURCE)
    _add(new, "metrics", "dummy.frames.py",
         "def read(r, cfg):\n    return float(r['frames'])\n")
    shutil.copy(os.path.join(pb, "limits", "pw3d.geo_updates.json"),
                os.path.join(pb, "limits", "dummy.cell.json"))
    bench = json.loads(json.dumps(bench))
    bench["configs"].append({"name": "dummy_cfg", "source": "x",
                             "file": "perfbench/configs/dummy_cfg.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy_cfg",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "x"})
    bench["end_to_end"].append({"name": "dummy.frames", "unit": "frames",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["dummy.cell"]})
    res, r, _, _ = tiny.run(new, bench, "dummy.cell", seed=77)
    assert res["correct"], res["checks"]
    assert r["dummy_entry"]
    assert found.module("sources", "dummy_frames", new).CALLS == [77]
    assert res["metrics"]["dummy.frames"]["value"] == r["frames"]
    assert max(r["updates"]) <= 4


def test_mix_added_as_data_alone(tree, tmp_path):
    """A mix that is one new data file: the stream app with a quarter of
    the frames showing nobody, which the app passes through.  The check
    follows the adapted frames, and the rate counts only them."""
    import shutil

    root, bench = tree
    new = str(tmp_path / "tree")
    shutil.copytree(root, new)
    pb = os.path.join(new, "perfbench")
    with open(os.path.join(pb, "traffic", "video_vga.json")) as f:
        mix = json.load(f)
    mix["frames"]["no_person"] = 0.25
    _add(new, "traffic", "gaps_mix.json", json.dumps(mix))
    shutil.copy(os.path.join(pb, "limits", "webcam.video_vga.json"),
                os.path.join(pb, "limits", "webcam.gaps.json"))
    bench = json.loads(json.dumps(bench))
    bench["workloads"].append({"name": "webcam.gaps",
                               "config": "dynaboa_webcam",
                               "traffic": "gaps_mix", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "adapted_fps":
            m["workloads"].append("webcam.gaps")
    res, r, nums, _ = tiny.run(new, bench, "webcam.gaps")
    assert res["correct"], res["checks"]
    assert r["summary"]["passthrough"] > 0
    assert r["adapted"] == r["summary"]["adapted"] < r["frames"]
    assert r["records"] == r["frames"]
    assert res["metrics"]["adapted_fps"]["value"] == pytest.approx(
        r["adapted"] / r["window_s"])
    assert nums["compared_frames"] >= 3


FORBIDDEN = ("jax", "jaxlib", "flax", "dynaboa_tpu")


def test_no_module_imports_jax():
    """No file under perfbench/ imports jax, jaxlib, flax or the JAX
    package, by each import's top-level name compared whole."""
    bad = []
    for dirpath, _, files in os.walk(cli.PB):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                tree_ = ast.parse(f.read())
            for node in ast.walk(tree_):
                mods = []
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    mods = [node.module]
                bad += [(path, m) for m in mods
                        if m.split(".")[0] in FORBIDDEN]
    assert not bad


def test_run_loads_no_jax(tmp_path):
    """A whole tiny run in a fresh interpreter leaves no jax, jaxlib, flax
    or dynaboa_tpu module in sys.modules."""
    code = f"""
import sys, torch
sys.path[:0] = [{cli.ROOT!r}, {os.path.dirname(__file__)!r}]
import tiny
root, bench = tiny.make_tree({str(tmp_path)!r})
tiny.run(root, bench, "webcam.video_vga", seconds=1.0)
from perfbench.harness.cli import imported_forbidden
print("FORBIDDEN", imported_forbidden())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path))
    assert "FORBIDDEN []" in out.stdout, out.stderr[-2000:]


def test_command_refuses_without_cards():
    """Without a CUDA card the command exits 2 and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "pw3d.geo_updates", "--seed", "5", "--seconds",
                          "1", "--trace", "0"], capture_output=True,
                         text=True, timeout=300, cwd=cli.ROOT)
    assert out.returncode == 2
    assert out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(tree, workload):
    """On the card: the reference with TF32 on, put in the program's
    place, fails one of the cell's limits (at the tiny size; the chip runs
    of ``calibrate.py`` read it at the cells' own sizes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root, bench = tree
    _, _, nums, ctrl = tiny.run(root, bench, workload, control=True,
                                device="cuda")
    with open(os.path.join(root, "perfbench", "limits",
                           f"{workload}.json")) as f:
        limits = json.load(f)
    ok, _ = __import__("perfbench.harness.check",
                       fromlist=["verdict"]).verdict(ctrl, limits)
    assert not ok, ctrl
    assert np.isfinite(list(nums.values())).all()
