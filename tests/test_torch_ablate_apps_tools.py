"""The port's worst-case ablation, stream-app timer and rasterizer timer
(``dynaboa_tpu_torch/tools/{ablate_worstcase,bench_stream_app,
bench_raster}.py``) on the CPU at the tiny size, against the root tools of
the same names: the ablation's variants, the clip's keypoints, the capsule
mesh and its renders; and every one of the four attribution and app tools
run in a fresh interpreter without loading jax or the JAX package."""

import dataclasses
import importlib.util
import math
import os
import re
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from dynaboa_tpu.viz.renderer import Renderer as JRenderer
from dynaboa_tpu_torch.config import AdaptConfig
from dynaboa_tpu_torch.tools import ablate_worstcase as abl
from dynaboa_tpu_torch.tools import bench_raster as braster
from dynaboa_tpu_torch.tools import bench_stream_app as bstream
from dynaboa_tpu_torch.viz.renderer import Renderer
from tests import torch_port_fixtures as F  # noqa: F401  (thread share)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# label -> (fields changed from the bf16 base, compute_metrics), as the JAX
# tool's variants (tools/ablate_worstcase.py:81-90)
CHANGES = {
    "base": ({}, True),
    "base_norec": ({"record_dynamic": False}, True),
    "no_teacher": ({"use_meanteacher": False}, True),
    "no_metrics": ({}, False),
    "no_mixtrain": ({"retrieval": False, "lower_level_mixtrain": False,
                     "upper_level_mixtrain": False}, True),
    "no_motion": ({"use_motion": False}, True),
    "fp32": ({"compute_dtype": "float32"}, True),
    "no_inner": ({"use_boa": False}, True),
}


def _root_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_root_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _changed(cfg, base) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(base)
            if getattr(cfg, f.name) != getattr(base, f.name)}


def test_variants_are_the_jax_tools():
    src = open(os.path.join(REPO, "tools", "ablate_worstcase.py")).read()
    jax_labels = re.findall(r'^\s+"(\w+)": dict\(', src, re.M)
    base = AdaptConfig(record_lowerlevel=False, compute_dtype="bfloat16")
    table = abl.variants(base)
    assert list(table) == jax_labels == list(CHANGES)
    for label, (cfg, metrics) in table.items():
        assert (_changed(cfg, base), metrics) == CHANGES[label], label


def test_ablation_runs_every_variant_in_order():
    res = abl.main(["--device", "cpu", "--tiny", "1", "--frames", "1",
                    "--repeats", "1"])
    rows = res["variants"]
    assert [r["label"] for r in rows] == list(CHANGES)
    for r in rows:
        for k in ("ms_per_frame", "fps"):
            assert math.isfinite(r[k]) and r[k] > 0, (r["label"], k)
        assert len(r["ms_per_frame_runs"]) == len(r["first_step_s_runs"]) == 1
        # threshold -1: every update taken, none in the single-level step
        assert r["extra_steps"] == (0 if r["label"] == "no_inner" else 7)
    assert res["updates_per_frame"] == 8
    per_update = res["ms_per_update_by_component"]
    assert list(per_update) == list(CHANGES)[1:]
    base_ms = rows[0]["ms_per_frame"]
    for r in rows[1:]:
        assert per_update[r["label"]] == pytest.approx(
            (base_ms - r["ms_per_frame"]) / 8)
    with pytest.raises(SystemExit):
        abl.main(["--device", "cpu", "--tiny", "1", "--variants", "nope"])


def test_make_clip_equals_the_root_tools(tmp_path):
    root = _root_tool("bench_stream_app")
    want = root.make_clip(str(tmp_path / "j.mp4"), 5, seed=3)
    got = bstream.make_clip(str(tmp_path / "t.mp4"), 5, seed=3)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    frames = []
    for name in ("j.mp4", "t.mp4"):
        cap = cv2.VideoCapture(str(tmp_path / name))
        frames.append([cap.read()[1] for _ in range(5)])
        cap.release()
    assert all(np.array_equal(a, b) for a, b in zip(*frames))
    with pytest.raises(RuntimeError, match="mp4v"):
        bstream.make_clip(str(tmp_path / "missing" / "x.mp4"), 2)


def test_capsule_mesh_and_renders_equal_the_root_tools():
    root = _root_tool("bench_raster")
    verts, faces = braster.capsule_mesh()
    jverts, jfaces = root.capsule_mesh()
    assert verts.dtype == jverts.dtype and np.array_equal(verts, jverts)
    assert faces.dtype == jfaces.dtype and np.array_equal(faces, jfaces)
    w, h = 320, 240
    img = np.full((h, w, 3), 128, np.uint8)
    jrend = JRenderer(resolution=(w, h), faces=faces)
    assert jrend.use_native
    rend = Renderer(resolution=(w, h), faces=faces, backend="native")
    for _, scale in braster.CAMERAS:
        cam = braster.camera(scale)
        out = rend.render(img, verts, cam)
        assert np.array_equal(out, jrend.render(img, verts, cam))
        assert (out != img).any()


def test_bench_raster_main():
    res = braster.main(["--frames", "2", "--w", "160", "--h", "120"])
    assert res["backend"] == "native"
    assert (res["vertices"], res["triangles"]) == (6960, 13760)
    for label, _ in braster.CAMERAS:
        arm = res["arms"][label]
        assert arm["ms_per_frame"] > 0 and 0 < arm["coverage"] < 1


def test_bench_stream_app_on_a_tiny_clip():
    res = bstream.main(["--device", "cpu", "--tiny", "1", "--frames", "3"])
    assert math.isfinite(res["fps"]) and res["fps"] > 0
    assert res["frames"] == 5 and res["wall_s"] > 0
    assert res["skin_kernel_launches"] == 0      # no kernel on the CPU


def test_tools_never_import_jax():
    """Each tool's ``main`` at the tiny size on the CPU, in a fresh
    interpreter: neither jax nor any module of the JAX package loads."""
    code = (
        "import sys, torch\n"
        f"torch.set_num_threads({torch.get_num_threads()})\n"
        "from dynaboa_tpu_torch.tools import (ablate_worstcase, "
        "bench_raster, bench_stream_app, profile_update_floor)\n"
        "profile_update_floor.main(['--device', 'cpu', '--tiny', '1', "
        "'--iters', '1', '--dtype', 'float32'])\n"
        "ablate_worstcase.main(['--device', 'cpu', '--tiny', '1', "
        "'--frames', '1', '--repeats', '1', '--variants', 'base,no_inner'])\n"
        "bench_stream_app.main(['--device', 'cpu', '--tiny', '1', "
        "'--frames', '1', '--warmup', '0'])\n"
        "bench_raster.main(['--frames', '1'])\n"
        "bad = [m for m in sys.modules if m in ('jax', 'dynaboa_tpu') or "
        "m.startswith(('jax.', 'jaxlib', 'flax', 'optax', "
        "'dynaboa_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NO_JAX_OK" in proc.stdout
