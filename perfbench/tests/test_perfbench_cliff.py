"""The benchmark's CLIFF files on their own: the harness's counts from the
configuration (parameters, convolutions, FLOPs, GroupNorm elements), the
seeded draws (weights, frames' and exemplars' boxes) as functions of the
seed alone, the new readers on a trace without the port's kernels (as a
program without them gives), and the files importing nothing of the port
until a run builds the system (so that over a commit without CLIFF the
cell fails at once and cleanly)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from perfbench.harness import cli, found
from perfbench.harness import cliff as H

import tiny

ROOT = tiny.ROOT


def _cfg():
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "cliff_hr48_3dpw.json")) as f:
        return json.load(f)


def _mix():
    with open(os.path.join(ROOT, "perfbench", "traffic",
                           "cliff_geo_updates.json")) as f:
        return json.load(f)


def test_counts_at_the_published_widths():
    m = _cfg()["model"]
    sh = H.shapes(m)
    assert sum(torch.Size(s).numel() for _, s, _ in sh) == 78_893_405
    convs = [x for x in H.walk(m) if x[0] == "conv"]
    norms = [x for x in H.walk(m) if x[0] == "norm"]
    assert len(convs) == len(norms) == 325
    assert len({(c[2], c[3], c[4], c[5], c[7]) for c in convs}) == 47
    assert sum(c[6] for c in convs) == 4            # the head's biases
    assert H.conv_flops(m) == 33_846_755_328
    assert H.forward_flops(m) == 33_867_577_344
    assert H.norm_elements(m) == 27_972_864
    # the largest GroupNorm group: 64 channels of 16 at 128x96
    assert max(c[3] // 4 * c[7][0] * c[7][1] for c in convs) == 196_608


def test_draws_follow_the_seed_alone():
    m, spec = _cfg()["model"], _mix()["frames"]
    a, b = H.weights(m, 3, "cpu"), H.weights(m, 3, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(H.weights(m, 4, "cpu")["fc1.weight"],
                           a["fc1.weight"])
    std = a["encoder.conv1.weight"].std().item()
    assert std == pytest.approx((2.0 / (9 * 64)) ** 0.5, rel=0.05)
    for k in ("decpose.bias", "fc1.bias", "encoder.final_layer.0.bias"):
        assert a[k].abs().max().item() > 0           # PyTorch's default
    src = found.module("sources", "boxed_crops", ROOT)
    cfg = _cfg()
    cfg["model"]["img_res"] = 32
    f1 = src.make(11, dict(spec, pool=8), cfg, "cpu")
    f2 = src.make(11, dict(spec, pool=8), cfg, "cpu")
    crops = found.module("sources", "crops", ROOT).make(
        11, dict(spec, pool=8), cfg, "cpu")
    for x, y, c in zip(f1, f2, crops):
        assert torch.equal(x["box"], y["box"])
        assert torch.equal(x["image"], c["image"])   # the crops' own pool
    store = H.store_boxes(cfg["store"], 11, "cpu")
    assert store.shape == (400, 5)
    assert float(store[:, 2].min()) >= 400 and float(store[:, 2].max()) <= 800
    assert torch.equal(store[:, 3:], torch.tensor([[1000.0, 1000.0]] * 400))


def test_readers_read_none_without_the_kernels():
    """A trace of a program without the Hopper kernels, and none at all."""
    cfg = _cfg()
    t = {"busy_s": 1.0, "window_s": 2.0, "frames": 2, "updates": [1, 4],
         "kernels": {"sm80_xmma_fprop": [0.5]}, "step_calls": 2,
         "idle_by_host_op": {"(no op)": 1.0}}
    for name in ("conv_fprop_roofline.cliff", "group_norm_roofline.cliff"):
        assert cli.reader(name, ROOT)({"trace": t}, cfg) is None
    for name in ("step.mfu.cliff", "device.idle_share.cliff",
                 "cliff.model_idle_ms", "conv_fprop_roofline.cliff",
                 "group_norm_roofline.cliff"):
        assert cli.reader(name, ROOT)({}, cfg) is None
    # a trace without the program's step spans (a version before them)
    assert cli.reader("cliff.model_idle_ms", ROOT)({"trace": t}, cfg) is None


def test_files_import_no_port_module_until_a_run():
    """Loading the entry, the source, the readers and the reference imports
    nothing of ``dynaboa_tpu_torch``: a commit without the CLIFF model
    fails only when the run builds its system."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from perfbench.harness import found\n"
        "for kind, name in [('entries', 'cliff_step'), "
        "('sources', 'boxed_crops'), ('metrics', 'step.mfu.cliff'), "
        "('metrics', 'device.idle_share.cliff'), "
        "('metrics', 'cliff.model_idle_ms'), "
        "('metrics', 'conv_fprop_roofline.cliff'), "
        "('metrics', 'group_norm_roofline.cliff')]:\n"
        "    found.module(kind, name, %r)\n"
        "import perfbench.reference.step_cliff\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('dynaboa_tpu_torch', 'dynaboa_tpu', 'jax')]\n"
        "print(bad)\n" % (ROOT, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
