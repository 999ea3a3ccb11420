"""HMR 2.0 in the port (``models/hmr2.py``) against the plain reference
(``perfbench/reference/hmr2.py``, ``step_hmr2.py``) on seeded weights at a
tiny size on the CPU: the forward, its taps and its gradients; frames of
``BilevelEngine.step`` against the reference's step; the benchmark's two
new cells end to end at that size; HMR still declaring its taps and crop,
with its graph keys as they were; and the new readers on a synthetic
trace.

Tolerances.  The port's model and the reference run the same float32
operations on the CPU and agree bit for bit today; 1e-6 (relative to the
largest magnitude) leaves room for a reordered reduction, while a changed
equation (a head's scale, the rotation's reading, the crop's columns)
moves them by 1e-3 or more.  The engine and the reference step differ in
their SMPL, loss and Adam code, so their float32 rounding differs: over
four frames the weights' change read up to 2.5e-5 by a leaf's norm (Adam
scales elements whose gradient is near round-off to full steps, so an
element's own change can differ by more), the outputs and losses less;
the test holds 1e-4 on each, and a learning rate 10 % high moves the
weights' change by 10 %."""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.func import functional_call

import torch_port_fixtures  # noqa: F401  (shares the cores among workers)
from dynaboa_tpu_torch.engine.bilevel import BilevelEngine, Frame
from dynaboa_tpu_torch.models.hmr import HMR
from dynaboa_tpu_torch.models.hmr2 import HMR2
from dynaboa_tpu_torch.ops.camera import project_to_crop
from perfbench.harness import cli, found, trace, work
from perfbench.harness import hmr2 as H
from perfbench.reference import hmr2 as RH
from perfbench.reference import step as RS
from perfbench.reference import step_hmr2 as RS2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "perfbench", "tests"))
import tiny  # noqa: E402

TINY = dict(img_res=64, patch_size=16, patch_padding=2, embed_dim=64,
            depth=2, num_heads=4, mlp_ratio=4, ln_eps=1e-6, dec_dim=32,
            dec_depth=2, dec_heads=2, dec_dim_head=16, dec_mlp_dim=32,
            ief_iters=1)
with open(os.path.join(ROOT, "perfbench", "configs",
                       "hmr2_vith_3dpw.json")) as _f:
    FULL = json.load(_f)["model"]
INIT_KEYS = ("init_body_pose", "init_betas", "init_cam")
CAPS = (0, 3, 1, 2)


def _model(m=TINY, seed=7):
    w = H.weights(m, seed, "cpu")
    init = H.mean_params("cpu")
    model = HMR2(**m).eval()
    model.load_state_dict(dict(w, **{f"smpl_head.{k}": v
                                     for k, v in zip(INIT_KEYS, init)}))
    return model, w, init


def _gap(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp(min=1e-30))


def _image(n, res=64, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, res, res, 3, generator=g)


# -- the model against the reference -------------------------------------------

def test_parameters_follow_the_published_layout():
    """The port's parameters are the benchmark's seeded weights, name for
    name and shape for shape, at the tiny and the published sizes; the
    published model holds 670,459,037 of them."""
    for m in (TINY, FULL):
        with torch.device("meta"):
            port = HMR2(**m)
        have = [(k, tuple(v.shape)) for k, v in port.named_parameters()]
        assert have == [(k, s) for k, s, _ in H.shapes(m)]
    assert sum(p.numel() for p in port.parameters()) == 670_459_037
    assert [k for k, _ in port.named_buffers()] == [
        f"smpl_head.{k}" for k in INIT_KEYS]
    assert (port.img_res, port.retrieval_tap, port.gate_tap) == (256, 1, 2)
    assert H.grid(FULL) == (16, 12)


def test_forward_and_taps_match_reference():
    model, w, init = _model()
    x = _image(3)
    with torch.no_grad():
        a = functional_call(model, w, (x.permute(0, 3, 1, 2),))
        b = RH.forward(w, x, TINY, *init)
    for u, v in zip(a[:3], b[:3]):
        assert _gap(u, v) <= 1e-6
    assert len(a[3]) == len(b[3]) == 3
    for u, v in zip(a[3], b[3]):
        assert u.shape == v.shape and _gap(u, v) <= 1e-6
    assert a[3][1].shape == (3, TINY["embed_dim"])
    assert a[3][2].shape == (3, TINY["dec_dim"])
    # rotations are rotations
    eye = torch.eye(3).expand(3, 24, 3, 3)
    assert _gap(a[0] @ a[0].transpose(-1, -2), eye) <= 1e-5


def test_gradients_match_reference():
    model, w, init = _model()
    x = _image(3, seed=2)

    def loss(out):
        rotmat, shape, cam, taps = out
        return sum((t ** 2).mean() for t in (rotmat, shape, cam, *taps))

    pa = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    pb = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    ga = torch.autograd.grad(loss(functional_call(
        model, pa, (x.permute(0, 3, 1, 2),))), list(pa.values()))
    gb = torch.autograd.grad(loss(RH.forward(pb, x, TINY, *init)),
                             list(pb.values()))
    for k, u, v in zip(w, ga, gb):
        assert float((u - v).norm()) <= 1e-6 * max(float(v.norm()), 1e-30), k
    assert all(float(v.norm()) > 0 for k, v in zip(w, gb)
               if k != "smpl_head.transformer.to_token_embedding.weight")


def test_identity_mean_is_the_identity_pose():
    """HMR 2.0's 6D reading of its mean pose gives the identity at every
    joint (HMR's reading of the same numbers would not)."""
    pose = H.mean_params("cpu")[0]
    from dynaboa_tpu_torch.models.hmr2 import rot6d_to_rotmat

    R = rot6d_to_rotmat(pose)
    assert torch.equal(R, torch.eye(3).expand(24, 3, 3))
    assert torch.equal(RH.rot6d_to_rotmat(pose), R)


def test_flops_hand_count_and_flop_counter():
    """The published forward: 251,094,704,128 FLOPs a row (30 times
    HMR's); at the tiny size the count equals torch's
    FlopCounterMode over the reference forward."""
    from torch.utils.flop_counter import FlopCounterMode

    assert H.forward_flops(FULL) == 251_094_704_128
    w = H.weights(TINY, 1, "cpu")
    with FlopCounterMode(display=False) as fc:
        RH.forward(w, torch.zeros(1, 64, 64, 3), TINY, *H.mean_params("cpu"))
    assert fc.get_total_flops() == H.forward_flops(TINY)


# -- the engine's step against the reference's ---------------------------------

def _tiny_cfg():
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "hmr2_vith_3dpw.json")) as f:
        cfg = tiny.shrink(json.load(f))
    cfg["model"] = dict(TINY)
    cfg["adapt"]["use_pallas_lbs"] = False
    return cfg


@pytest.fixture(scope="module")
def system():
    entry = found.module("entries", "hmr2_step", ROOT)
    cfg = _tiny_cfg()
    inp = entry.make_inputs(cfg, 11, torch.device("cpu"))
    return cfg, inp, entry.build_system(cfg, inp, torch.device("cpu"))


def _frames(n, seed=3):
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        xy = torch.rand((1, 49, 2), generator=g) * 2 - 1
        out.append(dict(image=torch.randn((1, 64, 64, 3), generator=g),
                        j2d=torch.cat([xy, torch.ones((1, 49, 1))], -1),
                        pose=0.2 * torch.randn((1, 72), generator=g),
                        betas=0.3 * torch.randn((1, 10), generator=g),
                        gender=torch.tensor([1], dtype=torch.int32)))
    return out


def test_engine_steps_match_reference(system):
    """Four frames of ``BilevelEngine.step`` with the tiny HMR 2.0 at caps
    0, 3, 1, 2 (threshold -1), against the reference's step from the same
    seeded state: predictions, losses, metrics and update counts each
    frame; weights, teacher and Adam's moments after."""
    from perfbench.reference.losses import gmm_prior

    cfg, inp, sy = system
    engine = sy.engine.engine
    assert isinstance(engine, BilevelEngine)
    assert (engine.img_res, engine.retrieval_tap, engine.gate_tap) == \
        (64, 1, 2)
    state = engine.init_state(sy.params)
    assert state.hist_images.shape[2:4] == (64, 64)
    g = inp.gmm
    ctx = RS2.Context(adapt=dict(cfg["adapt"]), model=cfg["model"],
                      init=inp.init, bodies=inp.bodies, Jh36m=inp.Jh36m,
                      prior=gmm_prior(g["means"], g["covars"], g["weights"],
                                      "cpu"),
                      store=inp.store, compute_metrics=True)
    st = RS.fresh_state(ctx, inp.weights, 64, "cpu")
    for fr, cap in zip(_frames(4), CAPS):
        state, out = engine.step(state, Frame(**fr), cos_sim_threshold=-1.0,
                                 extra_cap=cap)
        ref = RS2.step(ctx, st, fr, -1.0, cap)
        assert out["optim_steps"] + 1 == ref["n_updates"] == cap + 1
        for k, rk in (("verts", "verts"), ("cam", "cam"), ("rotmat", "rotmat"),
                      ("beta", "beta"), ("mpjpe", "mpjpe"), ("pve", "pve")):
            assert _gap(out[k], ref[rk]) <= 1e-4, k
        assert _gap(out["upper"]["loss"], ref["upper_loss"]) <= 1e-4
        assert _gap(out["lower"]["loss"], ref["lower_loss"]) <= 1e-4
        assert _gap(out["per_step_loss"][:cap + 1],
                    ref["per_step_loss"]) <= 1e-4
    opt = state.optimizer
    gaps = []
    for k, p in state.params.items():
        d, r = p.detach() - inp.weights[k], st.params[k] - inp.weights[k]
        gaps.append(float((d - r).norm() / r.norm().clamp(min=1e-30)))
        assert _gap(state.teacher_params[k], st.teacher[k]) <= 1e-4, k
    assert max(gaps) <= 1e-4
    m = torch.cat([opt.state[p]["exp_avg"].reshape(-1)
                   for p in state.params.values()])
    rm = torch.cat([st.m[k].reshape(-1) for k in state.params])
    assert float((m - rm).norm() / rm.norm()) <= 1e-4


# -- HMR as it was ---------------------------------------------------------------

def test_hmr_declares_its_taps_and_crop():
    """HMR names tap 5 for retrieval, tap 12 for the gate and the 224 crop;
    the engine reads them from the model, its graph key is the tuple it was,
    and the projection's default is HMR's."""
    from dynaboa_tpu_torch.config import AdaptConfig
    from dynaboa_tpu_torch.losses.priors import synthetic_gmm_prior
    from dynaboa_tpu_torch.metrics.eval import GenderedSMPL
    from dynaboa_tpu_torch.models.smpl import synthetic_smpl_model

    assert (HMR.img_res, HMR.retrieval_tap, HMR.gate_tap) == (224, 5, 12)
    net = HMR(layers=(1, 1, 1, 1), width=8, regressor_dim=16)
    taps = net(torch.zeros(1, 3, 32, 32))[3]
    assert taps[5].shape == (1, 8 * 8 * 4) and taps[12].shape == (1, 16)
    smpl = synthetic_smpl_model(0, "cpu", num_vertices=64)
    eng = BilevelEngine(AdaptConfig(retrieval=False, lower_level_mixtrain=False,
                                    upper_level_mixtrain=False),
                        net, synthetic_gmm_prior(4, "cpu"),
                        GenderedSMPL(smpl, smpl, smpl,
                                     torch.ones(17, 64) / 64))
    assert (eng.img_res, eng.retrieval_tap, eng.gate_tap) == (224, 5, 12)
    state = eng.init_state(dict(net.named_parameters()))
    assert state.hist_images.shape[2:4] == (224, 224)
    frame = Frame(image=torch.zeros(1, 32, 32, 3), j2d=torch.zeros(1, 49, 3),
                  pose=None, betas=None, gender=None)
    hist = eng._history(state)
    assert eng._grad_key("upper", True, frame, hist, None) == (
        "upper", True,
        (((1, 32, 32, 3), torch.float32), ((1, 49, 3), torch.float32),
         None, None, None, None),
        (((1, 224, 224, 3), torch.float32), ((1, 49, 3), torch.float32),
         ((), torch.float32)), None)
    cam = torch.tensor([[0.9, 0.1, -0.2]])
    s3d = torch.randn(1, 49, 3, generator=torch.Generator().manual_seed(0))
    assert torch.equal(project_to_crop(cam, s3d)["normed"],
                       project_to_crop(cam, s3d, img_res=224)["normed"])
    assert _gap(project_to_crop(cam, s3d, img_res=256)["normed"],
                RS2.project_to_crop(cam, s3d, 256)) <= 1e-6


# -- the cells end to end at the tiny size --------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root, bench = tiny.make_tree(str(tmp_path_factory.mktemp("tree")))
    path = os.path.join(root, "perfbench", "configs", "hmr2_vith_3dpw.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["model"] = dict(TINY)
    with open(path, "w") as f:
        json.dump(cfg, f)
    path = os.path.join(root, "perfbench", "traffic", "runner_gate.json")
    with open(path) as f:
        mix = json.load(f)
    mix["frames"].update(pool=8, width=96, height=160)
    with open(path, "w") as f:
        json.dump(mix, f)
    return root, bench


CELLS = ("hmr2.geo_updates", "pw3d.runner_gate")


@pytest.mark.parametrize("workload", CELLS)
def test_new_cell_is_correct_and_reads_its_metrics(tree, workload):
    root, bench = tree
    res, r, nums, _ = tiny.run(root, bench, workload, seconds=1.0,
                               traced=True)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and r["frames"] > 0
    assert nums["compared_frames"] >= 3
    assert r["trace"]["step_calls"] == 8
    if workload == "pw3d.runner_gate":
        assert res["metrics"]["runner.host_ms"]["value"] > 0
        assert r["updates"] and set(r["trace"]["updates"]) == {1}
    else:
        assert r["trace"]["updates"] == [1, 8, 1, 7, 2, 4, 2, 4]
        # the CPU runs every evaluation eagerly
        gs = r["graph_stats"]["trace"]
        assert gs["captures"] == gs["replays"] == 0 and gs["eager"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_new_cell_with_a_fault_is_not_correct(tree, workload):
    """A learning rate 10 % high in the program and not in the reference."""
    root, bench = tree
    res, _, _, _ = tiny.run(root, bench, workload, seconds=1.0,
                            overrides={"lr": 3e-6 * 1.1})
    assert not res["correct"], res["checks"]


def test_benchmark_entries_of_this_configuration():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    # the queued cell first, then this configuration's own, next to each
    # other (later configurations' cells follow them)
    names = [w["name"] for w in bench["workloads"]]
    assert names.index("hmr2.geo_updates") == \
        names.index("pw3d.runner_gate") + 1
    assert cells["hmr2.geo_updates"]["config"] == "hmr2_vith_3dpw"
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert set(CELLS) <= set(e2e["device_ms_per_frame"]["workloads"])
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in ("step.mfu.hmr2", "device.idle_share.hmr2",
                 "step.grad_idle_ms.hmr2", "hmr2.model_idle_ms"):
        assert per_layer[name]["workloads"] == ["hmr2.geo_updates"]
    assert per_layer["runner.host_ms"]["workloads"] == ["pw3d.runner_gate"]
    with open(os.path.join(ROOT, "perfbench", "traffic",
                           "hmr2_geo_updates.json")) as f:
        mix = json.load(f)
    with open(os.path.join(ROOT, "perfbench", "traffic",
                           "geo_updates.json")) as f:
        geo = json.load(f)
    assert mix["updates"] == geo["updates"] and mix["trace"] == geo["trace"]
    assert mix["frames"] == geo["frames"] and mix["warmup_frames"] == 16
    assert mix["check"]["start_frames"] == 2


# -- the readers ------------------------------------------------------------------

def _events():
    """Two frames, each in the harness's step span: HMR 2.0's spans inside
    the program's ``engine.step``, with kernels filling all but the gaps."""
    ev = []

    def add(cat, name, a, b):
        ev.append({"cat": cat, "name": name, "ts": float(a),
                   "dur": float(b - a), "tid": 1, "pid": 1})

    gaps = [(120, 160), (210, 230), (330, 350), (505, 515), (620, 700)]
    for f in range(2):
        o = f * 10_000
        add("user_annotation", trace.STEP_SPAN, o, o + 1000)
        add("user_annotation", "engine.step", o + 10, o + 990)
        add("user_annotation", "step.init_forward", o + 100, o + 300)
        add("user_annotation", "model.backbone", o + 110, o + 200)
        add("user_annotation", "model.head", o + 200, o + 290)
        add("cpu_op", "aten::linear", o + 205, o + 240)
        add("user_annotation", "step.grad.upper", o + 300, o + 500)
        add("user_annotation", "step.probe", o + 600, o + 720)
        add("user_annotation", "model.backbone", o + 610, o + 710)
        edges = [0] + [t for g in gaps for t in g] + [1000]
        for a, b in zip(edges[::2], edges[1::2]):
            add("kernel", "k", o + a, o + b)
    return ev


def test_readers_on_a_synthetic_trace():
    """``hmr2.model_idle_ms`` reads the gaps labelled with the model's
    spans (not the one under an ATen call), the wrappers read as the
    readers they wrap, ``step.mfu.hmr2`` counts the protocol's rows times
    the forward's FLOPs, and ``runner.host_ms`` the window outside the
    engine."""
    read = cli.reader
    t = trace.reduce(_events())
    t.update(window_s=0.02, frames=2, updates=[1, 4])
    r = {"trace": t}
    assert read("hmr2.model_idle_ms")(r, None) == pytest.approx(
        (40 + 80) / 1e3)
    assert read("step.grad_idle_ms.hmr2")(r, None) == pytest.approx(
        20 / 1e3)
    assert read("device.idle_share.hmr2")(r, None) == \
        read("device.idle_share")(r, None)
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "hmr2_vith_3dpw.json")) as f:
        cfg = json.load(f)
    rows = (8 + 11) + (8 + 44)
    assert read("step.mfu.hmr2")(r, cfg) == pytest.approx(
        100 * rows * H.forward_flops(FULL) / (t["busy_s"] * 67e12))
    assert work.rows_per_frame(cfg["adapt"], 1) == 19
    for name in ("hmr2.model_idle_ms", "step.mfu.hmr2"):
        assert read(name)({}, cfg) is None
    assert read("runner.host_ms")({"frames": 50, "window_s": 10.0,
                                   "chunk_s": 9.0}, None) == \
        pytest.approx(20.0)
    assert read("runner.host_ms")({"frames": 50, "window_s": 10.0},
                                  None) is None


def test_runner_records_at_the_models_crop(tmp_path):
    """``StreamRunner`` over an HMR 2.0 engine: the gate's similarity is
    logged under its tap and the saved camera's depth is at the 256 crop."""
    from dynaboa_tpu_torch.engine.runner import StreamRunner

    entry = found.module("entries", "hmr2_step", ROOT)
    cfg = _tiny_cfg()
    cfg["model"]["img_res"] = 256
    cfg["adapt"]["optim_steps"] = 1
    inp = entry.make_inputs(cfg, 12, torch.device("cpu"))
    sy = entry.build_system(cfg, inp, torch.device("cpu"))
    engine = sy.engine.engine
    runner = StreamRunner(engine, str(tmp_path), save_predictions=True)
    rng = np.random.default_rng(0)
    items = [{"image": rng.normal(size=(256, 256, 3)).astype(np.float32),
              "smpl_j2d": np.concatenate([rng.uniform(-1, 1, (49, 2)),
                                          np.ones((49, 1))], -1),
              "pose": np.zeros(72, np.float32),
              "betas": np.zeros(10, np.float32), "gender": 0}
             for _ in range(2)]
    state, summary = runner.run(items, engine.init_state(sy.params))
    runner.close()
    assert summary["frames"] == 2
    with open(tmp_path / "scalars.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert all("feat_sim/tap2" in row for row in rows)
    pred = np.load(tmp_path / "result" / "Pred_1.npz")
    cam = pred["cam_crop"]
    assert np.allclose(pred["cam"][:, 2], 2 * 5000 / (256 * cam[:, 0] + 1e-9))
