"""CLIFF in the port (``models/cliff.py``) against the plain reference
(``perfbench/reference/cliff.py``, ``step_cliff.py``) on seeded weights at a
tiny size on the CPU: the forward, its taps and its gradients; the
parameter layout and count and the FLOPs at the published widths; the
full-frame camera against float64 and its centred-box limit; the box rows
through the history ring, the exemplars and the graph key; frames of
``BilevelEngine.step`` against the reference's step; ``StreamRunner.run``
over 3DPW-schema items; the benchmark's new cell end to end at the tiny
size, with a planted fault; HMR's and HMR 2.0's steps bit for bit as the
engine ran them before boxes existed; and the kernels' plain versions and
plans at HRNet-W48's shapes.

The tiny CLIFF has widths 8 / 16 / 32 / 64, one block and one module a
stage, and takes a 128^2 crop (128x96 to the trunk): HRNet's exchange units
upsample each branch onto the one above it, so the trunk's input must
divide by 32, which 64x48 does not.

Tolerances.  The port's model and the reference run the same float32
convolutions and linear maps on the CPU; the reference writes GroupNorm
out (a group's mean and biased variance, then the affine) where the port
calls ATen's, and the two round differently by a few ulp.  Through the
tiny trunk the outputs and taps agree to 4e-7 of their largest magnitude
(the test holds 2e-6); the gradients by a leaf's norm to 1.2e-5, most at
GroupNorm's weights (the test holds 5e-5), where a changed equation (a
box constant, the upsampling's factor, a missing ReLU) moves them by 1e-3
or more.  The engine and the reference step also differ in their SMPL,
loss and Adam code.  Over four frames the outputs and losses agree to
3e-7 and Adam's first moments to 4.2e-5 (the test holds 1e-4 on each, as
the HMR 2.0 test does); the change of the weights and of the teacher to
9e-4 at the median leaf and 5.9e-4 over the whole tree (the test holds
2e-3): Adam turns elements whose gradient is near round-off into full
steps, as the benchmark's check found for HMR's GroupNorm weights, so a
single leaf reads up to 8e-3.  A learning rate 10 % high moves the
weights' change by 10 %."""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as nnf
from torch.func import functional_call

import torch_port_fixtures  # noqa: F401  (shares the cores among workers)
from test_torch_cliff_cuda import CONV_SHAPES, GN_SHAPES

from dynaboa_tpu_torch.engine.bilevel import BilevelEngine, Frame, History
from dynaboa_tpu_torch.kernels import conv as kc
from dynaboa_tpu_torch.kernels import group_norm as kgn
from dynaboa_tpu_torch.models.cliff import CLIFF, bbox_info
from dynaboa_tpu_torch.models.hmr import Conv2d32, GroupNorm32
from dynaboa_tpu_torch.ops.camera import (cam_crop2full, project_to_crop,
                                          project_to_full)
from perfbench.harness import cli, found, trace, work
from perfbench.harness import cliff as H
from perfbench.harness.inputs import mean_params
from perfbench.reference import cliff as RC
from perfbench.reference import step_cliff as RS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "perfbench", "tests"))
import tiny  # noqa: E402

TINY = dict(img_res=128, stem_width=8, stage1_blocks=1, widths=[8, 16, 32, 64],
            modules=[1, 1, 1], blocks=1, head_widths=[4, 8, 16, 32],
            feat_dim=64, regressor_dim=32, n_iter=3)
with open(os.path.join(ROOT, "perfbench", "configs",
                       "cliff_hr48_3dpw.json")) as _f:
    FULL = json.load(_f)["model"]
with open(os.path.join(ROOT, "perfbench", "traffic",
                       "cliff_geo_updates.json")) as _f:
    FRAMES = json.load(_f)["frames"]
INIT_KEYS = ("init_pose", "init_shape", "init_cam")
CAPS = (0, 3, 1, 2)
BOXES = torch.tensor([[500.0, 900.0, 800.0, 1080.0, 1920.0],
                      [540.0, 960.0, 1000.0, 1080.0, 1920.0],
                      [300.0, 1300.0, 600.0, 1080.0, 1920.0]])


def _model(m=TINY, seed=7):
    w = H.weights(m, seed, "cpu")
    init = mean_params("cpu")
    model = CLIFF(**m).eval()
    model.load_state_dict(dict(w, **dict(zip(INIT_KEYS, init))))
    return model, w, init


def _gap(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp(min=1e-30))


def _image(n, res=128, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, res, res, 3, generator=g)


# -- the model against the reference -------------------------------------------

@pytest.mark.parametrize("size", ["tiny", "published"])
def test_parameters_follow_the_published_layout(size):
    """The port's parameters are the benchmark's seeded weights, name for
    name and shape for shape; the published model holds 78,893,405 of them
    (75,315,648 in convolution kernels, 3,472,541 in the regressor), in 325
    convolutions and 325 GroupNorms."""
    m = TINY if size == "tiny" else FULL
    with torch.device("meta"):
        port = CLIFF(**m)
    have = [(k, tuple(v.shape)) for k, v in port.named_parameters()]
    assert have == [(k, s) for k, s, _ in H.shapes(m)]
    assert [k for k, _ in port.named_buffers()] == list(INIT_KEYS)
    assert all(type(x) in (Conv2d32, GroupNorm32) for x in port.modules()
               if isinstance(x, (torch.nn.Conv2d, torch.nn.GroupNorm)))
    assert sum(x.bias is not None for x in port.modules()
               if isinstance(x, Conv2d32)) == 4
    if m is FULL:
        params = dict(port.named_parameters())
        assert sum(p.numel() for p in params.values()) == 78_893_405
        assert sum(p.numel() for p in params.values() if p.dim() == 4) \
            == 75_315_648
        assert sum(p.numel() for k, p in params.items()
                   if not k.startswith("encoder.")) == 3_472_541
        for kind in (Conv2d32, GroupNorm32):
            assert sum(isinstance(x, kind) for x in port.modules()) == 325
    assert (port.img_res, port.retrieval_tap, port.gate_tap) == \
        (m["img_res"], 0, 6)
    assert port.box_conditioned and port.camera == "full_frame"


def test_forward_and_taps_match_reference():
    model, w, init = _model()
    x = _image(3)
    with torch.no_grad():
        a = functional_call(model, w, (x.permute(0, 3, 1, 2), BOXES))
        b = RC.forward(w, x, BOXES, TINY, *init)
    for u, v in zip(a[:3], b[:3]):
        assert _gap(u, v) <= 2e-6
    assert len(a[3]) == len(b[3]) == 1 + 2 * TINY["n_iter"]
    for u, v in zip(a[3], b[3]):
        assert u.shape == v.shape and _gap(u, v) <= 2e-6
    assert a[3][0].shape == (3, TINY["feat_dim"])
    assert a[3][6].shape == (3, TINY["regressor_dim"])
    # rotations are rotations
    eye = torch.eye(3).expand(3, 24, 3, 3)
    assert _gap(a[0] @ a[0].transpose(-1, -2), eye) <= 1e-5
    # the box reaches the regressor
    with torch.no_grad():
        c = functional_call(model, w, (x.permute(0, 3, 1, 2),
                                       BOXES[[1, 2, 0]]))
    assert torch.equal(c[3][0], a[3][0]) and _gap(c[2], a[2]) > 1e-4


def test_gradients_match_reference():
    model, w, init = _model()
    x = _image(3, seed=2)

    def loss(out):
        rotmat, shape, cam, taps = out
        return sum((t ** 2).mean() for t in (rotmat, shape, cam, *taps))

    pa = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    pb = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    ga = torch.autograd.grad(loss(functional_call(
        model, pa, (x.permute(0, 3, 1, 2), BOXES))), list(pa.values()))
    gb = torch.autograd.grad(loss(RC.forward(pb, x, BOXES, TINY, *init)),
                             list(pb.values()))
    for k, u, v in zip(w, ga, gb):
        assert float((u - v).norm()) <= 5e-5 * max(float(v.norm()), 1e-30), k
    assert all(float(v.norm()) > 0 for v in gb)


def test_box_information_is_clifs():
    """CLIFF's normalisation of the box, by hand at one box, and the
    reference's statement of it."""
    box = torch.tensor([[700.0, 800.0, 1100.0, 1080.0, 1920.0]])
    f = (1080.0 ** 2 + 1920.0 ** 2) ** 0.5
    want = torch.tensor([[(700 - 540) / f * 2.8, (800 - 960) / f * 2.8,
                          (1100 - 0.24 * f) / (0.06 * f)]])
    assert _gap(bbox_info(box), want) <= 1e-6
    assert _gap(RC.box_info(BOXES), bbox_info(BOXES)) <= 1e-6
    assert f == pytest.approx(2202.9, abs=0.05)


def test_flops_hand_count_and_flop_counter():
    """The published forward: 33,867,577,344 FLOPs a 256x192 row (4.1 times
    HMR's), 33,846,755,328 of them in the 325 convolutions; the count equals
    torch's FlopCounterMode over the reference forward (on the meta device)
    at the tiny and the published sizes."""
    from torch.utils.flop_counter import FlopCounterMode

    assert H.forward_flops(FULL) == 33_867_577_344
    assert H.conv_flops(FULL) == 33_846_755_328
    assert H.norm_elements(FULL) == 27_972_864
    assert H.input_size(FULL) == (256, 192)
    for m in (TINY, FULL):
        with torch.device("meta"):
            w = {k: torch.zeros(s) for k, s, _ in H.shapes(m)}
            init = (torch.zeros(1, 144), torch.zeros(1, 10),
                    torch.zeros(1, 3))
            with FlopCounterMode(display=False) as fc:
                RC.forward(w, torch.zeros(1, m["img_res"], m["img_res"], 3),
                           torch.ones(1, 5), m, *init)
        assert fc.get_total_flops() == H.forward_flops(m)


def test_shapes_are_the_cards_tests():
    """A published-width forward on the CPU: 325 convolutions of the card
    tests' 47 shapes and 325 GroupNorms of their 22, counted by hooks."""
    model = CLIFF(**FULL).eval()
    convs, norms = [], []
    hooks = []
    for mod in model.modules():
        if isinstance(mod, Conv2d32):
            hooks.append(mod.register_forward_pre_hook(
                lambda mod, a: convs.append(
                    (tuple(a[0].shape[1:]), mod.out_channels,
                     mod.kernel_size[0], mod.stride[0], mod.padding[0]))))
        elif isinstance(mod, GroupNorm32):
            hooks.append(mod.register_forward_pre_hook(
                lambda mod, a: norms.append(tuple(a[0].shape[1:]))))
    with torch.no_grad():
        model(torch.zeros((1, 3, 256, 256)), BOXES[:1])
    for h in hooks:
        h.remove()
    assert len(convs) == len(norms) == 325
    assert tuple(dict.fromkeys(convs)) == CONV_SHAPES
    assert tuple(dict.fromkeys(norms)) == GN_SHAPES
    # the harness's walk holds the same convolutions (in the modules'
    # order, which the head's calls interleave)
    walked = [x for x in H.walk(FULL) if x[0] == "conv"]
    assert sorted((c[2], c[3], c[4], c[5]) for c in walked) == \
        sorted((c[0][0], c[1], c[2], c[3]) for c in convs)


# -- the camera ------------------------------------------------------------------

def _joints(n=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    return 0.4 * torch.randn((n, 49, 3), generator=g)


def _cams(n=3):
    return torch.tensor([[0.9, 0.1, -0.2], [1.1, -0.05, 0.3],
                         [0.7, 0.0, 0.1]])[:n]


def test_cam_crop2full_and_projection_against_float64():
    cam, s3d = _cams(), _joints()
    t = cam_crop2full(cam, BOXES)
    t64 = cam_crop2full(cam.double(), BOXES.double())
    assert _gap(t, t64) <= 1e-6
    # by hand in float64 (without the 1e-9 that keeps b s off zero)
    cx, cy, b, w, h = BOXES.double().unbind(-1)
    c64 = cam.double()
    s = c64[:, 0]
    f = (w ** 2 + h ** 2).sqrt()
    want = torch.stack([c64[:, 1] + 2 * (cx - w / 2) / (b * s),
                        c64[:, 2] + 2 * (cy - h / 2) / (b * s),
                        2 * f / (b * s)], -1)
    assert _gap(t64, want) <= 1e-10
    out = project_to_full(cam, s3d, BOXES)
    out64 = project_to_full(cam.double(), s3d.double(), BOXES.double())
    assert _gap(out["normed"], out64["normed"]) <= 1e-5
    assert _gap(out["ori"], out64["ori"]) <= 1e-6
    pts = s3d.double() + want[:, None]
    ori = f[:, None, None] * pts[..., :2] / pts[..., 2:] + torch.stack(
        [w, h], -1)[:, None] / 2
    assert _gap(out64["ori"], ori) <= 1e-10
    assert _gap(out64["normed"], (ori - torch.stack([cx, cy], -1)[:, None])
                / (b[:, None, None] / 2)) <= 1e-10
    # the reference's statement of the same projection
    assert _gap(RS.project(cam, s3d, BOXES), out["normed"]) <= 1e-5


def test_centred_box_at_long_focus_is_the_weak_perspective():
    """A box at the frame's centre, the frame 1e5 times larger (so f ->
    infinity with the box's size fixed): the full-frame projection in the
    box's units is the weak perspective s (X + t), which the crop camera's
    projection also tends to."""
    cam, s3d = _cams(), _joints()
    b = torch.tensor([800.0, 1000.0, 600.0])
    side = 1e5 * torch.tensor([1080.0, 1920.0])
    box = torch.stack([side[0] / 2 + 0 * b, side[1] / 2 + 0 * b, b,
                       side[0] + 0 * b, side[1] + 0 * b], -1).double()
    weak = cam[:, :1, None].double() * (s3d[..., :2].double()
                                        + cam[:, None, 1:].double())
    got = project_to_full(cam.double(), s3d.double(), box)["normed"]
    assert _gap(got, weak) <= 1e-4
    near = project_to_full(cam.double(), s3d.double(),
                           box * torch.tensor([1e-4, 1e-4, 1, 1e-4, 1e-4],
                                              dtype=torch.float64))["normed"]
    assert _gap(near, weak) > 1e-2          # a near frame is perspective
    crop = project_to_crop(cam.double(), s3d.double(), img_res=256)["normed"]
    assert _gap(crop, weak) <= 5e-2


# -- the engine: boxes through the ring, the exemplars and the graph key --------

def _tiny_cfg():
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "cliff_hr48_3dpw.json")) as f:
        cfg = tiny.shrink(json.load(f))
    cfg["model"] = dict(TINY)
    cfg["adapt"]["use_pallas_lbs"] = False
    return cfg


@pytest.fixture(scope="module")
def system():
    entry = found.module("entries", "cliff_step", ROOT)
    cfg = _tiny_cfg()
    inp = entry.make_inputs(cfg, 11, torch.device("cpu"))
    return cfg, inp, entry.build_system(cfg, inp, torch.device("cpu"))


def _frames(cfg, n, seed=3):
    spec = dict(FRAMES, pool=n)
    return found.module("sources", "boxed_crops", ROOT).make(seed, spec, cfg,
                                                             "cpu")


def test_boxed_frames_are_the_mixs(system):
    cfg, _, _ = system
    frames = _frames(cfg, 64, seed=5)
    box = torch.cat([f["box"] for f in frames])
    assert box.shape == (64, 5)
    assert torch.equal(box[:, 3:], torch.tensor([[1080.0, 1920.0]] * 64))
    assert float(box[:, 0].min()) >= 0.2 * 1080 and \
        float(box[:, 0].max()) <= 0.8 * 1080
    assert float(box[:, 1].min()) >= 0.2 * 1920 and \
        float(box[:, 1].max()) <= 0.8 * 1920
    assert 500 <= float(box[:, 2].min()) and float(box[:, 2].max()) <= 1500
    assert frames[0]["image"].shape == (1, 128, 128, 3)


def test_box_rows_through_ring_exemplars_and_key(system):
    cfg, inp, sy = system
    engine = sy.engine.engine
    assert engine.boxed and engine._project == engine._project_full
    state = engine.init_state(sy.params)
    res = TINY["img_res"]
    assert torch.equal(state.hist_box, torch.tensor(
        [res / 2, res / 2, res, res, res]).repeat(cfg["adapt"]["interval"],
                                                  1, 1))
    frames = [Frame(**f) for f in _frames(cfg, 2)]
    for fr in frames:
        slot = state.step % cfg["adapt"]["interval"]
        state, out = engine.step(state, fr, cos_sim_threshold=-1.0,
                                 extra_cap=0)
        assert torch.equal(state.hist_box[slot], fr.box)
        assert torch.equal(out["cam_full"], cam_crop2full(out["cam"], fr.box))
    hist = engine._history(state)
    assert torch.equal(hist.box, state.hist_box[state.step
                                                % cfg["adapt"]["interval"]])
    # an exemplar draw carries its boxes
    bank = engine.store.bank.take(torch.tensor([3, 1]))
    assert torch.equal(bank.box, inp.store["box"][[3, 1]])
    assert inp.store["box"].shape == (8, 5)
    assert float(inp.store["box"][:, 3:].min()) == 1000.0
    # the key holds the boxes' shapes; a box-less input keys as before
    fr = frames[0]._replace(pose=None, betas=None, gender=None)
    key = engine._grad_key("upper", True, fr, hist, bank)
    assert key[2][-1] == ((1, 5), torch.float32)
    assert key[3][-1] == ((1, 5), torch.float32)
    assert key[4][-1] == ((2, 5), torch.float32)
    bare = engine._grad_key("upper", True, fr._replace(box=None),
                            hist._replace(box=None), bank._replace(box=None))
    assert len(bare[2]) == 6 and len(bare[3]) == 3 and len(bare[4]) == 5
    assert key != bare
    # a box-conditioned model refuses a frame without its box
    with pytest.raises(ValueError, match="Frame.box"):
        engine.step(state, frames[0]._replace(box=None))


def test_box_conditioned_model_needs_exemplar_boxes(system):
    _, _, sy = system
    engine = sy.engine.engine
    store = engine.store._replace(bank=engine.store.bank._replace(box=None))
    with pytest.raises(ValueError, match="ExemplarBank.box"):
        BilevelEngine(engine.cfg, engine.model, engine.prior, engine.smpls,
                      store)


def test_engine_steps_match_reference(system):
    """Four frames of ``BilevelEngine.step`` with the tiny CLIFF at caps 0,
    3, 1, 2 (threshold -1), against the reference's step from the same
    seeded state: predictions, losses, metrics and update counts each
    frame; weights, teacher and Adam's moments after."""
    from perfbench.reference.losses import gmm_prior

    cfg, inp, sy = system
    entry = found.module("entries", "cliff_step", ROOT)
    sy = entry.build_system(cfg, inp, torch.device("cpu"))
    engine = sy.engine.engine
    state = engine.init_state(sy.params)
    g = inp.gmm
    ctx = RS.Context(adapt=dict(cfg["adapt"]), model=cfg["model"],
                     init=inp.init, bodies=inp.bodies, Jh36m=inp.Jh36m,
                     prior=gmm_prior(g["means"], g["covars"], g["weights"],
                                     "cpu"),
                     store=inp.store, compute_metrics=True)
    st = RS.fresh_state(ctx, inp.weights, TINY["img_res"], "cpu")
    for fr, cap in zip(_frames(cfg, 4), CAPS):
        state, out = engine.step(state, Frame(**fr), cos_sim_threshold=-1.0,
                                 extra_cap=cap)
        ref = RS.step(ctx, st, fr, -1.0, cap)
        assert out["optim_steps"] + 1 == ref["n_updates"] == cap + 1
        for k, rk in (("verts", "verts"), ("cam", "cam"), ("rotmat", "rotmat"),
                      ("beta", "beta"), ("mpjpe", "mpjpe"), ("pve", "pve")):
            assert _gap(out[k], ref[rk]) <= 1e-4, k
        assert _gap(out["upper"]["loss"], ref["upper_loss"]) <= 1e-4
        assert _gap(out["lower"]["loss"], ref["lower_loss"]) <= 1e-4
        assert _gap(out["per_step_loss"][:cap + 1],
                    ref["per_step_loss"]) <= 1e-4
    assert torch.equal(state.hist_box, st.hist_box)
    opt = state.optimizer
    for mine, ref in ((state.params, st.params),
                      (state.teacher_params, st.teacher)):
        d = {k: mine[k].detach() - inp.weights[k] for k in mine}
        r = {k: ref[k] - inp.weights[k] for k in mine}
        leaf = [float((d[k] - r[k]).norm() / r[k].norm().clamp(min=1e-30))
                for k in mine]
        tree = float(torch.cat([(d[k] - r[k]).reshape(-1) for k in mine])
                     .norm() / torch.cat([r[k].reshape(-1) for k in mine])
                     .norm())
        assert float(np.median(leaf)) <= 2e-3 and tree <= 2e-3
    m = torch.cat([opt.state[p]["exp_avg"].reshape(-1)
                   for p in state.params.values()])
    rm = torch.cat([st.m[k].reshape(-1) for k in state.params])
    assert float((m - rm).norm() / rm.norm()) <= 1e-4


# -- the runner ------------------------------------------------------------------

def _items(n, res, seed=0, frame_size=True):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        b = rng.uniform(500, 1500)
        item = {"image": rng.normal(size=(res, res, 3)).astype(np.float32),
                "smpl_j2d": np.concatenate([rng.uniform(-1, 1, (49, 2)),
                                            np.ones((49, 1))], -1),
                "pose": rng.normal(scale=0.2, size=72).astype(np.float32),
                "betas": np.zeros(10, np.float32), "gender": i % 2,
                "imgname": f"frame_{i:05d}.jpg",
                "bbox": np.array([rng.uniform(300, 800),
                                  rng.uniform(600, 1300), b], np.float32)}
        if frame_size:
            item["frame_size"] = np.array([1080, 1920], np.float32)
        out.append(item)
    return out


def test_runner_steps_boxed_items_and_saves_the_full_frame_camera(
        tmp_path, system):
    """``StreamRunner.run`` over two 3DPW-schema items with a CLIFF engine:
    each frame carries its item's box, and the saved camera is the
    full-frame translation of the crop camera."""
    from dynaboa_tpu_torch.engine.runner import StreamRunner, frame_from_item

    cfg, inp, _ = system
    cfg = json.loads(json.dumps(cfg))
    cfg["adapt"]["optim_steps"] = 1
    entry = found.module("entries", "cliff_step", ROOT)
    sy = entry.build_system(cfg, inp, torch.device("cpu"))
    engine = sy.engine.engine
    items = _items(2, TINY["img_res"])
    fr = frame_from_item(items[0], "cpu", img_res=TINY["img_res"], boxed=True)
    assert torch.equal(fr.box, torch.tensor(
        [[*items[0]["bbox"], 1080.0, 1920.0]]))
    assert frame_from_item(items[0], "cpu").box is None
    with pytest.raises(KeyError, match="frame_size"):
        frame_from_item(_items(1, 8, frame_size=False)[0], "cpu", boxed=True)
    runner = StreamRunner(engine, str(tmp_path), save_predictions=True)
    state, summary = runner.run(items, engine.init_state(sy.params))
    runner.close()
    assert summary["frames"] == 2 and np.isfinite(summary["mpjpe"])
    assert torch.equal(state.hist_box[1], frame_from_item(
        items[1], "cpu", boxed=True).box)
    with open(tmp_path / "scalars.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert all("feat_sim/tap6" in row for row in rows)
    for i, item in enumerate(items):
        pred = np.load(tmp_path / "result" / f"Pred_{i}.npz")
        box = torch.tensor([[*item["bbox"], 1080.0, 1920.0]])
        want = cam_crop2full(torch.as_tensor(pred["cam_crop"]), box).numpy()
        assert np.allclose(pred["cam"], want, rtol=1e-6, atol=0)


# -- HMR and HMR 2.0 as the engine ran them before boxes ------------------------

class _Before(BilevelEngine):
    """The engine with the methods that now read boxes as they were before
    (the earlier commit's code, verbatim): a box-less model runs them."""

    def _forward(self, params, image, box=None):
        return functional_call(self.model, params,
                               (image.permute(0, 3, 1, 2),))

    @torch.no_grad()
    def predict(self, params, image, box=None):
        rotmat, shape, cam, feats = self._forward(params, image)
        s3d, verts = self._decode(rotmat, shape, no_grad=True)
        s2d = project_to_crop(cam, s3d, img_res=self.img_res)["normed"]
        return dict(rotmat=rotmat, shape=shape, cam=cam, s3d=s3d,
                    verts=verts, s2d=s2d, feats=feats)

    @torch.no_grad()
    def _teacher_outs(self, teacher_params, frame):
        t_rotmat, t_shape, t_cam, _ = self._forward(teacher_params, frame.image)
        t_s3d, _ = self._decode(t_rotmat, t_shape)
        t_s2d = project_to_crop(t_cam, t_s3d, img_res=self.img_res)["normed"]
        return (t_rotmat, t_shape, t_s2d, t_s3d)

    def _history(self, state):
        slot = state.step % self.cfg.interval
        return History(state.hist_images[slot], state.hist_j2d[slot],
                       self._motion_switch[int(state.step
                                               > self.cfg.interval)])

    def _partial_level(self, params, frame, bank, lv, hist):
        from dynaboa_tpu_torch.losses.adaptation import (
            frame_loss, keypoint_2d_loss_openpose, labeled_loss, motion_loss)

        cfg = self.cfg
        B = frame.image.shape[0]
        imgs = [frame.image]
        if lv.motion:
            imgs.append(hist.image)
        n_ex = 0
        if lv.mixtrain:
            imgs.append(bank.images)
            n_ex = bank.images.shape[0]
        x = torch.cat(imgs, dim=0) if len(imgs) > 1 else imgs[0]

        rotmat, shape, cam, feats_all = self._forward(params, x)
        s3d, _ = self._decode(rotmat, shape)
        s2d = project_to_crop(cam, s3d, img_res=self.img_res)["normed"]

        fr = slice(0, B)
        hi = slice(B, 2 * B)
        ex = slice(x.shape[0] - n_ex, x.shape[0])
        feats = tuple(f[fr] for f in feats_all)

        aux = {}
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
        if lv.frame:
            loss, parts = frame_loss(
                self.prior, s2d[fr], rotmat[fr], shape[fr], frame.j2d,
                cfg.s2dloss_weight, cfg.shape_prior_weight,
                cfg.pose_prior_weight, frame.mask,
                kp_loss_fn=(keypoint_2d_loss_openpose
                            if cfg.keypoint_source == "openpose" else None))
            aux.update(parts)
            aux["unlabelloss"] = loss
        if lv.motion:
            ksl = (slice(None, 25) if cfg.keypoint_source == "openpose"
                   else slice(25, None))
            ml = motion_loss(s2d[fr][:, ksl], frame.j2d[:, ksl],
                             s2d[hi][:, ksl], hist.j2d[:, ksl], frame.mask)
            loss = loss + ml * hist.active * cfg.motionloss_weight
            aux["motion_loss"] = ml * hist.active
        if lv.mixtrain:
            ll, lparts = labeled_loss(
                rotmat[ex], shape[ex], s2d[ex], s3d[ex],
                bank.pose, bank.betas, bank.keypoints, bank.pose_3d)
            loss = loss + ll * cfg.labelloss_weight
            aux["labledloss"] = ll
            aux.update(lparts)
        touts = (rotmat[fr], shape[fr], s2d[fr], s3d[fr])
        return loss, touts, feats, aux


def _flat(out, prefix=""):
    flat = {}
    for k, v in out.items():
        if isinstance(v, dict):
            flat.update(_flat(v, f"{prefix}{k}/"))
        else:
            flat[prefix + k] = v
    return flat


def _hmr2_system():
    entry = found.module("entries", "hmr2_step", ROOT)
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "hmr2_vith_3dpw.json")) as f:
        cfg = tiny.shrink(json.load(f))
    cfg["model"] = dict(img_res=64, patch_size=16, patch_padding=2,
                        embed_dim=64, depth=2, num_heads=4, mlp_ratio=4,
                        ln_eps=1e-6, dec_dim=32, dec_depth=2, dec_heads=2,
                        dec_dim_head=16, dec_mlp_dim=32, ief_iters=1)
    cfg["adapt"]["use_pallas_lbs"] = False
    inp = entry.make_inputs(cfg, 13, torch.device("cpu"))
    return cfg, entry.build_system(cfg, inp, torch.device("cpu"))


def _hmr_system():
    from perfbench.harness.program import build_system, make_inputs

    with open(os.path.join(ROOT, "perfbench", "configs",
                           "dynaboa_3dpw.json")) as f:
        cfg = tiny.shrink(json.load(f))
    cfg["model"]["img_res"] = 64
    cfg["adapt"]["use_pallas_lbs"] = False
    inp = make_inputs(cfg, 13, torch.device("cpu"))
    return cfg, build_system(cfg, inp, torch.device("cpu"))


@pytest.mark.parametrize("model", ["hmr", "hmr2"])
def test_boxless_steps_bit_equal_to_before(model):
    """Four frames (caps 0, 3, 1, 2) of HMR's and HMR 2.0's steps with
    ``box=None``: every output, weight, teacher weight and Adam moment, and
    every gradient evaluation's graph key, equal to the engine whose
    box-reading methods are the earlier commit's."""
    cfg, sy = _hmr_system() if model == "hmr" else _hmr2_system()
    eng = sy.engine.engine if hasattr(sy.engine, "engine") else sy.engine
    assert not eng.boxed and eng._project == eng._project_crop
    before = _Before(eng.cfg, eng.model, eng.prior, eng.smpls, eng.store,
                     compute_metrics=eng.compute_metrics)
    res = cfg["model"]["img_res"]
    spec = dict(FRAMES, pool=4)
    frames = [Frame(**{k: v for k, v in f.items() if k != "box"})
              for f in found.module("sources", "boxed_crops", ROOT).make(
                  5, spec, cfg, "cpu")]
    assert frames[0].image.shape[1] == res and frames[0].box is None
    def old_key(level, own, frame, hist, bank):
        """The earlier commit's key over its fields (no box field)."""
        def spec(x, n):
            return None if x is None else tuple(
                None if t is None else (tuple(t.shape), t.dtype)
                for t in x[:n])
        return (level, own, spec(frame, 6), spec(hist, 3), spec(bank, 5))

    keys = []

    def grad(state, params, frame, bank, lv):
        # each evaluation's inputs, as ``BilevelEngine._grad`` makes them
        inputs = (frame._replace(pose=None, betas=None, gender=None),
                  eng._history(state) if lv.motion else None,
                  bank if lv.mixtrain else None)
        keys.append((eng._grad_key(lv.name, params is state.params, *inputs),
                     old_key(lv.name, params is state.params, *inputs)))
        return BilevelEngine._grad(eng, state, params, frame, bank, lv)

    states = {}
    for name, e in (("now", eng), ("before", before)):
        state = e.init_state(sy.params, img_res=res)
        assert state.hist_box is None
        outs = []
        if e is eng:
            e._grad = grad
        try:
            for fr, cap in zip(frames, CAPS):
                state, out = e.step(state, fr, cos_sim_threshold=-1.0,
                                    extra_cap=cap)
                outs.append(_flat(out))
        finally:
            vars(e).pop("_grad", None)
        states[name] = (state, outs)
    assert len(keys) == 4 + 10 and all(a == b for a, b in keys)
    (sa, oa), (sb, ob) = states["now"], states["before"]
    for a, b in zip(oa, ob):
        assert a.keys() == b.keys() and "cam_full" not in a
        for k in a:
            assert (torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
                    else a[k] == b[k]), k
    for k in sa.params:
        assert torch.equal(sa.params[k], sb.params[k]), k
        assert torch.equal(sa.teacher_params[k], sb.teacher_params[k]), k
        for m in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa.optimizer.state[sa.params[k]][m],
                               sb.optimizer.state[sb.params[k]][m]), k


# -- the cell end to end at the tiny size -----------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root, bench = tiny.make_tree(str(tmp_path_factory.mktemp("tree")))
    path = os.path.join(root, "perfbench", "configs", "cliff_hr48_3dpw.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["model"] = dict(TINY)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return root, bench


def test_new_cell_is_correct_and_reads_its_metrics(tree):
    root, bench = tree
    res, r, nums, _ = tiny.run(root, bench, "cliff.geo_updates", seconds=1.0,
                               traced=True)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and r["frames"] > 0
    assert nums["compared_frames"] >= 3
    assert r["trace"]["step_calls"] == 8
    assert r["trace"]["updates"] == [1, 8, 1, 7, 2, 4, 2, 4]
    # the CPU runs every evaluation eagerly
    gs = r["graph_stats"]["trace"]
    assert gs["captures"] == gs["replays"] == 0 and gs["eager"] > 0
    # readers of the device's kernels find none on the CPU
    for name in ("conv_fprop_roofline.cliff", "group_norm_roofline.cliff"):
        assert name not in res["metrics"]


def test_new_cell_with_a_fault_is_not_correct(tree):
    """A learning rate 10 % high in the program and not in the reference."""
    root, bench = tree
    res, _, _, _ = tiny.run(root, bench, "cliff.geo_updates", seconds=1.0,
                            overrides={"lr": 3e-6 * 1.1})
    assert not res["correct"], res["checks"]


def test_benchmark_entries_of_this_configuration():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert bench["workloads"][-1]["name"] == "cliff.geo_updates"
    cell = bench["workloads"][-1]
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("cliff_hr48_3dpw", "cliff_geo_updates", 1)
    cfg = {c["name"]: c for c in bench["configs"]}["cliff_hr48_3dpw"]
    assert cfg["reduced"] == [] and cfg["file"].endswith(
        "cliff_hr48_3dpw.json")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["device_ms_per_frame"]["workloads"][-1] == "cliff.geo_updates"
    names = ("step.mfu.cliff", "device.idle_share.cliff",
             "cliff.model_idle_ms", "conv_fprop_roofline.cliff",
             "group_norm_roofline.cliff")
    assert tuple(m["name"] for m in bench["per_layer"][-5:]) == names
    for m in bench["per_layer"][-5:]:
        assert m["workloads"] == ["cliff.geo_updates"]
        assert m["moves"] == "device_ms_per_frame"
    with open(os.path.join(ROOT, "perfbench", "traffic",
                           "cliff_geo_updates.json")) as f:
        mix = json.load(f)
    with open(os.path.join(ROOT, "perfbench", "traffic",
                           "geo_updates.json")) as f:
        geo = json.load(f)
    assert mix["updates"] == geo["updates"] and mix["trace"] == geo["trace"]
    assert mix["warmup_frames"] == 16 and mix["check"] == geo["check"]
    assert mix["frames"]["pool"] == 64


# -- the readers ------------------------------------------------------------------

def _events():
    """Two frames, each in the harness's step span: CLIFF's spans inside
    the program's ``engine.step``, with kernels filling all but the gaps;
    the kernels include the two Hopper kernels'."""
    ev = []

    def add(cat, name, a, b):
        ev.append({"cat": cat, "name": name, "ts": float(a),
                   "dur": float(b - a), "tid": 1, "pid": 1})

    gaps = [(120, 160), (170, 180), (210, 230), (330, 350), (505, 515),
            (620, 700)]
    for f in range(2):
        o = f * 10_000
        add("user_annotation", trace.STEP_SPAN, o, o + 1000)
        add("user_annotation", "engine.step", o + 10, o + 990)
        add("user_annotation", "step.init_forward", o + 100, o + 300)
        add("user_annotation", "model.backbone", o + 110, o + 200)
        add("user_annotation", "model.fuse", o + 165, o + 190)
        add("user_annotation", "model.head", o + 200, o + 290)
        add("cpu_op", "aten::linear", o + 205, o + 240)
        add("user_annotation", "step.grad.upper", o + 300, o + 500)
        add("user_annotation", "step.probe", o + 600, o + 720)
        add("user_annotation", "model.backbone", o + 610, o + 710)
        edges = [0] + [t for g in gaps for t in g] + [1000]
        names = ["void dynaboa_conv_fprop<64, 64, true>",
                 "dynaboa_group_norm_fwd<float>", "k"]
        for i, (a, b) in enumerate(zip(edges[::2], edges[1::2])):
            add("kernel", names[i % 3], o + a, o + b)
    return ev


def test_readers_on_a_synthetic_trace():
    """``cliff.model_idle_ms`` reads the gaps labelled with the model's
    three spans (not the one under an ATen call); the idle share reads as
    the reader it wraps; ``step.mfu.cliff`` counts the protocol's rows times
    the forward's FLOPs; the two rooflines the convolution FLOPs and the
    GroupNorm bytes of the segment's image rows over their kernels' time;
    each reads None without a trace or without its kernels."""
    read = cli.reader
    t = trace.reduce(_events())
    t.update(window_s=0.02, frames=2, updates=[1, 4])
    r = {"trace": t}
    assert read("cliff.model_idle_ms")(r, None) == pytest.approx(
        (40 + 10 + 80) / 1e3)
    assert read("device.idle_share.cliff")(r, None) == \
        read("device.idle_share")(r, None)
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "cliff_hr48_3dpw.json")) as f:
        cfg = json.load(f)
    rows = (8 + 11) + (8 + 44)
    assert [work.rows_per_frame(cfg["adapt"], n) for n in (1, 4)] == \
        [19, 52]
    assert read("step.mfu.cliff")(r, cfg) == pytest.approx(
        100 * rows * H.forward_flops(FULL) / (t["busy_s"] * 67e12))
    image_rows = (4 + 5) + (4 + 20)

    def summed(part):
        return sum(d for k, ds in t["kernels"].items() if part in k
                   for d in ds)

    assert read("conv_fprop_roofline.cliff")(r, cfg) == pytest.approx(
        100 * image_rows * 33_846_755_328 / 67e12 / summed("conv_fprop"))
    assert read("group_norm_roofline.cliff")(r, cfg) == pytest.approx(
        100 * image_rows * 8 * 27_972_864 / 3.35e12 / summed("group_norm"))
    for name in ("cliff.model_idle_ms", "step.mfu.cliff",
                 "conv_fprop_roofline.cliff", "group_norm_roofline.cliff",
                 "device.idle_share.cliff"):
        assert read(name)({}, cfg) is None
    bare = dict(t, kernels={"k": [0.001]})
    for name in ("conv_fprop_roofline.cliff", "group_norm_roofline.cliff"):
        assert read(name)({"trace": bare}, cfg) is None


# -- the kernels' plain versions and plans at HRNet-W48's shapes ----------------

@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_plain_matches_aten_at_hrnet_shapes(shape, n):
    """The convolution kernel's arithmetic (the plan's shares of the
    reduction, summed in rank order) against ATen's on the CPU, within the
    2e-6 the ResNet-50 shapes are held to; the plan takes every shape."""
    (C, H_, W), K, k, s, p = shape
    g = torch.Generator().manual_seed(sum(shape[0]) + n)
    x = torch.randn((n, C, H_, W), generator=g)
    w = torch.randn((K, C, k, k), generator=g) * (2.0 / (k * k * K)) ** 0.5
    y = kc.conv2d_plain(x, w, (s, s), (p, p))
    ref = nnf.conv2d(x, w, None, s, p)
    assert y.shape == ref.shape and y.stride() == ref.stride()
    assert _gap(y, ref) <= 2e-6
    P, Q = kc.out_size(H_, k, s, p), kc.out_size(W, k, s, p)
    kred = C * k * k
    pl = kc.plan(K, n * P * Q, kred, k)
    assert (pl.bm, pl.bn) in kc.TILES and pl.split in (1, 2, 4, 8, 16)
    assert pl.split <= -(-kred // kc.BK) and pl.smem <= kc.MAX_SMEM
    assert (pl.ctas >= kc.TARGET_CTAS or pl.split == kc.MAX_CLUSTER
            or -(-kred // kc.BK) // (2 * pl.split) < kc.MIN_STEPS)


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("chw", GN_SHAPES)
def test_group_norm_plan_covers_every_hrnet_shape(chw, n):
    """Every group (at most 196,608 floats, 64 channels at 64x48) within
    the kernel's reach, the CTAs resident; and the plain version against
    ATen's GroupNorm."""
    cluster, threads = kgn.plan(n, chw[0], 4, chw[1] * chw[2])
    E = chw[0] // 4 * chw[1] * chw[2]
    assert E <= 196_608 < kgn.MAX_GROUP
    assert cluster in (1, 2, 4, 8, 16)
    assert threads % 32 == 0 and 32 <= threads <= kgn.MAX_THREADS
    assert cluster * threads * kgn.PER_THREAD * 4 >= E
    assert n * 4 * cluster <= kgn.RESIDENT_CTAS
    g = torch.Generator().manual_seed(sum(chw) + n)
    x = torch.randn((n, *chw), generator=g)
    w = 1.0 + 0.1 * torch.randn((chw[0],), generator=g)
    b = 0.1 * torch.randn((chw[0],), generator=g)
    y, _, _ = kgn.group_norm_plain(x, 4, w, b, 1e-5)
    assert _gap(y, nnf.group_norm(x, 4, w, b, 1e-5)) <= 1e-6
