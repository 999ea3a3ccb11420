"""The port's stream app (``apps/stream.py``) against the JAX package's:
the pipeline's order, lag and reset, the keypoint crop, the loop on
in-memory frames, CPU runs of the CLI on a cv2-written video, and the
runner's ``--save_res`` overlay.  The engine's OpenPose keypoint source is
held against the JAX engine in ``test_torch_engine_openpose.py``."""

import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynaboa_tpu.apps import stream as jstream
from dynaboa_tpu.engine.runner import StreamRunner as JRunner
from dynaboa_tpu.ops import image as JI
from dynaboa_tpu_torch.apps import stream as tstream
from dynaboa_tpu_torch.apps.common import build_system
from dynaboa_tpu_torch.config import AdaptConfig as TAdaptConfig, Paths
from dynaboa_tpu_torch.engine import bilevel as teng
from dynaboa_tpu_torch.engine.runner import StreamRunner as TRunner
from dynaboa_tpu_torch.models.smpl import synthetic_smpl_model
from tests import torch_port_fixtures as F

LEAN = ["--tiny", "1", "--dynamic_boa", "0", "--use_meanteacher", "0",
        "--use_motion", "0", "--retrieval", "0", "--lower_level_mixtrain", "0",
        "--upper_level_mixtrain", "0", "--record_lowerlevel", "0"]
H, W = 240, 320


class _FakeEngine:
    def __init__(self):
        self.dispatched = []

    def step(self, state, frame):
        self.dispatched.append(frame)
        return state, {"verts": np.zeros((1, 4, 3)), "cam": np.zeros((1, 3))}


def test_pipeline_one_frame_lag_preserves_order():
    """Frame t's record comes back after frame t+1's step; pass-through
    frames ride the same queue, so the output order is the capture order."""
    eng = _FakeEngine()
    pipe = tstream.AdaptPipeline(eng, state="s0")
    assert pipe.submit("f0", {"i": 0}) is None
    r = pipe.submit("f1", {"i": 1})
    assert r[1]["i"] == 0 and eng.dispatched == ["f0", "f1"]
    r = pipe.submit_passthrough({"i": 2})
    assert r[1]["i"] == 1
    r = pipe.submit("f3", {"i": 3})
    assert r[0] is None and r[1]["i"] == 2
    assert pipe.drain()[1]["i"] == 3
    assert pipe.drain() is None
    assert eng.dispatched == ["f0", "f1", "f3"]


def test_pipeline_depth_two_with_fetch_and_augment():
    eng = _FakeEngine()
    seen = []
    pipe = tstream.AdaptPipeline(
        eng, state=None, depth=2,
        augment_fn=lambda f, o: dict(o, base=f),
        fetch_fn=lambda o: seen.append(o["base"]) or ("fetched", o["base"]))
    assert pipe.submit("f0", {"i": 0}) is None
    assert pipe.submit_passthrough({"i": 1}) is None
    r = pipe.submit("f2", {"i": 2})
    assert r == (("fetched", "f0"), {"i": 0}) and seen == ["f0", "f2"]
    assert [pipe.drain()[1]["i"] for _ in range(2)] == [1, 2]


CFG_OPENPOSE = dict(interval=2, retrieval=False, lower_level_mixtrain=False,
                    upper_level_mixtrain=False, record_lowerlevel=False,
                    keypoint_source="openpose")


def test_reset_keeps_history_step_and_rng():
    """'r' reset (reference reload(), dynaboa_webcam.py:184-195): params,
    teacher and Adam return to the base weights; the history ring, frame
    counter and rng survive."""
    cfg = TAdaptConfig(**CFG_OPENPOSE)
    net = F.torch_hmr_from(F.jax_hmr()[1])
    eng = teng.BilevelEngine(cfg, net, F.t_prior(4, F.CPU), F.torch_smpls(),
                             None, compute_metrics=False)
    pristine = {k: v.detach().clone() for k, v in net.named_parameters()}
    pipe = tstream.AdaptPipeline(eng, eng.init_state(pristine, img_res=F.IMG))
    for fr in F.make_frames(3, seed=4):
        pipe.submit(F.torch_frame(fr), {})
    st = pipe.state
    hist = (st.hist_images.clone(), st.hist_j2d.clone())
    rng_state = st.rng.get_state().clone()
    assert st.step == 3 and hist[0].abs().sum() > 0
    assert max(float((st.params[k].detach() - pristine[k]).abs().max())
               for k in pristine) > 0
    old_opt = st.optimizer
    assert old_opt.state

    pipe.reset(pristine)
    st = pipe.state
    for k, v in pristine.items():
        torch.testing.assert_close(st.params[k].detach(), v, rtol=0, atol=0)
        torch.testing.assert_close(st.teacher_params[k], v, rtol=0, atol=0)
    assert st.optimizer is not old_opt and not st.optimizer.state
    assert st.optimizer.defaults == old_opt.defaults
    assert st.step == 3
    assert torch.equal(st.hist_images, hist[0])
    assert torch.equal(st.hist_j2d, hist[1])
    assert torch.equal(st.rng.get_state(), rng_state)
    pipe.submit(F.torch_frame(F.make_frames(1, seed=5)[0]), {})
    assert pipe.state.step == 4


def _keypoints(rng, n, lo=(100, 60), hi=(220, 180)):
    kps = np.zeros((n, 25, 3), np.float32)
    kps[:, :, 0] = rng.uniform(lo[0], hi[0], size=(n, 25))
    kps[:, :, 1] = rng.uniform(lo[1], hi[1], size=(n, 25))
    kps[:, :, 2] = rng.uniform(0.1, 1.0, size=(n, 25))
    return kps


@pytest.mark.parametrize("fused", [False, True])
def test_keypoints_to_frame_equals_jax(fused):
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, size=(H, W, 3), dtype=np.uint8)
    kp = _keypoints(rng, 1)
    t_img, t_j2d, t_bbox = tstream.keypoints_to_frame(
        img[:, :, ::-1], kp, fused=fused, device=F.CPU)
    j_img, j_j2d, j_bbox = jstream.keypoints_to_frame(
        img[:, :, ::-1], kp, fused=fused)
    np.testing.assert_array_equal(t_j2d, j_j2d)
    np.testing.assert_array_equal(t_bbox, j_bbox)
    assert set(np.unique(t_j2d[:25, 2])) <= {0.0, 1.0} and not t_j2d[25:].any()
    if fused:
        assert isinstance(t_img, torch.Tensor) and t_img.shape == (224, 224, 3)
        # JAX's stream crops under jit, and XLA's fusion rounds the float32
        # sample coordinates otherwise than the same function run op by op
        # (the port's order).  The port holds 1e-5 against the op-by-op JAX
        # function, and is no further from the jitted crop than that
        # function is, plus 1e-5.
        _, center, scale, _ = jstream.keypoints_to_bbox(kp)
        j_eager = np.asarray(JI.fused_crop_resize_normalize(
            jnp.asarray(img[:, :, ::-1], jnp.float32),
            jnp.asarray(center, jnp.float32), jnp.asarray(scale, jnp.float32)))
        np.testing.assert_allclose(t_img.numpy(), j_eager, rtol=0, atol=1e-5)
        jit_gap = np.abs(j_eager - np.asarray(j_img)).max()
        assert np.abs(t_img.numpy() - np.asarray(j_img)).max() <= \
            jit_gap + 1e-5
    else:
        assert t_img.dtype == np.float32
        np.testing.assert_array_equal(t_img, j_img)


# -- the loop without its I/O ------------------------------------------------

class _Provider:
    def __init__(self, kps):
        self.kps = list(kps)

    def estimate(self, frame):
        kp = self.kps.pop(0)
        return None if kp is None else kp[None]


@pytest.fixture(scope="module")
def tiny_system():
    cfg = TAdaptConfig(**CFG_OPENPOSE, optim_steps=1)
    return build_system(cfg, Paths(), "cpu", compute_metrics=False,
                        model_kwargs=dict(layers=(1, 1, 1, 1), width=16,
                                          regressor_dim=128),
                        num_vertices=256)


def _frames_and_kps(n, none_at=1, seed=7):
    rng = np.random.default_rng(seed)
    frames = [rng.integers(0, 256, size=(H, W, 3), dtype=np.uint8)
              for _ in range(n)]
    kps = list(_keypoints(rng, n))
    kps[none_at] = None
    return frames, kps


@pytest.mark.parametrize("mode", ["host", "fused", "basemodel", "display"])
def test_run_on_in_memory_frames(tiny_system, mode):
    n = 6
    frames, kps = _frames_and_kps(n)
    out = []
    summary = tstream.run(
        tiny_system, iter(frames), _Provider(kps), out.append,
        fused=mode == "fused", test_basemodel=mode == "basemodel",
        synchronous=mode == "display")
    assert summary["frames"] == summary["records"] == len(out) == n
    assert summary["adapted"] == n - 1 and summary["passthrough"] == 1
    assert summary["param_devices"] == ["cpu"]
    assert summary["steady_frames"] == n - 3 and summary["steady_fps"] > 0
    assert set(summary["main_ms"]) == set(tstream.MAIN_PHASES)
    assert set(summary["emit_ms"]) == set(tstream.EMIT_PARTS)
    width = 2 * W if mode == "basemodel" else W
    for i, (f, o) in enumerate(zip(frames, out)):
        assert o.shape == (H, width, 3) and o.dtype == np.uint8
        halves = [o[:, :W], o[:, W:]] if mode == "basemodel" else [o]
        for half in halves:
            if i == 1:       # nobody detected: the frame passes through
                np.testing.assert_array_equal(half, f)
            else:
                assert (half != f).any(), i


def test_run_display_mode_reset_and_quit(tiny_system):
    frames, kps = _frames_and_kps(5, none_at=4)
    commands = iter([None, "reset", None, "quit"])
    out = []

    def sink(img):
        out.append(img)
        return next(commands)

    summary = tstream.run(tiny_system, iter(frames), _Provider(kps), sink,
                          synchronous=True)
    assert summary["resets"] == 1
    # depth 1: the sink's 4th call (frame 3's record) comes after frame 4
    assert len(out) == 4 and summary["frames"] == 5


def test_run_refuses_basemodel_with_fused(tiny_system):
    with pytest.raises(ValueError, match="test_basemodel"):
        tstream.run(tiny_system, [], _Provider([]), print, fused=True,
                    test_basemodel=True)


def test_run_reraises_a_sink_failure(tiny_system):
    frames, kps = _frames_and_kps(4)

    def sink(img):
        raise OSError("disk full")

    with pytest.raises(RuntimeError, match="worker failed") as e:
        tstream.run(tiny_system, iter(frames), _Provider(kps), sink)
    assert isinstance(e.value.__cause__, OSError)


# -- the CLI on the CPU ----------------------------------------------------

@pytest.fixture(scope="module")
def video(tmp_path_factory):
    d = tmp_path_factory.mktemp("video")
    n = 4
    rng = np.random.default_rng(5)
    w = cv2.VideoWriter(str(d / "in.mp4"), cv2.VideoWriter_fourcc(*"mp4v"),
                        10, (W, H))
    for _ in range(n):
        w.write(rng.integers(0, 255, size=(H, W, 3), dtype=np.uint8))
    w.release()
    kps = _keypoints(rng, n)
    kps[1] = 0.0          # frame 1: no person -> pass-through
    np.savez(d / "kps.npz", keypoints=kps)
    return d, n


@pytest.mark.parametrize("flags,width", [((), W),
                                         (("--fused_preprocess", "1"), W),
                                         (("--test_basemodel", "1"), 2 * W)])
def test_cli_on_a_video(video, tmp_path, flags, width):
    d, n = video
    out = str(tmp_path / "out.mp4")
    frames = tstream.main([
        "--device", "cpu", "--expdir", str(tmp_path), "--capture_mode",
        "video", "--video_file", str(d / "in.mp4"), "--kp_file",
        str(d / "kps.npz"), "--out_video", out, "--interval", "2", *flags,
        *LEAN])
    assert frames == n
    cap = cv2.VideoCapture(out)
    assert int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)) == width
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == n
    cap.release()
    assert (tmp_path / "stream" / "setting.txt").exists()


def test_cli_defaults():
    args = tstream.build_parser().parse_args([])
    assert args.device == "cuda" and args.expname == "stream"
    assert not (args.retrieval or args.lower_level_mixtrain or
                args.upper_level_mixtrain or args.record_lowerlevel)
    assert args.kp_source == "precomputed" and args.capture_mode == "webcam"


# -- the runner's --save_res overlay -----------------------------------------

def test_render_overlay_files_identical_to_jax(tmp_path):
    img_root = tmp_path / "imgs"
    img_root.mkdir()
    rng = np.random.default_rng(11)
    assert cv2.imwrite(str(img_root / "a.png"),
                       rng.integers(0, 256, size=(60, 80, 3), dtype=np.uint8))
    faces = synthetic_smpl_model(10, F.CPU, num_vertices=256).faces
    out = {"verts": (rng.normal(size=(1, 256, 3)) * 0.3).astype(np.float32),
           "cam": np.array([[0.9, 0.05, -0.1]], np.float32)}
    meta = {"imgname": "a.png", "bbox": np.array([40.0, 30.0, 50.0],
                                                 np.float32)}
    written = {}
    for name, cls in (("t", TRunner), ("j", JRunner)):
        runner = cls(None, str(tmp_path / name), save_overlays=True,
                     img_root=str(img_root), faces=faces)
        runner._render_overlay(3, out, meta)
        runner._render_overlay(4, out, dict(meta, imgname="missing.png"))
        runner.writer.close()
        written[name] = [(tmp_path / name / d / f"Pred_3.{ext}").read_bytes()
                         for d, ext in (("image", "png"), ("mesh", "obj"))]
        assert not (tmp_path / name / "image" / "Pred_4.png").exists()
    assert written["t"] == written["j"]
    over = cv2.imread(str(tmp_path / "t" / "image" / "Pred_3.png"))
    assert (over != cv2.imread(str(img_root / "a.png"))).any()
    assert os.path.getsize(tmp_path / "t" / "mesh" / "Pred_3.obj") > 0
