"""The port's native host library (``native_lib``, built from its own copy
of the C++ sources), renderer and capture classes against the JAX
package's on the same numpy inputs: library outputs and renders must be
bit-equal, the camera conversions agree to 1e-6, OBJ text is identical."""

import sys
import time
import types

import cv2
import numpy as np
import pytest

from dynaboa_tpu import native_lib as jnative
from dynaboa_tpu.viz import capture as jcapture
from dynaboa_tpu.viz import renderer as jrend
from dynaboa_tpu_torch import native_lib as tnative
from dynaboa_tpu_torch.viz import capture as tcapture
from dynaboa_tpu_torch.viz import renderer as trend
from tests import torch_port_fixtures  # noqa: F401  (shares the cores)


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's library (built with make at first use)."""
    assert jnative.available(), "the JAX package's native library did not build"
    return jnative


def _mesh(seed: int, nv: int = 300, nf: int = 400, spread: float = 0.4):
    rng = np.random.default_rng(seed)
    verts = (rng.normal(size=(nv, 3)) * spread).astype(np.float32)
    faces = rng.integers(0, nv, size=(nf, 3)).astype(np.int32)
    return verts, faces


CAMS = [np.array([0.9, 1.2, 0.05, -0.1], np.float32),
        np.array([0.5, 0.5, 0.3, 0.2], np.float32)]


@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("cam_i", [0, 1])
@pytest.mark.parametrize("size", [(64, 48), (97, 131)])
def test_render_mesh_bit_equal(jax_native, cull, cam_i, size):
    verts, faces = _mesh(cam_i + 7 * size[0])
    w, h = size
    t = tnative.render_mesh(verts, faces, CAMS[cam_i], w, h, (0.8, 0.5, 0.4),
                            cull=cull)
    j = jax_native.render_mesh(verts, faces, CAMS[cam_i], w, h,
                               (0.8, 0.5, 0.4), cull=cull)
    assert t.dtype == np.uint8 and t.shape == (h, w, 4)
    assert (t[..., 3] > 0).any()          # something was drawn
    np.testing.assert_array_equal(t, j)


def test_composite_over_bit_equal(jax_native):
    rng = np.random.default_rng(1)
    rgba = rng.integers(0, 256, size=(40, 56, 4), dtype=np.uint8)
    rgba[..., 3] *= rng.integers(0, 2, size=(40, 56), dtype=np.uint8)
    img = rng.integers(0, 256, size=(40, 56, 3), dtype=np.uint8)
    t = tnative.composite_over(rgba, img.copy())
    j = jax_native.composite_over(rgba, img.copy())
    np.testing.assert_array_equal(t, j)
    assert (t != img).any() and (t == img).any()


@pytest.mark.parametrize("supersample", [1, 2])
@pytest.mark.parametrize("center,scale", [([320.0, 240.0], 1.1),
                                          ([20.0, 30.0], 0.9)])
def test_crop_resize_normalize_bit_equal(jax_native, supersample, center,
                                         scale):
    img = np.random.default_rng(2).uniform(
        0, 255, size=(480, 640, 3)).astype(np.float32)
    t = tnative.crop_resize_normalize(img, center, scale, out_res=64,
                                      supersample=supersample)
    j = jax_native.crop_resize_normalize(img, center, scale, out_res=64,
                                         supersample=supersample)
    assert t.dtype == np.float32 and t.shape == (64, 64, 3)
    np.testing.assert_array_equal(t, j)


def test_frame_ring_equals_jax(jax_native):
    shape = (6, 8, 3)
    t, j = tnative.FrameRing(3, shape), jax_native.FrameRing(3, shape)
    try:
        assert t.read_latest() == j.read_latest() == (0, None)
        for i in range(7):
            f = np.full(shape, i * 9, np.uint8)
            assert t.push(f) == j.push(f) == i + 1
            (tt, tf), (jt, jf) = t.read_latest(), j.read_latest()
            assert tt == jt == t.latest_tick() == i + 1
            np.testing.assert_array_equal(tf, jf)
            np.testing.assert_array_equal(tf, f)
        with pytest.raises(ValueError, match="pushed into a ring"):
            t.push(np.zeros((2, 2, 3), np.uint8))
    finally:
        t.close()
    t.close()                              # a second close is a no-op


def test_render_numpy_bit_equal():
    verts, faces = _mesh(3, nv=60, nf=80)
    for cam in CAMS:
        t = trend._render_numpy(verts, faces, cam, 48, 40, (1.0, 1.0, 0.9))
        j = jrend._render_numpy(verts, faces, cam, 48, 40, (1.0, 1.0, 0.9))
        assert (t[..., 3] > 0).any()
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("backend", ["native", "numpy"])
@pytest.mark.parametrize("own_faces", [True, False])
def test_renderer_bit_equal(jax_native, backend, own_faces):
    verts, faces = _mesh(4, nv=80, nf=120)
    img = np.random.default_rng(5).integers(0, 256, size=(40, 52, 3),
                                            dtype=np.uint8)
    extra = {} if own_faces else {"faces": faces[:60]}
    t = trend.Renderer(faces=faces, backend=backend).render(
        img, verts, CAMS[0], color=(0.2, 0.9, 0.4), **extra)
    jr = jrend.Renderer(faces=faces)
    jr.use_native = backend == "native"    # the JAX class picks by itself
    j = jr.render(img, verts, CAMS[0], color=(0.2, 0.9, 0.4), **extra)
    assert t.dtype == np.uint8 and (t != img).any()
    np.testing.assert_array_equal(t, j)


def test_render_overlay_bit_equal(jax_native):
    verts, faces = _mesh(6)
    img = np.random.default_rng(6).integers(0, 256, size=(60, 80, 3),
                                            dtype=np.uint8)
    args = (img, verts, np.array([0.9, 0.1, -0.05]),
            np.array([40.0, 30.0, 50.0]), faces)
    np.testing.assert_array_equal(trend.render_overlay(*args),
                                  jrend.render_overlay(*args))


def test_renderer_refuses_an_unknown_backend():
    with pytest.raises(ValueError, match="backend"):
        trend.Renderer(backend="gl")


def test_camera_conversions_agree():
    rng = np.random.default_rng(7)
    cam = np.concatenate([rng.uniform(0.5, 1.5, (5, 1)),
                          rng.normal(size=(5, 2)) * 0.2], 1)
    bbox = np.concatenate([rng.uniform(50, 600, (5, 2)),
                           rng.uniform(100, 400, (5, 1))], 1)
    np.testing.assert_allclose(
        trend.convert_crop_cam_to_orig_img(cam, bbox, 640, 480),
        jrend.convert_crop_cam_to_orig_img(cam, bbox, 640, 480),
        rtol=1e-6, atol=1e-6)
    cam_t = np.concatenate([rng.normal(size=(5, 2)),
                            rng.uniform(20, 60, (5, 1))], 1)
    np.testing.assert_allclose(trend.parse_cam(cam_t), jrend.parse_cam(cam_t),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(trend.revert_to_bbox([3.0, 4.0], 1.3, 200, 1.2),
                               jrend.revert_to_bbox([3.0, 4.0], 1.3, 200, 1.2),
                               rtol=1e-6, atol=1e-6)


def test_save_obj_identical_text(tmp_path):
    verts, faces = _mesh(8, nv=20, nf=30)
    trend.save_obj(str(tmp_path / "t.obj"), verts, faces)
    jrend.save_obj(str(tmp_path / "j.obj"), verts, faces)
    text = (tmp_path / "t.obj").read_text()
    assert text == (tmp_path / "j.obj").read_text()
    assert text.count("\nf ") + text.startswith("f ") == 30


class _FakeOpenPose(types.SimpleNamespace):
    """The part of ``openpose.pyopenpose`` the provider uses; the pose of
    each frame comes from ``poses`` in call order."""

    def __init__(self, poses):
        calls = []

        class Datum:
            cvInputData = None
            poseKeypoints = None

        class WrapperPython:
            def configure(self, params):
                calls.append(("configure", params))

            def start(self):
                calls.append(("start",))

            def emplaceAndPop(self, data):
                (d,) = data
                calls.append(("frame", d.cvInputData.shape))
                d.poseKeypoints = poses.pop(0)

        super().__init__(Datum=Datum, WrapperPython=WrapperPython,
                         VectorDatum=list, calls=calls)


def _poses():
    rng = np.random.default_rng(9)
    return [rng.uniform(0, 100, size=(2, 25, 3)).astype(np.float32), None,
            np.zeros((0, 25, 3), np.float32),
            rng.uniform(0, 100, size=(1, 25, 3))]


def test_openpose_provider_with_a_fake_module(monkeypatch):
    results = {}
    for name, mod in (("t", tcapture), ("j", jcapture)):
        fake = _FakeOpenPose(_poses())
        pkg = types.ModuleType("openpose")
        pkg.pyopenpose = fake
        monkeypatch.setitem(sys.modules, "openpose", pkg)
        monkeypatch.setitem(sys.modules, "openpose.pyopenpose", fake)
        prov = mod.OpenPoseProvider("/models", net_resolution="-1x256")
        frame = np.zeros((24, 32, 3), np.uint8)
        results[name] = [prov.estimate(frame) for _ in range(4)]
        assert fake.calls[:2] == [("configure", {"model_folder": "/models",
                                                 "net_resolution": "-1x256"}),
                                  ("start",)]
    t, j = results["t"], results["j"]
    assert t[1] is None and t[2] is None and j[1] is None and j[2] is None
    for a, b in ((t[0], j[0]), (t[3], j[3])):
        assert a.shape == (1, 25, 3) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_precomputed_keypoints_equal_jax(tmp_path):
    kps = np.random.default_rng(10).uniform(0, 50, size=(4, 25, 3)).astype(
        np.float32)
    kps[1, :, 2] = 0.0                  # nobody
    kps[2, 2:, 2] = 0.0                 # two confident joints: nobody
    np.savez(tmp_path / "k.npz", keypoints=kps)
    t = tcapture.PrecomputedKeypoints(str(tmp_path / "k.npz"))
    j = jcapture.PrecomputedKeypoints(str(tmp_path / "k.npz"))
    for i in range(6):
        a, b = t.estimate(None), j.estimate(None)
        if b is None:
            assert a is None, i
        else:
            np.testing.assert_array_equal(a, b)
    assert [t.estimate(None) for _ in range(2)] == [None, None]


def test_frame_source_reads_a_video(tmp_path):
    path = str(tmp_path / "v.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (32, 24))
    for i in range(5):
        w.write(np.full((24, 32, 3), 40 * i, np.uint8))
    w.release()
    src = tcapture.FrameSource(path)
    try:
        ticks = []
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            tick, frame = src.read()
            assert frame.shape == (24, 32, 3)
            ticks.append(tick)
            if src.ended and tick == src._ring.latest_tick():
                break
            time.sleep(0.001)
        assert src.ended and ticks == sorted(ticks) and ticks[-1] == 5
    finally:
        src.stop()
    with pytest.raises(RuntimeError, match="cannot open"):
        tcapture.FrameSource(str(tmp_path / "missing.mp4"))
