"""The port's real-data loaders against the JAX package's on tiny on-disk
fixtures written here with cv2: 3DPW archives, an internet-video archive and
an H36M exemplar bank with its retrieval clusters.  Items, banks and stores
must be equal key by key.  The 3DPW fixture also carries a --save_res run
that writes every frame's overlay."""

import os

import cv2
import joblib
import numpy as np
import pytest
import torch

from dynaboa_tpu.data import streams as jstreams
from dynaboa_tpu.data import SyntheticStream as JSynthetic
from dynaboa_tpu.engine import retrieval as jret
from dynaboa_tpu_torch.data import streams as tstreams
from dynaboa_tpu_torch.engine import retrieval as tret
from tests import torch_port_fixtures  # noqa: F401  (shares the cores)

H, W = 48, 64
PAD = (64, 80)


def _png(path, seed):
    img = np.random.default_rng(seed).integers(0, 256, (H, W, 3), np.uint8)
    assert cv2.imwrite(str(path), img)


def _boxes(rng, n):
    center = rng.uniform([20, 15], [44, 33], size=(n, 2)).astype(np.float32)
    scale = rng.uniform(0.15, 0.3, size=n).astype(np.float32)
    return center, scale


def _kp(rng, n, k):
    return np.concatenate([rng.uniform(0, 60, size=(n, k, 2)),
                           rng.uniform(0, 1, size=(n, k, 1))],
                          -1).astype(np.float32)


@pytest.fixture(scope="module")
def pw3d(tmp_path_factory):
    root = tmp_path_factory.mktemp("pw3d")
    (root / "imgs").mkdir()
    rng = np.random.default_rng(0)
    for s, (seq, person, n) in enumerate([(12, 0, 3), (3, 1, 2)]):
        names = [f"s{seq}_{i}.png" for i in range(n)]
        for i, name in enumerate(names):
            _png(root / "imgs" / name, 10 * s + i)
        center, scale = _boxes(rng, n)
        fields = dict(imgname=np.array(names), center=center, scale=scale,
                      pose=rng.normal(size=(n, 72)).astype(np.float32),
                      shape=rng.normal(size=(n, 10)).astype(np.float32),
                      j2d=_kp(rng, n, 49), op_j2d=_kp(rng, n, 49))
        if s == 0:        # the second archive has no gender: -1
            fields["gender"] = np.array(["m", "f", "m"][:n])
        np.savez(root / f"3dpw_{seq}_{person}.npz", **fields)
    return root


@pytest.fixture(scope="module")
def internet(tmp_path_factory):
    root = tmp_path_factory.mktemp("internet")
    (root / "images").mkdir()
    rng = np.random.default_rng(1)
    names = [f"f{i}.png" for i in range(3)]
    for i, name in enumerate(names):
        _png(root / "images" / name, 100 + i)
    center, scale = _boxes(rng, 3)
    np.savez(root / "clip.npz", imgname=np.array(names), center=center,
             scale=scale, part=_kp(rng, 3, 49))
    return root


def _assert_items_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert type(a[k]) is type(b[k]) and a[k] == b[k], k


@pytest.mark.parametrize("fused", [False, True])
def test_pw3d_items_equal_the_jax_items(pw3d, tmp_path, fused):
    args = (str(pw3d), str(pw3d / "imgs"))
    js = jstreams.PW3DStream(*args, fused_preprocess=fused, pad_shape=PAD)
    ts = tstreams.PW3DStream(*args, fused_preprocess=fused, pad_shape=PAD)
    assert len(ts) == len(js) == 5
    assert ts.seq_paths == js.seq_paths       # 3dpw_3_1 before 3dpw_12_0
    assert ts.seq_paths[0].endswith("3dpw_3_1.npz")
    assert ts.gender.tolist() == js.gender.tolist() == [-1, -1, 0, 1, 0]
    for a, b in zip(js, ts):
        _assert_items_equal(a, b)
    js.record_order(str(tmp_path / "j.record"))
    ts.record_order(str(tmp_path / "t.record"))
    assert (tmp_path / "j.record").read_text() == \
        (tmp_path / "t.record").read_text()


@pytest.mark.parametrize("fused", [False, True])
def test_internet_items_equal_the_jax_items(internet, fused):
    js = jstreams.InternetStream(str(internet), fused_preprocess=fused,
                                 pad_shape=PAD)
    ts = tstreams.InternetStream(str(internet), fused_preprocess=fused,
                                 pad_shape=PAD, prefetch=0)
    assert len(ts) == len(js) == 3
    for i in range(3):
        _assert_items_equal(js[i], ts[i])
    assert ts[0]["gender"] == -1 and not ts[0]["pose"].any()


def test_missing_archives_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        tstreams.PW3DStream(str(tmp_path), str(tmp_path))
    with pytest.raises(FileNotFoundError):
        tstreams.InternetStream(str(tmp_path))


def test_fused_synthetic_stream_items_identical():
    js = JSynthetic(3, img_res=32, seed=5, fused_preprocess=True)
    ts = tstreams.SyntheticStream(3, 32, seed=5, fused_preprocess=True)
    for i in range(3):
        _assert_items_equal(js[i], ts[i])
    assert ts[0]["raw_image"].dtype == np.uint8
    assert ts[0]["raw_image"].shape == (64, 64, 3)


def test_pad_raw_frame_refuses_a_larger_frame():
    with pytest.raises(ValueError, match="exceeds pad_shape"):
        tstreams.pad_raw_frame(np.zeros((10, 10, 3), np.uint8), (8, 16))


def test_reference_store_equals_the_jax_store(tmp_path):
    """The H36M exemplar bank (joblib + images) and its K-means clusters."""
    img_root = tmp_path / "h36m"
    img_root.mkdir()
    rng = np.random.default_rng(2)
    M = 4
    names = [f"e{i}.png" for i in range(M)]
    for i, name in enumerate(names):
        _png(img_root / name, 200 + i)
    center, scale = _boxes(rng, M)
    source = tmp_path / "h36m_random_sample_center_10_10.pt"
    joblib.dump(dict(imgname=names, center=center, scale=scale,
                     pose=rng.normal(size=(M, 72)),
                     shape=rng.normal(size=(M, 10)),
                     S=rng.normal(size=(M, 24, 4)),
                     part=_kp(rng, M, 24)), source)
    retrieval_dir = tmp_path / "retrieval_res"
    retrieval_dir.mkdir()
    joblib.dump(dict(centers=rng.normal(size=(2, 8)),
                     index={0: np.array([0, 2, 3]), 1: np.array([1])}),
                retrieval_dir /
                "cluster_res_random_sample_center_10_10_potocol2.pt")

    js = jret.load_reference_store(str(retrieval_dir), str(source),
                                   str(img_root))
    ts = tret.load_reference_store(str(retrieval_dir), str(source),
                                   str(img_root), torch.device("cpu"))
    for a, b in zip(ts.bank, js.bank):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ts.bank.images.shape == (M, 224, 224, 3)
    for a, b in ((ts.centers, js.centers), (ts.members, js.members),
                 (ts.member_mask, js.member_mask)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("window", [1, 2])
def test_save_res_writes_every_frames_overlay(pw3d, tmp_path, window):
    """--save_res 1 through the benchmark CLI's runner on the 3DPW archives:
    each frame's prediction, overlay and mesh, per window row too (the last
    window of 2 is a padded single frame)."""
    from dynaboa_tpu_torch.apps import benchmark
    from dynaboa_tpu_torch.apps.common import build_system

    args = benchmark.build_parser().parse_args([
        "--device", "cpu", "--tiny", "1", "--save_res", "1",
        "--optim_steps", "1", "--window_size", str(window)])
    system = build_system(benchmark.cfg_from_args(args), None, "cpu",
                          **benchmark.tiny_kwargs(args))
    stream = tstreams.PW3DStream(str(pw3d), str(pw3d / "imgs"), prefetch=0)
    run = tmp_path / "run"
    summary = benchmark.run_stream(system, stream, args, str(run),
                                   save_predictions=True,
                                   img_root=str(pw3d / "imgs"))
    assert summary["frames"] == 5
    for d, ext in (("result", "npz"), ("image", "png"), ("mesh", "obj")):
        assert sorted(os.listdir(run / d)) == [f"Pred_{i}.{ext}"
                                               for i in range(5)], d
    for i in range(5):
        over = cv2.imread(str(run / "image" / f"Pred_{i}.png"))
        assert over.shape == (H, W, 3)
        assert (run / "mesh" / f"Pred_{i}.obj").read_text().startswith("v ")
