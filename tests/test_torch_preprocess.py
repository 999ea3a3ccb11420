"""Offline data preparation of the port against the JAX package's: the
3DPW extraction, the CDF reader and writer, the H36M and video frame
extractors, and the process_data dispatcher."""

import argparse
import os
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

import chip_smoke
from dynaboa_tpu.apps import process_data as jpd
from dynaboa_tpu.data.preprocess import cdf as jcdf
from dynaboa_tpu.data.preprocess import human36m as jh36m
from dynaboa_tpu.data.preprocess import pw3d as jpw3d
from dynaboa_tpu.data.preprocess import video as jvideo
from dynaboa_tpu.models import smpl as jsmpl
from dynaboa_tpu_torch.apps import process_data as tpd
from dynaboa_tpu_torch.data import preprocess as tpre
from dynaboa_tpu_torch.data.preprocess import cdf as tcdf
from dynaboa_tpu_torch.data.preprocess import human36m as th36m
from dynaboa_tpu_torch.data.preprocess import pw3d as tpw3d
from dynaboa_tpu_torch.data.preprocess import video as tvideo
from dynaboa_tpu_torch.models import smpl as tsmpl
from tests import torch_port_fixtures as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PW3D_KEYS = ("imgname", "gender", "scale", "center", "pose", "shape", "j3d",
             "j2d", "op_j2d")
# The same float32 decode in another summation order; measured worst gaps
# against JAX (V = 256 / V = 6890): j3d 2.4e-7 / 3.6e-7 m, pose 2.4e-7 /
# 6.0e-8 rad, j2d 4.6e-5 / 7.8e-5 px (1000 px focal length at 5 m), center
# 1.2e-4 px, scale 2.4e-7 / 4.8e-7; shape and op_j2d bit-equal
PW3D_ATOL = {"scale": 1e-5, "center": 1e-3, "pose": 1e-5, "shape": 0.0,
             "j3d": 1e-5, "j2d": 1e-3, "op_j2d": 0.0}


def _pw3d_tree(root, frames_per_sequence, seed=0):
    """The 24 pickles, 13 with a second person, about one frame in ten
    invalid (chip_smoke.py's builder at a tiny size)."""
    _, people = chip_smoke.pw3d_layout(24, seed=seed)
    valid = chip_smoke.write_pw3d_tree(str(root), [frames_per_sequence] * 24,
                                       people, seed=seed)
    assert len(valid) == 37
    assert 37 <= sum(valid.values()) < 37 * frames_per_sequence
    return valid


@pytest.fixture
def jax_pw3d(monkeypatch):
    """The JAX package's pw3d module with its SMPL decode and rotations
    jitted: eagerly, one JAX op at a time, the extraction takes minutes
    here.  Jitting changes no operation."""
    from dynaboa_tpu.ops import rotations as jrot

    forwards = {}

    def smpl_forward(model, betas, pose, pose2rot=False):
        if id(model) not in forwards:
            forwards[id(model)] = jax.jit(lambda b, p: jsmpl.smpl_forward(
                model, b, p, pose2rot=pose2rot))
        return forwards[id(model)](betas, pose)

    monkeypatch.setattr(jpw3d, "smpl_forward", smpl_forward)
    monkeypatch.setattr(jpw3d, "batch_rodrigues",
                        jax.jit(jrot.batch_rodrigues))
    monkeypatch.setattr(jpw3d, "rotmat_to_aa", jax.jit(jrot.rotmat_to_aa))
    return jpw3d


def assert_pw3d_archives_match(tdir, jdir, tracks):
    for s, p in tracks:
        name = f"3dpw_{s}_{p}.npz"
        t, j = np.load(os.path.join(tdir, name)), np.load(
            os.path.join(jdir, name))
        assert sorted(t.files) == sorted(j.files) == sorted(PW3D_KEYS)
        for k in PW3D_KEYS:
            assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, \
                (name, k)
            if k in ("imgname", "gender"):
                np.testing.assert_array_equal(t[k], j[k], err_msg=name)
            else:
                np.testing.assert_allclose(t[k], j[k], rtol=0,
                                           atol=PW3D_ATOL[k],
                                           err_msg=f"{name} {k}")


def test_pw3d_extract_matches_jax(tmp_path, jax_pw3d):
    """24 pickles in 3DPW's layout, 1-2 people, 3 frames each with invalid
    camera frames mixed in, gendered synthetic SMPL at V = 256."""
    valid = _pw3d_tree(tmp_path / "3dpw", 3)
    jax_pw3d.pw3d_extract(str(tmp_path / "3dpw"), str(tmp_path / "j"),
                       jsmpl.synthetic_smpl_model(seed=11, num_vertices=F.NV),
                       jsmpl.synthetic_smpl_model(seed=12, num_vertices=F.NV))
    tpw3d.pw3d_extract(str(tmp_path / "3dpw"), str(tmp_path / "t"),
                       tsmpl.synthetic_smpl_model(11, F.CPU,
                                                  num_vertices=F.NV),
                       tsmpl.synthetic_smpl_model(12, F.CPU,
                                                  num_vertices=F.NV))
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j"))
    for (s, p), n in valid.items():
        d = np.load(tmp_path / "t" / f"3dpw_{s}_{p}.npz")
        assert d["pose"].shape == (n, 72) and d["j3d"].shape == (n, 49, 3)
    assert_pw3d_archives_match(tmp_path / "t", tmp_path / "j", valid)


def test_pw3d_tables_equal_jax():
    assert tpw3d.SEQUENCE_ORDER == jpw3d.SEQUENCE_ORDER
    assert tpw3d.OPENPOSE18_TO_SPIN49 == jpw3d.OPENPOSE18_TO_SPIN49


@pytest.mark.parametrize("writer,reader", [(jcdf, tcdf), (tcdf, jcdf)])
def test_cdf_round_trip_across_packages(tmp_path, writer, reader):
    """A file written by one package reads back bit-equal through the
    other, and both packages write the same bytes."""
    data = np.random.default_rng(0).normal(size=(1, 37, 96))
    path = str(tmp_path / "pose.cdf")
    writer.write_cdf(path, "Pose", data)
    out = reader.read_cdf(path)
    assert list(out) == ["Pose"]
    assert out["Pose"].astype(np.float64).tobytes() == data.tobytes()
    reader.write_cdf(str(tmp_path / "again.cdf"), "Pose", data)
    with open(path, "rb") as f, open(tmp_path / "again.cdf", "rb") as g:
        assert f.read() == g.read()


@pytest.fixture
def cv2():
    return pytest.importorskip("cv2")


def _write_video(cv2, path, n_frames, size=(32, 24)):
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10, size)
    assert w.isOpened()
    rng = np.random.default_rng(n_frames)
    for _ in range(n_frames):
        w.write(rng.integers(0, 256, size=(size[1], size[0], 3), dtype=np.uint8))
    w.release()


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        with open(os.path.join(a, n), "rb") as f, \
                open(os.path.join(b, n), "rb") as g:
            assert f.read() == g.read(), n
    return names


def test_h36m_train_extract_matches_jax(tmp_path, cv2):
    """A cv2-written video and its pose CDF (7 frames of 12: the CDF's
    count wins), beside a skipped camera and a skipped _ALL action."""
    root = tmp_path / "h36m"
    pose_dir = root / "S9" / "MyPoseFeatures" / "D3_Positions_mono"
    pose_dir.mkdir(parents=True)
    (root / "S9" / "Videos").mkdir()
    _write_video(cv2, root / "S9" / "Videos" / "Walking.60457274.mp4", 12)
    jcdf.write_cdf(str(pose_dir / "Walking.60457274.cdf"), "Pose",
                   np.zeros((1, 7, 96)))
    for skipped in ("Jumping.55011271", "_ALL.60457274"):
        jcdf.write_cdf(str(pose_dir / f"{skipped}.cdf"), "Pose",
                       np.zeros((1, 12, 96)))
    jh36m.h36m_train_extract(str(root), training_split=False)
    os.rename(root / "images", tmp_path / "jax_images")
    tpre.h36m_train_extract(str(root), training_split=False)
    names = _same_files(root / "images", tmp_path / "jax_images")
    assert names == ["S9_Walking.60457274_000001.jpg",
                     "S9_Walking.60457274_000006.jpg"]
    assert th36m.read_pose_cdf(str(pose_dir / "Walking.60457274.cdf")).shape \
        == (7, 96)


def test_video_to_images_matches_jax(tmp_path, cv2):
    vid = tmp_path / "clip.mp4"
    _write_video(cv2, vid, 5)
    jvideo.video_to_images(str(vid), str(tmp_path / "j"))
    out = tvideo.video_to_images(str(vid), str(tmp_path / "t"))
    assert out == str(tmp_path / "t")
    assert _same_files(tmp_path / "t", tmp_path / "j") == [
        f"{i:06d}.png" for i in range(1, 6)]


def test_extract_all_writes_per_video_folders(tmp_path, cv2):
    for name in ("a", "b"):
        _write_video(cv2, tmp_path / f"{name}.mp4", 3)
    tpre.extract_all(str(tmp_path))
    assert sorted(os.listdir(tmp_path / "images")) == ["a", "b"]
    assert len(os.listdir(tmp_path / "images" / "b")) == 3


# -- the dispatcher ------------------------------------------------------------

class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))


class _Paths:
    h36m_root, internet_root = "/h36m", "/internet"
    pw3d_root, smpl_model_dir = "/pw3d", "/smpl"
    dataset_npz_path = "out/extras"


@pytest.mark.parametrize("dataset,name,args,kwargs", [
    ("h36m", "h36m_train_extract", ("/h36m",),
     {"training_split": False, "extract_img": False}),
    ("internet", "internet_data_extract", ("/internet",), {}),
    ("video", "extract_all", ("/internet",), {})])
def test_process_data_dispatches(monkeypatch, dataset, name, args, kwargs):
    rec = _Recorder()
    monkeypatch.setattr(tpre, name, rec)
    monkeypatch.setattr(tpd, "Paths", _Paths)
    tpd.main(["--dataset", dataset])
    assert rec.calls == [(args, kwargs)]


def test_process_data_dispatches_3dpw(monkeypatch):
    extract, load = _Recorder(), _Recorder()
    monkeypatch.setattr(tpw3d, "pw3d_extract", extract)
    monkeypatch.setattr(tsmpl, "load_smpl_npz", lambda p, d: load(p, d) or p)
    monkeypatch.setattr(tpd, "Paths", _Paths)
    tpd.main(["--dataset", "3dpw", "--device", "cpu"])
    assert load.calls == [(("/smpl/smpl_male.npz", torch.device("cpu")), {}),
                          (("/smpl/smpl_female.npz", torch.device("cpu")), {})]
    assert extract.calls == [(("/pw3d", "out/extras", "/smpl/smpl_male.npz",
                               "/smpl/smpl_female.npz"), {})]


def test_process_data_3dpw_needs_the_card_it_names(monkeypatch):
    """--device defaults to cuda and raises without a CUDA device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tpd, "Paths", _Paths)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpd.main(["--dataset", "3dpw"])


def test_process_data_3dhp_not_implemented(capsys):
    tpd.main(["--dataset", "3dhp"])
    assert capsys.readouterr().out == "Not implemented.\n"


@pytest.mark.parametrize("argv", [[], ["--dataset", "lsp"]])
def test_process_data_rejects_bad_flags(argv):
    with pytest.raises(SystemExit):
        tpd.main(argv)


def test_process_data_3dpw_end_to_end_matches_jax(tmp_path, jax_pw3d):
    """The CLI in a process of its own, its roots from PW3D_ROOT and
    SMPL_MODEL_DIR, its archives under the working directory, against the
    JAX package's pw3d_extract on the same V = 6890 SMPL npz files (the
    npz loader takes the full model's vertex ids)."""
    smpl_dir = tmp_path / "smpl"
    smpl_dir.mkdir()
    for seed, g in ((11, "male"), (12, "female")):
        chip_smoke.write_smpl_npz(str(smpl_dir / f"smpl_{g}.npz"), seed, 6890)
    valid = _pw3d_tree(tmp_path / "3dpw", 2, seed=1)
    work = tmp_path / "work"
    work.mkdir()
    env = dict(os.environ, PW3D_ROOT=str(tmp_path / "3dpw"),
               SMPL_MODEL_DIR=str(smpl_dir))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    proc = subprocess.run(
        [sys.executable, "-m", "dynaboa_tpu_torch.apps.process_data",
         "--dataset", "3dpw", "--device", "cpu"],
        cwd=work, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("wrote 3dpw_") == 37
    jax_pw3d.pw3d_extract(
        str(tmp_path / "3dpw"), str(tmp_path / "j"),
        jsmpl.load_smpl_npz(str(smpl_dir / "smpl_male.npz")),
        jsmpl.load_smpl_npz(str(smpl_dir / "smpl_female.npz")))
    assert_pw3d_archives_match(work / "data" / "dataset_extras",
                               tmp_path / "j", valid)


def test_dispatcher_choices_equal_jax(monkeypatch):
    seen = []

    def grab(self, args=None, namespace=None):
        seen.append(next(a.choices for a in self._actions
                         if a.dest == "dataset"))
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    for mod in (tpd, jpd):
        with pytest.raises(SystemExit):
            mod.main([])
    assert seen[0] == seen[1]
